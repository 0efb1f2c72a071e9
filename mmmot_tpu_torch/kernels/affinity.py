"""Fused affinity: CUDA kernel wrapper and its plain PyTorch version.

Port of ``mmmot_tpu/kernels/affinity_kernel.py`` (``pallas_affinity``,
``build_affinity_params``, ``pallas_supported``).  For B frame pairs and
the K score branches present (``fused`` first, then ``image`` / ``lidar``
where they score: K=3 for the flagship, 2 with a dead sensor, 1 for
``fused-only``, the one-modality nets and ``keep_single=False``), from
the per-branch embeddings it computes the raw link scores over the
correlation ``ops`` (W1 [K, len(ops) * D, H]), the ``link_norm`` of the
``softmax_mode`` and the v2 new/end logits over the link's ``pool``.
With ``avg`` (``score_fusion="avg"``) the branch sum is divided by K.
An optional ``link_bias`` [B, N, N] float32 (the learned motion term) is
added to the branch sum before the mask, the softmax and the pools.

``fused_affinity`` launches ``csrc/affinity.cu`` for CUDA tensors and
runs ``affinity_plain`` for CPU tensors; there is no other fallback.
``affinity_plain`` repeats the kernel's arithmetic, rounding points
included, with PyTorch ops that materialise the [B, K, N, N, len(ops) D]
pair tensor.  ``kernel_supported`` says which model configs the kernel
covers (the reference's ``pallas_supported``); the tracker runs the
module path for the others.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from mmmot_tpu_torch.kernels import check_tensor
from mmmot_tpu_torch.kernels.build import build
from mmmot_tpu_torch.models.affinity import (CORRELATION_OPS,
                                             correlation_tensor,
                                             normalize_link)
from mmmot_tpu_torch.models.layers import BN_EPS
from mmmot_tpu_torch.models.new_end import pool_link
from mmmot_tpu_torch.models.tracking_net import AffinityOutput
from mmmot_tpu_torch.ops.masking import pair_mask

MAX_N = 128     # csrc/affinity.cu kMaxN; _library checks that they agree
MAX_K = 3       # score branches: fused, image, lidar
# csrc/affinity.cu's enums Op, Pool and Mode.
OP_CODES = {"subabs": 0, "mul": 1, "diff": 2, "cosine": 3}
POOL_CODES = {"max": 0, "mean": 1, "softmax": 2}
MODE_CODES = {"dual": 0, "single": 1, "none": 2}

# (name, compute-dtype?) for every parameter.
PARAM_SPEC = (("w1", True), ("b1", True), ("bn_mean", False),
              ("bn_inv", False), ("bn_scale", False), ("bn_bias", False),
              ("w2", True), ("b2", False),
              ("wn1", True), ("wnp", False), ("bn1", False), ("wn2", True),
              ("bn2", False),
              ("we1", True), ("wep", False), ("be1", False), ("ew2", True),
              ("eb2", False))


def build_affinity_params(net, compute_dtype: torch.dtype,
                          branches: Optional[Tuple[str, ...]] = None
                          ) -> Dict[str, torch.Tensor]:
    """Stack the link heads of ``branches`` (default: the net's
    ``score_branches``, in that order) and split
    the new/end first Dense into its feature rows and its pooled-evidence
    row.  Dense weights go to the compute dtype; BN terms and the scalar
    biases stay float32.  Shapes: w1 [K, Dc, H] (Dc = len(ops) * D),
    b1 / bn_* [K, H], w2 [K, H, 1], b2 [K], wn1 / we1 [D, hh],
    wnp / wep [1, hh], bn1 / be1 [hh], wn2 / ew2 [hh, 1], bn2 / eb2 [1].
    Raises for a net the kernel does not cover (``kernel_supported``)."""
    if not kernel_supported(net.cfg):
        raise ValueError("the fused affinity kernel does not cover this "
                         "model config (kernel_supported: num_layers=2, "
                         "new_end version >= 2)")
    mods = [getattr(net, f"affinity_{b}")
            for b in branches or net.score_branches]
    cdt, f32 = compute_dtype, torch.float32

    def stack(fn, dt):
        return torch.stack([fn(m) for m in mods]).to(dt).contiguous()

    out = {
        "w1": stack(lambda m: m.head_0.weight.t(), cdt),
        "b1": stack(lambda m: m.head_0.bias, cdt),
        "bn_mean": stack(lambda m: m.head_bn_0.running_mean, f32),
        "bn_inv": stack(lambda m: torch.rsqrt(m.head_bn_0.running_var
                                              + BN_EPS), f32),
        "bn_scale": stack(lambda m: m.head_bn_0.weight, f32),
        "bn_bias": stack(lambda m: m.head_bn_0.bias, f32),
        "w2": stack(lambda m: m.head_out.weight.t(), cdt),
        "b2": stack(lambda m: m.head_out.bias[0], f32),
    }
    for (k1, kp, k1b, k2, k2b), mlp in (
            (("wn1", "wnp", "bn1", "wn2", "bn2"), net.new_end.new_mlp),
            (("we1", "wep", "be1", "ew2", "eb2"), net.new_end.end_mlp)):
        w = mlp.dense_0.weight.t()                       # [D + 1, hh]
        out[k1] = w[:-1].to(cdt).contiguous()
        out[kp] = w[-1:].to(f32).contiguous()
        out[k1b] = mlp.dense_0.bias.to(f32).contiguous()
        out[k2] = mlp.dense_1.weight.t().to(cdt).contiguous()
        out[k2b] = mlp.dense_1.bias.to(f32).contiguous()
    return {k: v.detach() for k, v in out.items()}


def kernel_supported(cfg) -> bool:
    """Whether the fused kernel covers this ``ModelConfig``'s affinity
    math: the reference's ``pallas_supported``."""
    aff, ne = cfg.affinity, cfg.new_end
    return (aff.num_layers == 2
            and ne.version >= 2
            and all(op in CORRELATION_OPS for op in aff.correlation_ops)
            and ne.pool in POOL_CODES
            and aff.softmax_mode in MODE_CODES
            and cfg.score_fusion in ("add", "avg", "fused-only"))


def link_plain(a, b, mask_prev, mask_curr, p: Dict[str, torch.Tensor],
               link_bias=None, avg: bool = False, ops=("subabs",)):
    """Raw link scores [B, N, N]: per branch the correlation ``ops``
    (``correlation_tensor``, in the compute dtype) @ W1 (f32 accumulate,
    cast) + b1, eval BN in f32, ReLU, . w2 + b2 in f32; summed over
    branches in f32 (divided by K with ``avg``), plus ``link_bias``
    (f32), masked, cast.

    a, b [B, K, N, D] (branch 0 = fused) in the compute dtype; masks
    [B, N] bool; link_bias [B, N, N] float32 or None.
    """
    cdt = a.dtype
    pm = pair_mask(mask_prev, mask_curr)
    pair = correlation_tensor(a, b, ops)              # [B, K, N, N, Dc]
    h0 = (torch.matmul(pair, p["w1"][None, :, None])
          + p["b1"][None, :, None, None])
    mean, inv, scale, shift = (p[k][None, :, None, None] for k in (
        "bn_mean", "bn_inv", "bn_scale", "bn_bias"))
    h = torch.relu(((h0.float() - mean) * inv * scale + shift).to(cdt))
    score = torch.matmul(h.float(), p["w2"].float()[None, :, None])[..., 0]
    score = score + p["b2"][None, :, None, None]         # [B, K, N, N]
    link = score.sum(dim=1)
    if avg:
        link = link / score.shape[1]
    if link_bias is not None:
        link = link + link_bias
    return (link * pm.float()).to(cdt)


def heads_plain(link, a, b, mask_prev, mask_curr,
                p: Dict[str, torch.Tensor], pool: str = "max",
                softmax_mode: str = "dual") -> AffinityOutput:
    """The normalisation of ``softmax_mode`` and the v2 new/end heads
    over the link's ``pool`` from ``link`` (the kernel's second launch),
    in the compute dtype of ``link``."""
    cdt = link.dtype
    pm = pair_mask(mask_prev, mask_curr)
    norm = normalize_link(link, mask_prev, mask_curr, softmax_mode).to(cdt)

    def head(feat, pooled, w1, wp, b1, w2, b2, mask):
        hf = (torch.matmul(feat.float(), w1.float())
              + pooled[..., None] * wp[0] + b1)
        hh = torch.relu(hf.to(cdt))
        out = torch.matmul(hh.float(), w2.float())[..., 0] + b2[0]
        return (out * mask.float()).to(cdt)

    new = head(b[:, 0], pool_link(link, pm, -2, pool).float(), p["wn1"],
               p["wnp"], p["bn1"], p["wn2"], p["bn2"], mask_curr)
    end = head(a[:, 0], pool_link(link, pm, -1, pool).float(), p["we1"],
               p["wep"], p["be1"], p["ew2"], p["eb2"], mask_prev)
    return AffinityOutput(link, norm, new, end)


def affinity_plain(a, b, mask_prev, mask_curr, p: Dict[str, torch.Tensor],
                   link_bias=None, avg: bool = False, ops=("subabs",),
                   pool: str = "max",
                   softmax_mode: str = "dual") -> AffinityOutput:
    """The kernel's function in PyTorch ops (materialises the
    [B, K, N, N, Dc] pair tensor); outputs in the compute dtype."""
    link = link_plain(a, b, mask_prev, mask_curr, p, link_bias, avg, ops)
    return heads_plain(link, a, b, mask_prev, mask_curr, p, pool,
                       softmax_mode)


def check_widths(N: int, D: int, H: int, hh: int) -> None:
    """Raise on widths the kernel does not tile: N slots up to 128 (four
    ballot words per mask; the reference has no upper limit), D a
    multiple of 16 (16-byte rows, k16 steps), H and hh multiples of 8
    (16-byte W chunks, n8 tiles).  The only gate for D, H and hh: the C
    entry points trust it."""
    if not 0 < N <= MAX_N:
        raise ValueError(f"fused_affinity: N={N} outside 1..{MAX_N} (the "
                         f"kernel takes at most {MAX_N} slots a frame)")
    for name, v, m in (("D", D, 16), ("H", H, 8), ("hh", hh, 8)):
        if v <= 0 or v % m:
            raise ValueError(f"fused_affinity: {name}={v} is not a positive "
                             f"multiple of {m}")


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use in a checkout) and load ``csrc/affinity.cu``."""
    lib = ctypes.CDLL(str(build("affinity")))
    lib.mmmot_affinity_max_n.restype = ctypes.c_int
    if lib.mmmot_affinity_max_n() != MAX_N:
        raise RuntimeError(f"csrc/affinity.cu takes N up to "
                           f"{lib.mmmot_affinity_max_n()}, MAX_N is {MAX_N}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mmmot_affinity_products.argtypes = [ptr] * 17 + [i32] * 9 + [ptr]
    lib.mmmot_affinity_finish.argtypes = [ptr] * 17 + [i32] * 8 + [ptr]
    lib.mmmot_affinity_products.restype = i32
    lib.mmmot_affinity_finish.restype = i32
    return lib


def check_instance(ops, pool: str, softmax_mode: str) -> None:
    """Raise on an instance the kernel does not have: 1 to 4 correlation
    ops of ``OP_CODES``, a pool of ``POOL_CODES``, a mode of
    ``MODE_CODES``."""
    ops = tuple(ops)
    if not 1 <= len(ops) <= 4 or any(op not in OP_CODES for op in ops):
        raise ValueError(f"fused_affinity: correlation ops {ops} (1 to 4 "
                         f"of {tuple(OP_CODES)})")
    if pool not in POOL_CODES:
        raise ValueError(f"fused_affinity: unknown pool {pool!r}")
    if softmax_mode not in MODE_CODES:
        raise ValueError(f"fused_affinity: unknown softmax_mode "
                         f"{softmax_mode!r}")


def affinity_launches(a, b, mask_prev, mask_curr,
                      params: Dict[str, torch.Tensor], link_bias=None,
                      avg: bool = False, ops=("subabs",), pool: str = "max",
                      softmax_mode: str = "dual"):
    """Check CUDA inputs, allocate the outputs and the kernel's scratch,
    and return ``(products, finish, out)``: two closures that each launch
    one of the kernel's two launches on the current stream (the rows'
    cosine scales when ``ops`` has cosine and the dense products, then
    link, softmax and heads), and the ``AffinityOutput`` they fill.
    ``fused_affinity`` calls both; a caller may time each on its own.
    Raises on any input the kernel does not take.  With ``link_bias`` the
    second launch is the kernel's bias instance; with ``avg`` it divides
    the branch sum by K."""
    if a.device.type != "cuda":
        raise ValueError(f"fused_affinity: unsupported device {a.device}")
    ops = tuple(ops)
    check_instance(ops, pool, softmax_mode)
    B, K, N, D = a.shape
    cdt = a.dtype
    if not 1 <= K <= MAX_K:
        raise ValueError(f"fused_affinity: K={K} branches outside "
                         f"1..{MAX_K}")
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_affinity: dtype {cdt} not supported")
    H = params["w1"].shape[-1]
    hh = params["wn1"].shape[-1]
    check_widths(N, D, H, hh)
    dev = a.device
    check_tensor("b", b, dev, cdt, (B, K, N, D))
    check_tensor("a", a, dev, cdt, (B, K, N, D))
    check_tensor("mask_prev", mask_prev, dev, torch.bool, (B, N))
    check_tensor("mask_curr", mask_curr, dev, torch.bool, (B, N))
    if link_bias is not None:
        check_tensor("link_bias", link_bias, dev, torch.float32, (B, N, N))
    shapes = {"w1": (K, len(ops) * D, H), "b1": (K, H), "bn_mean": (K, H),
              "bn_inv": (K, H), "bn_scale": (K, H), "bn_bias": (K, H),
              "w2": (K, H, 1), "b2": (K,), "wn1": (D, hh), "wnp": (1, hh),
              "bn1": (hh,), "wn2": (hh, 1), "bn2": (1,), "we1": (D, hh),
              "wep": (1, hh), "be1": (hh,), "ew2": (hh, 1), "eb2": (1,)}
    for name, is_cdt in PARAM_SPEC:
        check_tensor(name, params[name], dev,
                     cdt if is_cdt else torch.float32, shapes[name])
    for name, t in (("a", a), ("b", b), ("w1", params["w1"]),
                    ("wn1", params["wn1"]), ("we1", params["we1"])):
        if t.data_ptr() % 16:      # read with 16-byte loads
            raise ValueError(f"{name} must start on a 16-byte boundary")
    lib = _library()
    out = AffinityOutput(torch.empty((B, N, N), dtype=cdt, device=dev),
                         torch.empty((B, N, N), dtype=cdt, device=dev),
                         torch.empty((B, N), dtype=cdt, device=dev),
                         torch.empty((B, N), dtype=cdt, device=dev))
    # Scratch: each branch's scores, and the heads' first Dense.
    part = torch.empty((B, K, N, N), dtype=torch.float32, device=dev)
    hs = torch.empty((B, 2, N, hh), dtype=torch.float32, device=dev)
    norms = (torch.empty((2, B, K, N), dtype=torch.float32, device=dev)
             if "cosine" in ops else None)
    ops_code = sum(OP_CODES[op] << (2 * i) for i, op in enumerate(ops))
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = {name: params[name].data_ptr() for name, _ in PARAM_SPEC}
    masks = (mask_prev.data_ptr(), mask_curr.data_ptr())
    tail = (int(cdt == torch.bfloat16), stream)

    def run(fn, *args):
        if B == 0:
            return
        with torch.cuda.device(dev):     # the device the C side launches on
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"fused_affinity: {fn.__name__} failed with "
                               f"CUDA error {rc}")

    def products():
        run(lib.mmmot_affinity_products, a.data_ptr(), b.data_ptr(), *masks,
            *(p[n] for n in ("w1", "b1", "bn_mean", "bn_inv", "bn_scale",
                             "bn_bias", "w2", "b2", "wn1", "we1")),
            part.data_ptr(), hs.data_ptr(),
            None if norms is None else norms.data_ptr(), B, K, N, D, H, hh,
            len(ops), ops_code, *tail)

    def finish():
        run(lib.mmmot_affinity_finish, part.data_ptr(), hs.data_ptr(),
            *masks, *(p[n] for n in ("wnp", "bn1", "wn2", "bn2", "wep", "be1",
                                     "ew2", "eb2")),
            *(t.data_ptr() for t in out),
            None if link_bias is None else link_bias.data_ptr(), B, K, N, hh,
            int(avg), POOL_CODES[pool], MODE_CODES[softmax_mode], *tail)

    return products, finish, out


def fused_affinity(a, b, mask_prev, mask_curr, params: Dict[str, torch.Tensor],
                   link_bias=None, avg: bool = False, ops=("subabs",),
                   pool: str = "max",
                   softmax_mode: str = "dual") -> AffinityOutput:
    """Fused affinity for a batch of frame pairs of K = ``a.shape[1]``
    branches, with an optional additive ``link_bias`` [B, N, N] float32;
    ``avg`` divides the branch sum by K; ``ops`` are the correlation ops
    (``params["w1"]`` has ``len(ops) * D`` rows), ``pool`` the new/end
    heads' pool and ``softmax_mode`` the normalisation.

    CUDA tensors launch the CUDA kernel and count one launch in
    ``fused_affinity.launches`` (the bias-free instance) or in
    ``fused_affinity.bias_launches`` (with ``link_bias``), one in
    ``fused_affinity.k_launches[K]`` and, with ``avg``, in
    ``fused_affinity.avg_launches``, and one each in
    ``fused_affinity.op_launches[ops]``, ``.pool_launches[pool]`` and
    ``.mode_launches[softmax_mode]``; CPU tensors run ``affinity_plain``.
    Raises on any input the kernel does not take.
    """
    ops = tuple(ops)
    if a.device.type == "cpu":
        check_instance(ops, pool, softmax_mode)
        return affinity_plain(a, b, mask_prev, mask_curr, params, link_bias,
                              avg, ops, pool, softmax_mode)
    products, finish, out = affinity_launches(a, b, mask_prev, mask_curr,
                                              params, link_bias, avg, ops,
                                              pool, softmax_mode)
    products()
    finish()
    if link_bias is None:
        fused_affinity.launches += 1
    else:
        fused_affinity.bias_launches += 1
    fused_affinity.k_launches[a.shape[1]] += 1
    fused_affinity.avg_launches += int(avg)
    fused_affinity.op_launches[ops] += 1
    fused_affinity.pool_launches[pool] += 1
    fused_affinity.mode_launches[softmax_mode] += 1
    return out


def reset_launches() -> None:
    """Every launch count of ``fused_affinity`` to 0."""
    fused_affinity.launches = fused_affinity.bias_launches = 0
    fused_affinity.avg_launches = 0
    fused_affinity.k_launches = dict.fromkeys(range(1, MAX_K + 1), 0)
    fused_affinity.op_launches = collections.Counter()
    fused_affinity.pool_launches = dict.fromkeys(POOL_CODES, 0)
    fused_affinity.mode_launches = dict.fromkeys(MODE_CODES, 0)


reset_launches()
