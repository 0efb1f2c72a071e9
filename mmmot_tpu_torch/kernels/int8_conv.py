"""Int8 3x3 convolution with the requantisation epilogue and an optional
fused 2x2 max-pool: CUDA kernel wrapper and its plain PyTorch versions.

The conv of ``mmmot_tpu/models/quantize.py::quantized_trunk_stages``
(an XLA op there, ``:267-271``): for an NHWC int8 map ``xq`` [n, H, W,
Cin], weights ``wq`` [Cout, Kp] int8 (``pack_weights``: K = 9 * Cin in
(ky, kx, ci) order, zero-padded to ``Kp``, a multiple of ``K_STEP``) and
per-channel float32 ``m``, ``b`` [Cout]:

    acc = conv3x3_same(xq, w)                  int32, exact
    out = clip(round(fma(float32(acc), m, b)), 0, 127)   int8 NHWC

with ``round`` half to even and the multiply-add rounded once, as XLA
compiles the reference's ``acc.astype(f32) * m + b``.  With ``pool``,
``out`` is then max-pooled 2x2, stride 2, VALID (the reference's pool
that follows a stage's last conv, ``:261``), after the requant.

``int8_conv3x3_requant`` launches ``csrc/int8_conv.cu`` for CUDA
tensors and runs ``int8_conv3x3_requant_plain`` (or, with ``pool``,
``int8_conv3x3_requant_pool_plain``) for CPU tensors; there is no other
fallback.  The plain version runs the conv in float64, where every
partial sum of int8 products is an exact integer, so it gives the
kernel's int8 map bit for bit.  The kernel has two instances, picked
from Cin (``conv_instance``): ``main`` (Cin a multiple of 32: TMA loads
and ``wgmma``) and ``stem`` (any other Cin: the im2col tile built in
shared memory).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from mmmot_tpu_torch.kernels import check_tensor
from mmmot_tpu_torch.kernels.build import build
from mmmot_tpu_torch.models.layers import fma

K_STEP = 32     # csrc/int8_conv.cu kKStep; _library checks that they agree


def padded_k(cin: int) -> int:
    """``Kp``: 9 * Cin rounded up to a multiple of ``K_STEP``."""
    return -(-9 * cin // K_STEP) * K_STEP


def pack_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """HWIO int8 [3, 3, Cin, Cout] (the reference's layout) -> the
    kernel's [Cout, Kp] int8, K-major in (ky, kx, ci) order, zero past
    9 * Cin."""
    _, _, cin, cout = w_hwio.shape
    w = w_hwio.permute(3, 0, 1, 2).reshape(cout, 9 * cin)
    return F.pad(w, (0, padded_k(cin) - 9 * cin)).contiguous()


def unpack_weights(wq: torch.Tensor, cin: int) -> torch.Tensor:
    """Inverse of ``pack_weights``: [Cout, Kp] -> HWIO [3, 3, Cin, Cout]."""
    cout = wq.shape[0]
    return wq[:, :9 * cin].reshape(cout, 3, 3, cin).permute(1, 2, 3, 0)


def requant(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor):
    """int32-valued accumulators (any dtype holding them exactly) ->
    int8 ``clip(round(fma(float32(acc), m, b)), 0, 127)``."""
    y = fma(acc.float(), m, b)
    return torch.round(y).clamp_(0, 127).to(torch.int8)


def int8_conv3x3_requant_plain(xq, wq, m, b):
    """The kernel's function in PyTorch ops: a float64 ``F.conv2d``
    (exact: |acc| < 2**53) and ``requant``."""
    cin = xq.shape[-1]
    w = unpack_weights(wq, cin).permute(3, 2, 0, 1).double()   # OIHW
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, padding=1)
    return requant(acc.permute(0, 2, 3, 1), m, b).contiguous()


def max_pool_int8(xq: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max-pool of an NHWC map, in its own dtype."""
    n, H, W, C = xq.shape
    h, w = H // 2, W // 2
    x = xq[:, :2 * h, :2 * w].reshape(n, h, 2, w, 2, C)
    return x.amax(dim=(2, 4))


def int8_conv3x3_requant_pool_plain(xq, wq, m, b):
    """The kernel's fused-pool function in PyTorch ops:
    ``max_pool_int8`` of ``int8_conv3x3_requant_plain``."""
    return max_pool_int8(int8_conv3x3_requant_plain(xq, wq, m, b))


def conv_instance(cin: int) -> str:
    """The kernel instance for ``cin`` input channels: ``"main"`` when
    Cin is a multiple of ``K_STEP`` (a K step never straddles two taps,
    so TMA loads whole channel runs), else ``"stem"``."""
    return "main" if cin % K_STEP == 0 else "stem"


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use in a checkout) and load ``csrc/int8_conv.cu``."""
    lib = ctypes.CDLL(str(build("int8_conv")))
    lib.mmmot_int8_conv_k_step.restype = ctypes.c_int
    if lib.mmmot_int8_conv_k_step() != K_STEP:
        raise RuntimeError(f"csrc/int8_conv.cu steps K by "
                           f"{lib.mmmot_int8_conv_k_step()}, K_STEP is "
                           f"{K_STEP}")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mmmot_int8_conv3x3.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.mmmot_int8_conv3x3.restype = i32
    lib.mmmot_int8_conv_plan.argtypes = [i32] * 8 + [ptr]
    lib.mmmot_int8_conv_plan.restype = i32
    return lib


PLAN_KEYS = ("tile_w", "tile_h", "tiles_x", "tiles_y", "tile_n", "n_tiles",
             "k_bytes", "smem", "blocks", "halo")


def conv_plan(n: int, H: int, W: int, cin: int, cout: int,
              pool: bool = False) -> dict:
    """What ``csrc/int8_conv.cu`` launches for a shape (``PLAN_KEYS``: the
    pixel tile, the output-channel tile, the K bytes of a stage or group,
    the dynamic shared memory, the blocks, and whether the main instance
    loads halo rows once for three taps); builds the library, runs
    nothing on the device."""
    info = (ctypes.c_int * len(PLAN_KEYS))()
    instance = conv_instance(cin)
    rc = _library().mmmot_int8_conv_plan(n, H, W, cin, cout, padded_k(cin),
                                         int(pool), int(instance == "stem"),
                                         info)
    if rc != 0:
        raise ValueError(f"int8 conv: the {instance} instance refuses "
                         f"[{n}, {H}, {W}, {cin}] -> {cout} (code {rc})")
    return {"instance": instance, **dict(zip(PLAN_KEYS, info))}


def _check_inputs(xq, wq, m, b):
    """Raise unless the inputs are what the kernel and the plain version
    both take: ``xq`` int8 [n, H, W, Cin], ``wq`` int8 [Cout,
    padded_k(Cin)], ``m`` and ``b`` float32 [Cout], contiguous, on one
    device."""
    if xq.dim() != 4:
        raise ValueError(f"xq must be [n, H, W, Cin], got {tuple(xq.shape)}")
    if wq.dim() != 2:
        raise ValueError(f"wq must be [Cout, Kp], got {tuple(wq.shape)}")
    n, H, W, cin = xq.shape
    cout = wq.shape[0]
    dev = xq.device
    check_tensor("xq", xq, dev, torch.int8, (n, H, W, cin))
    check_tensor("wq", wq, dev, torch.int8, (cout, padded_k(cin)))
    check_tensor("m", m, dev, torch.float32, (cout,))
    check_tensor("b", b, dev, torch.float32, (cout,))


def int8_conv3x3_requant(xq, wq, m, b, pool: bool = False):
    """3x3 SAME int8 conv with the requant epilogue (module docstring),
    and with ``pool`` the 2x2 VALID max-pool of its output, fused.

    CUDA tensors launch the CUDA kernel's ``conv_instance(Cin)`` on the
    current stream and count the launch (``LAUNCH_COUNTS``: in
    ``.launches``, in ``.main_launches`` or ``.stem_launches``, and with
    ``pool`` in ``.pool_launches``; an empty output launches nothing);
    CPU tensors run the plain version.  Raises ``ValueError`` (or
    ``TypeError`` for a dtype) on any input the kernel does not take."""
    _check_inputs(xq, wq, m, b)
    if xq.device.type == "cpu":
        return (int8_conv3x3_requant_pool_plain if pool
                else int8_conv3x3_requant_plain)(xq, wq, m, b)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv3x3_requant: unsupported device "
                         f"{xq.device}")
    n, H, W, cin = xq.shape
    cout, kp = wq.shape
    if cout % 8:
        raise ValueError(f"int8_conv3x3_requant: Cout={cout} is not a "
                         "multiple of 8")
    instance = conv_instance(cin)
    if wq.data_ptr() % 16 or (instance == "main" and xq.data_ptr() % 16):
        raise ValueError("xq and wq must start on a 16-byte boundary")
    shape = (n, H // 2, W // 2, cout) if pool else (n, H, W, cout)
    out = torch.empty(shape, dtype=torch.int8, device=xq.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(xq.device):   # the device the C side launches on
        rc = lib.mmmot_int8_conv3x3(
            xq.data_ptr(), wq.data_ptr(), m.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, H, W, cin, cout, kp, int(pool),
            int(instance == "stem"),
            torch.cuda.current_stream(xq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv3x3_requant: launch failed with error "
                           f"code {rc} (a cudaError_t, or csrc/int8_conv.cu's "
                           "kErr codes)")
    fn = int8_conv3x3_requant
    fn.launches += 1
    if instance == "main":
        fn.main_launches += 1
    else:
        fn.stem_launches += 1
    fn.pool_launches += bool(pool)
    return out


# The wrapper's launch counts: all launches, by instance, with the pool.
LAUNCH_COUNTS = ("launches", "main_launches", "stem_launches",
                 "pool_launches")


def reset_launches() -> None:
    """Set every launch count of ``int8_conv3x3_requant`` to 0."""
    for name in LAUNCH_COUNTS:
        setattr(int8_conv3x3_requant, name, 0)


def launch_counts() -> dict:
    """The launch counts of ``int8_conv3x3_requant`` by name."""
    return {name: getattr(int8_conv3x3_requant, name)
            for name in LAUNCH_COUNTS}


reset_launches()
