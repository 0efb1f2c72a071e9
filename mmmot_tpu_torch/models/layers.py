"""Dense/conv layers with the reference's dtype journey, and eval BatchNorm.

Parameters stay float32.  A layer casts its input and weights to the
compute dtype, runs the product (float32 accumulation, result rounded to
the compute dtype) and adds the bias in the compute dtype, as a flax
``Dense``/``Conv`` with ``dtype`` set does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

BN_EPS = 1e-5


def fma(a, b, c):
    """``a * b + c`` in float32 rounded once, as XLA's fused loops
    contract a multiply feeding an add (the reference's rounding).

    On the GPU, ``torch.addcmul``'s kernel compiles to one fused
    multiply-add (``chip_smoke.py`` holds it to the float64 form).  On the
    CPU the product runs in float64, where the product of two float32
    values is exact, so only the sum rounds twice, which changes a result
    once in about 2**29."""
    if a.is_cuda:
        return torch.addcmul(c.float(), a.float(), b.float())
    return (a.double() * b.double() + c.double()).float()


WINDOW = 32         # XLA CPU's tree reduction: lines longer than this sum
                    # in windows of this many entries


def ordered_sum(x, dim: int):
    """float32 sum over ``dim`` in the order of the reference's compiled
    CPU program: windows of ``WINDOW`` entries, each summed left to
    right, then the window sums left to right."""
    x = x.movedim(dim, -1)
    M = x.shape[-1]
    if M > WINDOW:
        if M % WINDOW:
            x = torch.nn.functional.pad(x, (0, WINDOW - M % WINDOW))
        x = x.unflatten(-1, (-1, WINDOW))
        return ordered_sum(ordered_sum(x, -1), -1)
    acc = x[..., 0]
    for k in range(1, M):
        acc = acc + x[..., k]
    return acc


class Dense(nn.Linear):
    """``nn.Linear`` evaluated in ``dtype`` (weight [out, in])."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class Conv3x3(nn.Conv2d):
    """3x3 'SAME' convolution evaluated in ``dtype`` on NCHW maps."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_ch, out_ch, 3, padding=1)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, padding=1)
        return y + self.bias.to(dt)[:, None, None]


class _TrainNorm(torch.autograd.Function):
    """Train-mode masked BatchNorm with the reference's gradient and a
    lean backward: only the input (in its own dtype) and per-channel
    vectors are kept, and the float32 passes are recomputed there.

    Moments in float32 over the ``m``-valid positions (``m`` broadcasts
    against ``x`` with size 1 on the channel axis; None: every
    position), ``cnt`` positions in all.  ``var = max(s2/cnt - mean^2,
    0)`` rounds the subtraction once (XLA contracts it; with one valid
    position that makes the tie at 0 rare but possible), and the maximum
    splits the gradient evenly at a tie, as ``jnp.maximum`` does.  The
    output is ``(x - mean) * rsqrt(var + eps) * scale + bias`` with the
    last multiply-add rounded once, cast to ``out_dtype``.

    With a process ``group`` (data parallelism; the reference's
    ``axis_name``) ``cnt``, ``s1`` and ``s2`` are summed over its ranks
    before the moments, and ``cnt`` is clamped to 1 after that sum; the
    backward sums its two per-channel reductions (of ``g`` and of ``g (x
    - mean)``) over the ranks as well, since every rank's input moved the
    shared moments, while the scale's and bias's gradients stay this
    rank's share (the trainer sums those with the other gradients).
    Returns (y, mean, var, cnt), cnt the clamped global count."""

    @staticmethod
    def forward(ctx, x, scale, bias, m, cnt, dims, shape, out_dtype,
                group=None):
        xf = x.float()
        if m is None:
            s1 = xf.sum(dims)
            s2 = (xf * xf).sum(dims)
        else:
            s1 = (xf * m).sum(dims)
            s2 = (xf * xf * m).sum(dims)
        if group is not None:
            buf = torch.cat([s1, s2, cnt.reshape(1)])
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            s1, s2, cnt = buf[:s1.numel()], buf[s1.numel():-1], buf[-1]
        cnt = cnt.clamp_min(1.0)
        mean = s1 / cnt
        var_raw = fma(-mean, mean, s2 / cnt)
        var = torch.maximum(var_raw, torch.zeros_like(var_raw))
        inv = torch.rsqrt(var + BN_EPS)
        y = fma((xf - mean.view(shape)) * inv.view(shape), scale.view(shape),
                bias.view(shape))
        ctx.save_for_backward(x, scale, m, mean, var_raw, inv)
        ctx.cnt, ctx.dims, ctx.shape, ctx.group = cnt, dims, shape, group
        ctx.mark_non_differentiable(cnt)
        return y.to(out_dtype), mean, var, cnt

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gcnt):
        x, scale, m, mean, var_raw, inv = ctx.saved_tensors
        cnt, dims, shape = ctx.cnt, ctx.dims, ctx.shape
        g = gy.float()
        xc = x.float() - mean.view(shape)
        g_bias = g.sum(dims)
        g_xc = (g * xc).sum(dims)                 # sum g * (x - mean)
        g_scale = g_xc * inv
        if ctx.group is not None:   # the moments' gradient sees every rank
            buf = torch.cat([g_bias, g_xc])
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=ctx.group)
            g_bias_all, g_xc = buf[:g_bias.numel()], buf[g_bias.numel():]
        else:
            g_bias_all = g_bias
        # y = xc * inv * scale + bias: through inv (var) and through mean.
        g_inv = g_xc * scale
        g_var = g_inv * (-0.5) * inv * inv * inv
        tie = torch.where(var_raw > 0, 1.0, torch.where(var_raw == 0, 0.5,
                                                        0.0))
        g_raw = g_var * tie
        g_s2 = g_raw / cnt
        g_s1 = (-inv * scale * g_bias_all - 2.0 * mean * g_raw) / cnt
        # Through s1 = sum(m x) and s2 = sum(m x^2).
        g_stats = g_s1.view(shape) + 2.0 * x.float() * g_s2.view(shape)
        gx = g * (inv * scale).view(shape) + (
            g_stats if m is None else m * g_stats)
        return (gx.to(x.dtype), g_scale, g_bias, None, None, None, None,
                None, None)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the channel axis ``dim`` in float32 (eps 1e-5),
    cast back to ``dtype``: ``mmmot_tpu.models.layers.MaskedBatchNorm``.

    Eval mode (``use_running_average``): the running statistics; the
    mask plays no part.  The last multiply-add rounds once (``fma``), as
    in the reference.

    Train mode (``self.training``): moments over the ``mask``-valid
    positions only (``_TrainNorm``).  ``mask`` covers the leading axes of
    ``x`` (without the channel): the per-crop mask [n] of a [n, C, H, W]
    map, a [..., P] point mask, a [..., Np, Nc] pair mask; each valid
    mask entry counts every position it covers (H*W for a crop).  The
    running statistics then move as ``0.9 * old + 0.1 * new`` with the
    variance stored unbiased (``* cnt / max(cnt - 1, 1)``), unless
    ``freeze_stats`` is set (a recomputation under gradient
    checkpointing).  ``group`` (None: this process alone) is the process
    group whose ranks share the train-mode moments (data parallelism:
    ``parallel/mesh.py``, ``norm_group``)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 dim: int = -1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.compute_dtype = dtype
        self.dim = dim
        self.freeze_stats = False
        self.group = None

    def forward(self, x, mask=None):
        dim = self.dim % x.dim()
        shape = [1] * x.dim()
        shape[dim] = -1
        if self.training:
            return self._train(x, mask, dim, shape)
        mean, var, scale, bias = (t.view(shape) for t in (
            self.running_mean, self.running_var, self.weight, self.bias))
        inv = torch.rsqrt(var + BN_EPS)
        y = fma((x.float() - mean) * inv, scale, bias)
        return y.to(self.compute_dtype)

    def _train(self, x, mask, dim, shape):
        dims = tuple(d for d in range(x.dim()) if d != dim)
        positions = x.numel() // x.shape[dim]
        if mask is None:
            m = None
            cnt = torch.tensor(float(positions), device=x.device)
        else:
            # The mask covers the leading non-channel axes; the view has
            # size 1 on every axis it does not cover (the channel too).
            lead = [s for d, s in enumerate(x.shape) if d != dim]
            if tuple(mask.shape) != tuple(lead[:mask.dim()]):
                raise ValueError(f"mask {tuple(mask.shape)} does not cover "
                                 f"the leading axes of {tuple(x.shape)}")
            view = list(mask.shape) + [1] * (len(lead) - mask.dim())
            view.insert(dim, 1)
            m = mask.reshape(view).float()
            cnt = mask.sum().float() * (positions // max(mask.numel(), 1))
        y, mean, var, cnt = _TrainNorm.apply(
            x, self.weight, self.bias, m, cnt, dims, shape,
            self.compute_dtype, self.group)
        if not self.freeze_stats:
            with torch.no_grad():
                unbiased = var * (cnt / (cnt - 1.0).clamp_min(1.0))
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * unbiased)
        return y


@contextlib.contextmanager
def norm_group(net: nn.Module, group):
    """While open, every ``MaskedBatchNorm`` of ``net`` takes its
    train-mode moments over the ranks of ``group`` (None: this process
    alone); the earlier groups come back on exit."""
    norms = [m for m in net.modules() if isinstance(m, MaskedBatchNorm)]
    saved = [m.group for m in norms]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m, g in zip(norms, saved):
            m.group = g


class DropBlock2D(nn.Module):
    """Structured dropout of NCHW maps: port of
    ``mmmot_tpu/models/layers.py::DropBlock2D``.

    In train mode, with ``bs = min(block_size, H, W)``, seeds are drawn
    at rate ``gamma = rate / bs**2 * H*W / ((H-bs+1) * (W-bs+1))`` on
    the [n, 1, H-bs+1, W-bs+1] grid (one mask for every channel), padded
    to H x W as the reference pads them, grown into bs x bs blocks by a
    stride-1 max-pool, and the map is kept outside the blocks and
    divided by the kept share of its image (at least 1e-6).  In eval mode
    and at rate 0 the layer is the identity.

    The seeds come from ``draw``: ``generator`` (a ``torch.Generator``
    on the map's device, which the trainer owns and sets with
    ``set_dropblock_generator``), or are given to ``forward`` (``seeds``:
    0/1 of that grid's shape), so that a test can feed the reference's
    own draw."""

    def __init__(self, rate: float = 0.1, block_size: int = 7):
        super().__init__()
        self.rate = rate
        self.block_size = block_size
        self.generator = None

    def grid(self, x):
        """(seed grid shape, gamma, bs) for the map ``x`` [n, C, H, W]."""
        h, w = x.shape[-2], x.shape[-1]
        bs = min(self.block_size, h, w)
        gamma = (self.rate / (bs ** 2)) * ((h * w) /
                                           max((h - bs + 1) * (w - bs + 1), 1))
        return (x.shape[0], 1, h - bs + 1, w - bs + 1), gamma, bs

    def draw(self, shape, gamma: float, device) -> torch.Tensor:
        """Bernoulli(``gamma``) seeds of ``shape`` from ``generator``."""
        if self.generator is None:
            raise ValueError("DropBlock2D in train mode needs a generator "
                             "(set_dropblock_generator) or seeds")
        return torch.rand(shape, generator=self.generator,
                          device=device) < gamma

    def forward(self, x, seeds=None):
        if not self.training or self.rate == 0.0:
            return x
        shape, gamma, bs = self.grid(x)
        if seeds is None:
            seeds = self.draw(shape, gamma, x.device)
        if tuple(seeds.shape) != shape:
            raise ValueError(f"seeds {tuple(seeds.shape)} != grid {shape}")
        # The reference pads the seeds by (bs // 2, bs - 1 - bs // 2) and
        # max-pools bs x bs with SAME padding ((bs - 1) // 2 before):
        # together one zero pad of bs // 2 + (bs - 1) // 2 before and
        # 2 (bs - 1) in all (the seeds are 0 or 1, so a zero pad is the
        # SAME pool's -inf pad).
        lo = bs // 2 + (bs - 1) // 2
        hi = 2 * (bs - 1) - lo
        s = F.pad(seeds.to(torch.float32), (lo, hi, lo, hi))
        keep = (1.0 - F.max_pool2d(s, bs, stride=1)).to(x.dtype)
        share = keep.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        return x * keep / share.clamp_min(1e-6)


def set_dropblock_generator(net: nn.Module, generator) -> None:
    """Every ``DropBlock2D`` of ``net`` draws its seeds from
    ``generator``."""
    for m in net.modules():
        if isinstance(m, DropBlock2D):
            m.generator = generator


class MLP2(nn.Module):
    """Dense -> ReLU -> Dense, no BatchNorm (new/end and det heads)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dense_0 = Dense(in_dim, hidden, dtype)
        self.dense_1 = Dense(hidden, out_dim, dtype)

    def forward(self, x):
        return self.dense_1(torch.relu(self.dense_0(x)))


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero, as XLA's CPU and TPU code does
    (flush-to-zero)."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(x.abs() < tiny, torch.zeros_like(x), x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.sigmoid``.

    float32: ``torch.sigmoid``.  Lower precisions: ``1 / (1 + exp(-x))``
    op by op, each op evaluated in float32, flushed to zero where
    subnormal and rounded to ``x.dtype``, which are the rounding points
    XLA gives the reference (a single rounding from float32 differs on
    1116 of the 65280 finite bfloat16 inputs)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    dt = x.dtype
    e = _flush_subnormal(torch.exp(-x.float())).to(dt)
    d = (e.float() + 1.0).to(dt)
    return _flush_subnormal(torch.reciprocal(d.float())).to(dt)
