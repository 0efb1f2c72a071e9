"""Dense/conv layers with the reference's dtype journey, and eval BatchNorm.

Parameters stay float32.  A layer casts its input and weights to the
compute dtype, runs the product (float32 accumulation, result rounded to
the compute dtype) and adds the bias in the compute dtype, as a flax
``Dense``/``Conv`` with ``dtype`` set does.
"""

from __future__ import annotations

import torch
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


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the channel axis ``dim``, computed in
    float32 from the running statistics (eps 1e-5) and cast back to
    ``dtype`` — ``mmmot_tpu.models.layers.MaskedBatchNorm`` with
    ``use_running_average=True``, where the mask plays no part.  The last
    multiply-add rounds once (``fma``), as in the reference."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 dim: int = -1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.compute_dtype = dtype
        self.dim = dim

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.dim] = -1
        mean, var, scale, bias = (t.view(shape) for t in (
            self.running_mean, self.running_var, self.weight, self.bias))
        inv = torch.rsqrt(var + BN_EPS)
        y = fma((x.float() - mean) * inv, scale, bias)
        return y.to(self.compute_dtype)


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
