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
    ``use_running_average=True``, where the mask plays no part."""

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
        y = (x.float() - mean) * inv * scale + bias
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
