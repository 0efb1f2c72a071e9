"""Conv bias, eval BatchNorm, ReLU and an optional 2x2 max-pool in one
pass: CUDA kernel wrapper and its plain PyTorch version.

After each 3x3 conv of the VGG trunk (``models/appearance.py::
VGGBackbone``) in eval mode, the biasless conv output ``x`` [n, C, H, W]
in the compute dtype T (float32 or bfloat16) becomes

    t = T(x + T(conv_bias))                       Conv3x3's bias add
    o = T(fma((float(t) - mean) * inv, scale, shift))   eval MaskedBatchNorm
    r = relu(o)

with ``inv = rsqrt(running_var + eps)``, and, where a 2x2 max-pool
follows the conv, ``F.max_pool2d(r, 2)``.  ``bn_relu_plain`` is that op
chain itself; ``fused_bn_relu`` launches ``csrc/bn_relu.cu`` for CUDA
tensors (one pass, bit-equal to the chain on the GPU: the source's note)
and runs ``bn_relu_plain`` for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from mmmot_tpu_torch.kernels import check_tensor
from mmmot_tpu_torch.kernels.build import build
from mmmot_tpu_torch.models.layers import BN_EPS

DTYPES = (torch.float32, torch.bfloat16)


def bn_relu_plain(x, conv_bias, bn, pool: bool = False):
    """The op chain: ``Conv3x3``'s bias add, ``bn`` (a ``MaskedBatchNorm``
    over dim 1), ``torch.relu`` and, with ``pool``, ``F.max_pool2d(., 2)``."""
    x = bn(x + conv_bias.to(x.dtype)[:, None, None])
    x = torch.relu(x)
    return F.max_pool2d(x, 2) if pool else x


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (first use in a checkout) and load ``csrc/bn_relu.cu``."""
    lib = ctypes.CDLL(str(build("bn_relu")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mmmot_bn_relu.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.mmmot_bn_relu.restype = i32
    return lib


def fused_bn_relu(x, conv_bias, bn, pool: bool = False):
    """``bn_relu_plain(x, conv_bias, bn, pool)`` in one pass.

    ``x`` [n, C, H, W] float32 or bfloat16 (channels-last in memory, as
    cuDNN writes a conv of a channels-last map; another layout is copied
    to it first), ``conv_bias`` [C], ``bn`` a ``MaskedBatchNorm`` over
    dim 1 in eval mode.  CUDA tensors launch the kernel on the current
    stream and count the launch (``.launches``, and with ``pool``
    ``.pool_launches``; an empty output launches nothing); the output is
    channels-last.  CPU tensors run the plain version.  Raises
    ``ValueError`` (``TypeError`` for a dtype) on what the kernel does not
    take."""
    if bn.training:
        raise ValueError("fused_bn_relu: the BatchNorm must be in eval mode")
    if x.dim() != 4:
        raise ValueError(f"x must be [n, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"fused_bn_relu: x has dtype {x.dtype}, expected "
                        f"one of {DTYPES}")
    if x.device.type == "cpu":
        return bn_relu_plain(x, conv_bias, bn, pool)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_relu: unsupported device {x.device}")
    n, C, H, W = x.shape
    dev = x.device
    x = x.contiguous(memory_format=torch.channels_last)
    cb = conv_bias.to(x.dtype)
    mean = bn.running_mean.float()
    inv = torch.rsqrt(bn.running_var + BN_EPS).float()
    scale, shift = bn.weight.float(), bn.bias.float()
    check_tensor("conv_bias", cb, dev, x.dtype, (C,))
    for name, t in (("running_mean", mean), ("inv", inv), ("weight", scale),
                    ("bias", shift)):
        check_tensor(name, t, dev, torch.float32, (C,))
    Ho, Wo = (H // 2, W // 2) if pool else (H, W)
    out = torch.empty((n, C, Ho, Wo), dtype=x.dtype, device=dev,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):     # the device the C side launches on
        rc = lib.mmmot_bn_relu(
            x.data_ptr(), cb.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n, H, W, C,
            int(pool), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_bn_relu: launch failed with error code "
                           f"{rc} (a cudaError_t, or csrc/bn_relu.cu's "
                           "kErrShape: one image of 2^31 elements or more)")
    fused_bn_relu.launches += 1
    fused_bn_relu.pool_launches += bool(pool)
    return out


# The wrapper's launch counts: all launches, and those with the pool.
LAUNCH_COUNTS = ("launches", "pool_launches")
for _name in LAUNCH_COUNTS:
    setattr(fused_bn_relu, _name, 0)


def launch_counts() -> dict:
    """The launch counts of ``fused_bn_relu`` by name."""
    return {name: getattr(fused_bn_relu, name) for name in LAUNCH_COUNTS}
