"""Int8 3x3 convolution with the requantisation epilogue: CUDA kernel
wrapper and its plain PyTorch version.

The conv of ``mmmot_tpu/models/quantize.py::quantized_trunk_stages``
(an XLA op there, ``:267-271``): for an NHWC int8 map ``xq`` [n, H, W,
Cin], weights ``wq`` [Cout, Kp] int8 (``pack_weights``: K = 9 * Cin in
(ky, kx, ci) order, zero-padded to ``Kp``, a multiple of ``K_STEP``) and
per-channel float32 ``m``, ``b`` [Cout]:

    acc = conv3x3_same(xq, w)                  int32, exact
    out = clip(round(fma(float32(acc), m, b)), 0, 127)   int8 NHWC

with ``round`` half to even and the multiply-add rounded once, as XLA
compiles the reference's ``acc.astype(f32) * m + b``.

``int8_conv3x3_requant`` launches ``csrc/int8_conv.cu`` for CUDA
tensors and runs ``int8_conv3x3_requant_plain`` for CPU tensors; there
is no other fallback.  The plain version runs the conv in float64, where
every partial sum of int8 products is an exact integer, so it gives the
kernel's int8 map bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from mmmot_tpu_torch.kernels import check_tensor
from mmmot_tpu_torch.kernels.build import build
from mmmot_tpu_torch.models.layers import fma

K_STEP = 32     # csrc/int8_conv.cu kBK; _library checks that they agree


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
    lib.mmmot_int8_conv3x3.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.mmmot_int8_conv3x3.restype = i32
    return lib


def int8_conv3x3_requant(xq, wq, m, b):
    """3x3 SAME int8 conv with the requant epilogue (module docstring).

    CUDA tensors launch the CUDA kernel on the current stream and count
    one launch in ``int8_conv3x3_requant.launches``; CPU tensors run
    ``int8_conv3x3_requant_plain``.  Raises on any input the kernel does
    not take."""
    if xq.device.type == "cpu":
        return int8_conv3x3_requant_plain(xq, wq, m, b)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv3x3_requant: unsupported device "
                         f"{xq.device}")
    if xq.dim() != 4:
        raise ValueError(f"xq must be [n, H, W, Cin], got {tuple(xq.shape)}")
    n, H, W, cin = xq.shape
    cout, kp = wq.shape
    dev = xq.device
    check_tensor("xq", xq, dev, torch.int8, (n, H, W, cin))
    check_tensor("wq", wq, dev, torch.int8, (cout, padded_k(cin)))
    check_tensor("m", m, dev, torch.float32, (cout,))
    check_tensor("b", b, dev, torch.float32, (cout,))
    if cout % 8:
        raise ValueError(f"int8_conv3x3_requant: Cout={cout} is not a "
                         "multiple of 8")
    if wq.data_ptr() % 16 or (cin % K_STEP == 0 and xq.data_ptr() % 16):
        raise ValueError("xq and wq must start on a 16-byte boundary")
    lib = _library()
    out = torch.empty((n, H, W, cout), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):         # the device the C side launches on
        rc = lib.mmmot_int8_conv3x3(
            xq.data_ptr(), wq.data_ptr(), m.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, H, W, cin, cout, kp,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv3x3_requant: launch failed with CUDA "
                           f"error {rc}")
    int8_conv3x3_requant.launches += 1
    return out


int8_conv3x3_requant.launches = 0
