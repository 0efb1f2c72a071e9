"""Device selection and the float32 parity mode."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


@contextlib.contextmanager
def f32_parity(enabled: bool = True):
    """Full-precision float32 on the GPU: TF32 off for cuBLAS matmuls and
    cuDNN convolutions (cuDNN defaults to TF32), restored on exit."""
    if not enabled:
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
