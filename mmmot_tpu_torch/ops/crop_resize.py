"""Per-detection crop extraction and separable bilinear resize.

Port of ``mmmot_tpu/ops/crop_resize.py``.  The compact-first crop path
(``crop_and_resize_gathered``): each detection takes a fixed
``window``-column band of its source frame around the box (an indexed
gather), and the band is resized with two dense interpolation matrices.
The per-slot path (``crop_and_resize_mxu``, ``crop_and_resize_batched``,
which the training loader uses) resizes the whole frame the same way for
every slot of it.  The dtype journey of the reference is kept
exactly: the band pixels and the x-interpolation weights are rounded to
the resize dtype (bfloat16, whatever the model's compute dtype), the
y-weights are rounded to it and widened again, and both contractions
accumulate in float32.  Products
of bfloat16 values are exact in float32, so the contractions run as
float32 matmuls on the rounded operands (TF32 must be off, as PyTorch's
default for matmuls has it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmmot_tpu_torch.models.layers import fma

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESIZE_DTYPE = torch.bfloat16     # the reference's resize dtype


def _interp_matrix(lo, hi, n_out: int, size_in: int, dtype,
                   band: bool = True):
    """[n, n_out, size_in] two-tap bilinear weights (clamped tent) for
    half-pixel-centre samples of [lo, hi) per detection.

    The sample positions round as XLA compiles the reference's
    ``lo + (hi - lo) * (i + 0.5) / n_out - 0.5``: the division becomes a
    multiply by the float32 reciprocal and the multiply-add rounds once.
    In the band resize (``band``) the reciprocal is folded into the box
    width; in the whole-frame resize into the constant ``(i + 0.5)``."""
    dev = lo.device
    half = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    inv = torch.tensor(1.0 / n_out, dtype=torch.float32, device=dev)
    if band:
        pos = fma(half[None, :], ((hi - lo) * inv)[:, None], lo[:, None])
    else:
        pos = fma((hi - lo)[:, None], (half * inv)[None, :], lo[:, None])
    pos = pos - 0.5
    pos = pos.clamp(0.0, size_in - 1.0)
    grid = torch.arange(size_in, dtype=torch.float32, device=dev)
    w = (1.0 - (pos[:, :, None] - grid[None, None, :]).abs()).clamp_min(0.0)
    return w.to(dtype)


def _window_starts(boxes, width: int, win: int):
    """Column start (float) of a ``win``-wide band centred on each box."""
    cx = 0.5 * (boxes[:, 0] + boxes[:, 2])
    return torch.round(cx - win / 2.0).clamp(0.0, float(width - win))


def _band_resize(bands, boxes, ws, out_size: Tuple[int, int],
                 mask: Optional[torch.Tensor]):
    """bands [n, H, win, C] starting at column ``ws`` -> crops [n, h, w, C]
    float32."""
    n, H, win, C = bands.shape
    h, w = out_size
    l, t, r, b = boxes.unbind(-1)
    ry = _interp_matrix(t, b, h, H, RESIZE_DTYPE).float()
    rx = _interp_matrix(l - ws, r - ws, w, win, RESIZE_DTYPE).float()
    x = bands.to(RESIZE_DTYPE).float()
    tmp = torch.einsum("nHWc,nwW->nHwc", x, rx)
    out = torch.einsum("nhH,nHwc->nhwc", ry, tmp)
    if mask is not None:
        out = out * mask[:, None, None, None].to(out.dtype)
    return out


def crop_and_resize_gathered(images, frame_idx, boxes,
                             out_size: Tuple[int, int],
                             mask: Optional[torch.Tensor] = None,
                             window: int = 512):
    """images [T, H, W, C], frame_idx [n], boxes [n, 4] (l, t, r, b pixels)
    -> crops [n, h, w, C] float32, zero where ``mask`` is False."""
    T, H, W, C = images.shape
    win = min(window, W)
    ws = _window_starts(boxes, W, win)
    dev = images.device
    cols = ws.long()[:, None] + torch.arange(win, device=dev)[None, :]
    rows = torch.arange(H, device=dev)
    bands = images[frame_idx.long()[:, None, None], rows[None, :, None],
                   cols[:, None, :]]                      # [n, H, win, C]
    return _band_resize(bands, boxes, ws, out_size, mask)


def crop_and_resize_mxu(image, boxes, out_size: Tuple[int, int],
                        mask: Optional[torch.Tensor] = None):
    """image [H, W, C], boxes [N, 4] (l, t, r, b pixels) -> crops [N, h,
    w, C] float32, zero where ``mask`` is False: the separable resize of
    the whole frame (``out = Ry @ img @ Rx^T`` per detection), with
    ``_band_resize``'s rounding."""
    H, W, C = image.shape
    h, w = out_size
    l, t, r, b = boxes.float().unbind(-1)
    ry = _interp_matrix(t, b, h, H, RESIZE_DTYPE, band=False).float()
    rx = _interp_matrix(l, r, w, W, RESIZE_DTYPE, band=False).float()
    x = image.to(RESIZE_DTYPE).float()
    tmp = torch.einsum("HWc,nwW->nHwc", x, rx)
    out = torch.einsum("nhH,nHwc->nhwc", ry, tmp)
    if mask is not None:
        out = out * mask[:, None, None, None].to(out.dtype)
    return out


def crop_and_resize_batched(images, boxes, out_size: Tuple[int, int],
                            mask: Optional[torch.Tensor] = None):
    """images [..., H, W, C], boxes [..., N, 4] -> crops [..., N, h, w, C]
    (``crop_and_resize_mxu`` per frame; the reference's
    ``method="mxu"``)."""
    lead = boxes.shape[:-2]
    H, W, C = images.shape[-3:]
    N = boxes.shape[-2]
    imgs = images.reshape(-1, H, W, C)
    bx = boxes.reshape(-1, N, 4)
    ms = None if mask is None else mask.reshape(-1, N)
    out = torch.stack([crop_and_resize_mxu(
        imgs[i], bx[i], out_size, None if ms is None else ms[i])
        for i in range(imgs.shape[0])])
    return out.reshape(lead + (N,) + out.shape[-3:])


def normalize_crops(crops, scale: float = 1.0 / 255.0):
    """Pixel crops -> ImageNet-normalised float32, rounded as the
    reference's ``(x * scale - mean) / std`` compiles: one multiply-add,
    then a multiply by the float32 reciprocal of ``std``."""
    mean = torch.tensor(IMAGENET_MEAN, device=crops.device)
    inv_std = 1.0 / torch.tensor(IMAGENET_STD, device=crops.device)
    scale = torch.tensor(scale, dtype=torch.float32, device=crops.device)
    return fma(crops.float(), scale, -mean) * inv_std
