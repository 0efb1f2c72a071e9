"""Box geometry for the spatial association gate and the learned motion
term: port of ``mmmot_tpu/ops/boxes.py`` (``pairwise_iou``,
``pair_motion_features``)."""

from __future__ import annotations

import torch

from mmmot_tpu_torch.models.layers import fma


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ``a [..., M, 4]`` x ``b [..., N, 4]`` -> [..., M, N].

    Boxes are (l, t, r, b).  Degenerate boxes (zero area, e.g. empty
    slots) give IoU 0 against everything.
    """
    a = a[..., :, None, :]
    b = b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9),
                       torch.zeros_like(union))


MOTION_FEATURE_DIM = 6


def pair_motion_features(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-pair box geometry, ``a [..., M, 4]`` x ``b [..., N, 4]`` (l, t,
    r, b pixels) -> ``[..., M, N, 6]`` float32: the centre displacement
    (dx, dy) over the previous box's scale sqrt(w h), clamped to +-20;
    the log width and height ratios; the IoU; the centre distance in
    scales.  Widths and heights are clamped to 1 px, so every term is
    finite for zero (empty-slot) boxes, which the caller's pair mask
    zeroes: NaN times 0 would poison the masked scores.  The distance's
    ``dx dx + dy dy`` rounds once (``fma``), as the reference's compiled
    multiply-add does; XLA's ``log`` and its fusion of the IoU leave
    differences of an ulp.
    """
    a, b = a.float(), b.float()

    def parts(x):
        w = (x[..., 2] - x[..., 0]).clamp_min(1.0)
        h = (x[..., 3] - x[..., 1]).clamp_min(1.0)
        return (0.5 * (x[..., 0] + x[..., 2]), 0.5 * (x[..., 1] + x[..., 3]),
                w, h)

    acx, acy, aw, ah = parts(a[..., :, None, :])
    bcx, bcy, bw, bh = parts(b[..., None, :, :])
    scale = torch.sqrt(aw * ah)
    dx = ((bcx - acx) / scale).clamp(-20.0, 20.0)
    dy = ((bcy - acy) / scale).clamp(-20.0, 20.0)
    dist = torch.sqrt(fma(dx, dx, dy * dy))
    return torch.stack([dx, dy, torch.log(bw / aw), torch.log(bh / ah),
                        pairwise_iou(a, b), dist], dim=-1)
