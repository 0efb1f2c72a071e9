"""Box geometry for the spatial association gate: port of
``mmmot_tpu/ops/boxes.py::pairwise_iou``."""

from __future__ import annotations

import torch


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
