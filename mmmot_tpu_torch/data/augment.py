"""Training-time augmentation: port of ``mmmot_tpu/data/augment.py``.

Horizontal flip and colour jitter (brightness, contrast, saturation) of
the crops, drawn per (batch, detection slot) and shared by the T frames
of a sample, so that the same object transforms the same way in both
frames and the link labels stay valid; LiDAR point jitter and random
point dropout that never empties a valid detection.  The strengths are
the reference's defaults.

Drawing (``draw_augment``, a ``torch.Generator`` on the batch's device)
is kept apart from applying (``apply_augment``), so that the draws of
another generator can be applied as they are.
"""

from __future__ import annotations

from typing import Dict

import torch

FLIP_PROB = 0.5
BRIGHTNESS = CONTRAST = SATURATION = 0.2   # factors uniform in 1 +- 0.2
POINT_SIGMA = 0.01                         # xyz jitter
POINT_DROP = 0.1                           # share of points dropped


def draw_augment(gen: torch.Generator, batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The random draws for ``batch`` (crops [B, T, N, h, w, 3], points
    [B, T, N, P, C], point_mask [B, T, N, P]): flip [B, 1, N] bool;
    brightness, contrast, saturation factors [B, 1, N, 1, 1, 1]; point
    noise (points' shape); keep [B, T, N, P] bool."""
    dev = gen.device
    B, _, N = batch["crops"].shape[:3]
    per_slot = (B, 1, N, 1, 1, 1)

    def uniform(amp):
        u = torch.rand(per_slot, generator=gen, device=dev)
        return (1.0 - amp) + 2.0 * amp * u

    return {
        "flip": torch.rand((B, 1, N), generator=gen, device=dev) < FLIP_PROB,
        "brightness": uniform(BRIGHTNESS),
        "contrast": uniform(CONTRAST),
        "saturation": uniform(SATURATION),
        "noise": POINT_SIGMA * torch.randn(batch["points"].shape,
                                           generator=gen, device=dev),
        "keep": torch.rand(batch["point_mask"].shape, generator=gen,
                           device=dev) < 1.0 - POINT_DROP}


def apply_augment(batch: Dict[str, torch.Tensor],
                  draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``batch`` with ``draws`` (``draw_augment``'s keys) applied, in the
    reference's order: flip, brightness, contrast (around each crop's
    mean), saturation (around each pixel's grey); xyz jitter; point
    dropout, undone for a detection that would lose every point."""
    crops = batch["crops"]
    crops = torch.where(draws["flip"][..., None, None, None],
                        crops.flip(-2), crops)
    crops = crops * draws["brightness"]
    mean = crops.mean(dim=(-3, -2, -1), keepdim=True)
    crops = (crops - mean) * draws["contrast"] + mean
    gray = crops.mean(dim=-1, keepdim=True)
    crops = (crops - gray) * draws["saturation"] + gray
    points = batch["points"]
    noise = draws["noise"][..., :3].to(points.dtype)
    points = torch.cat([points[..., :3] + noise, points[..., 3:]], dim=-1)
    pm0 = batch["point_mask"]
    pm = pm0 & draws["keep"]
    return {**batch, "crops": crops, "points": points,
            "point_mask": torch.where(pm.any(-1, keepdim=True), pm, pm0)}


def augment_batch(gen: torch.Generator, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Augment a training batch: ``apply_augment(batch,
    draw_augment(gen, batch))``."""
    return apply_augment(batch, draw_augment(gen, batch))
