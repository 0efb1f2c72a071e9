"""Modality fusion: port of ``mmmot_tpu/models/fusion.py::FusionModule``.

Variant A projects the concatenation (``proj``), B adds the two
projections (``proj_image``, ``proj_lidar``), C gates them with a
sigmoid per modality (``gate``).  With ``keep_single`` the raw
embeddings given ride beside ``fused``.  With one modality (``use_image``
or ``use_lidar`` off, or a dead sensor whose embedding is ``None``) the
surviving raw embedding, masked, is ``fused``.  A module built for one
modality owns no gate or projection weights, as the flax module creates
none."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmmot_tpu_torch.config import FusionConfig
from mmmot_tpu_torch.models.layers import Dense, sigmoid


class FusionModule(nn.Module):
    def __init__(self, cfg: FusionConfig, image_dim: Optional[int],
                 lidar_dim: Optional[int], dtype: torch.dtype):
        """``image_dim`` / ``lidar_dim`` None: that modality is off."""
        super().__init__()
        self.variant, self.keep_single = cfg.variant, cfg.keep_single
        if image_dim is not None and lidar_dim is not None:
            if cfg.variant == "A":
                self.proj = Dense(image_dim + lidar_dim, cfg.out_dim, dtype)
            else:
                if cfg.variant == "C":
                    self.gate = Dense(image_dim + lidar_dim, 2, dtype)
                self.proj_image = Dense(image_dim, cfg.out_dim, dtype)
                self.proj_lidar = Dense(lidar_dim, cfg.out_dim, dtype)

    def forward(self, image_feat, lidar_feat, det_mask=None):
        """-> {"fused"}, and with ``keep_single`` the embeddings given
        ({"image", "lidar"})."""
        feats = {k: v for k, v in (("image", image_feat),
                                   ("lidar", lidar_feat)) if v is not None}
        if not feats:
            raise ValueError("fusion needs at least one modality")
        if len(feats) == 1:
            fused = next(iter(feats.values()))
        elif self.variant == "A":
            fused = self.proj(torch.cat([image_feat, lidar_feat], dim=-1))
        elif self.variant == "B":
            fused = self.proj_image(image_feat) + self.proj_lidar(lidar_feat)
        else:
            gates = sigmoid(self.gate(torch.cat([image_feat, lidar_feat],
                                                dim=-1)))
            fused = (gates[..., 0:1] * self.proj_image(image_feat)
                     + gates[..., 1:2] * self.proj_lidar(lidar_feat))
        if det_mask is not None:
            fused = fused * det_mask[..., None].to(fused.dtype)
        return {"fused": fused, **(feats if self.keep_single else {})}
