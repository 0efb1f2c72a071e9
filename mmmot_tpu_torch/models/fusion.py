"""Attention-gated fusion (variant C, ``keep_single``): port of
``mmmot_tpu/models/fusion.py::FusionModule``."""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.config import FusionConfig
from mmmot_tpu_torch.models.layers import Dense, sigmoid


class FusionModule(nn.Module):
    def __init__(self, cfg: FusionConfig, image_dim: int, lidar_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.gate = Dense(image_dim + lidar_dim, 2, dtype)
        self.proj_image = Dense(image_dim, cfg.out_dim, dtype)
        self.proj_lidar = Dense(lidar_dim, cfg.out_dim, dtype)

    def forward(self, image_feat, lidar_feat, det_mask=None):
        """-> {"fused", "image", "lidar"} embeddings."""
        gates = sigmoid(self.gate(torch.cat([image_feat, lidar_feat],
                                                  dim=-1)))
        fused = (gates[..., 0:1] * self.proj_image(image_feat)
                 + gates[..., 1:2] * self.proj_lidar(lidar_feat))
        if det_mask is not None:
            fused = fused * det_mask[..., None].to(fused.dtype)
        return {"fused": fused, "image": image_feat, "lidar": lidar_feat}
