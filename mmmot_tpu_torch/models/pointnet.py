"""LiDAR branch: port of ``mmmot_tpu/models/pointnet.py::PointNet``
(shared per-point MLP, masked max pool, projection; no T-Net)."""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.config import PointConfig
from mmmot_tpu_torch.models.layers import Dense, MaskedBatchNorm
from mmmot_tpu_torch.ops.masking import masked_max

POINT_IN_DIM = 4    # x, y, z, reflectance


class PointNet(nn.Module):
    """points [..., P, C], point_mask [..., P], det_mask [...]
    -> [..., out_dim]."""

    def __init__(self, cfg: PointConfig, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        in_ch = POINT_IN_DIM
        for i, ch in enumerate(cfg.channels):
            self.add_module(f"mlp_{i}", Dense(in_ch, ch, dtype))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch, dtype))
            in_ch = ch
        self.n_layers = len(cfg.channels)
        self.proj = Dense(in_ch, cfg.out_dim, dtype)

    def forward(self, points, point_mask, det_mask=None):
        pm = point_mask
        if det_mask is not None:
            pm = pm & det_mask[..., None]
        x = points.to(self.compute_dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"mlp_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x))
        feat = self.proj(masked_max(x, pm[..., None], dim=-2))
        if det_mask is not None:
            feat = feat * det_mask[..., None].to(feat.dtype)
        return feat
