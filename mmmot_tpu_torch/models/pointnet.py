"""LiDAR branch: port of ``mmmot_tpu/models/pointnet.py`` (``PointNet``:
an optional T-Net input transform, a shared per-point MLP, masked max
pool, projection; ``TNet``).  In train mode the BatchNorms count the
valid points of valid detections only."""

from __future__ import annotations

import torch
from torch import nn

from mmmot_tpu_torch.config import PointConfig
from mmmot_tpu_torch.models.layers import Dense, MaskedBatchNorm
from mmmot_tpu_torch.ops.masking import masked_max

POINT_IN_DIM = 4    # x, y, z, reflectance
TNET_CHANNELS = (64, 128, 256)


class TNet(nn.Module):
    """points [..., P, k] (compute dtype), point_mask [..., P] -> a k x k
    alignment matrix [..., k, k]: a masked per-point MLP (``mlp_{i}``,
    ``bn_{i}``), max pool, ``fc_0`` and ReLU, ``fc_mat`` plus the
    identity."""

    def __init__(self, k: int, dtype: torch.dtype):
        super().__init__()
        self.k = k
        in_ch = k
        for i, ch in enumerate(TNET_CHANNELS):
            self.add_module(f"mlp_{i}", Dense(in_ch, ch, dtype))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch, dtype))
            in_ch = ch
        self.fc_0 = Dense(in_ch, 128, dtype)
        self.fc_mat = Dense(128, k * k, dtype)

    def forward(self, pts, point_mask):
        x = pts
        for i in range(len(TNET_CHANNELS)):
            x = getattr(self, f"mlp_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, point_mask))
        g = torch.relu(self.fc_0(masked_max(x, point_mask[..., None],
                                            dim=-2)))
        mat = self.fc_mat(g)
        eye = torch.eye(self.k, dtype=mat.dtype, device=mat.device)
        return (mat + eye.reshape(-1)).unflatten(-1, (self.k, self.k))


class PointNet(nn.Module):
    """points [..., P, C], point_mask [..., P], det_mask [...]
    -> [..., out_dim].  With ``use_tnet`` the xyz columns are first
    multiplied by the T-Net's matrix (``tnet``)."""

    def __init__(self, cfg: PointConfig, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        if cfg.use_tnet:
            self.tnet = TNet(3, dtype)
        self.use_tnet = cfg.use_tnet
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
        if self.use_tnet:
            xyz = torch.matmul(x[..., :3], self.tnet(x[..., :3], pm))
            x = torch.cat([xyz, x[..., 3:]], dim=-1)
        for i in range(self.n_layers):
            x = getattr(self, f"mlp_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, pm))
        feat = self.proj(masked_max(x, pm[..., None], dim=-2))
        if det_mask is not None:
            feat = feat * det_mask[..., None].to(feat.dtype)
        return feat
