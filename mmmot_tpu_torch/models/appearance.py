"""Image branch: VGG-bn trunk with skip pooling, port of
``mmmot_tpu/models/appearance.py`` (``trunk_ops``, ``VGGBackbone``,
``AppearanceNet``) without the space-to-depth stem.

Crops arrive as [..., h, w, 3] like the reference; the permute to NCHW is
a view with channels-last strides, which cuDNN runs directly.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from mmmot_tpu_torch.config import AppearanceConfig
from mmmot_tpu_torch.models.layers import Conv3x3, Dense, MaskedBatchNorm

VGG_PLANS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def trunk_ops(depth: int):
    """("conv", i, ch) | ("pool",) | ("stage",) in execution order; a stage
    boundary follows every 2x2 max-pool."""
    ops, conv_i = [], 0
    for item in VGG_PLANS[depth]:
        if item == "M":
            ops += [("pool",), ("stage",)]
        else:
            ops.append(("conv", conv_i, item))
            conv_i += 1
    return tuple(ops)


class VGGBackbone(nn.Module):
    def __init__(self, depth: int, width_mult: float, dtype: torch.dtype):
        super().__init__()
        self.ops = trunk_ops(depth)
        self.channels = []
        in_ch = 3
        for op in self.ops:
            if op[0] != "conv":
                continue
            _, i, item = op
            ch = max(8, int(item * width_mult))
            self.add_module(f"conv_{i}", Conv3x3(in_ch, ch, dtype))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch, dtype, dim=1))
            in_ch = ch
            self.channels.append(ch)

    def forward(self, x):
        """x [n, C, H, W] -> feature map after every pooling stage."""
        stages = []
        for op in self.ops:
            if op[0] == "pool":
                x = F.max_pool2d(x, 2)
            elif op[0] == "stage":
                stages.append(x)
            else:
                i = op[1]
                x = getattr(self, f"conv_{i}")(x)
                x = torch.relu(getattr(self, f"bn_{i}")(x))
        return stages


class AppearanceNet(nn.Module):
    """crops [..., h, w, 3] (+ slot mask [...]) -> embeddings [..., out]."""

    def __init__(self, cfg: AppearanceConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.backbone = VGGBackbone(cfg.depth, cfg.width_mult, dtype)
        # Stage widths are the widths of the last conv before each pool.
        stage_ch, ch = [], None
        for op in self.backbone.ops:
            if op[0] == "conv":
                ch = self.backbone.channels[op[1]]
            elif op[0] == "stage":
                stage_ch.append(ch)
        # Skip pooling over the last three stages (conv3/4/5).
        picked = stage_ch[-3:]
        for i, c in enumerate(picked):
            self.add_module(f"reduce_{i}", Dense(c, cfg.reduction_dim, dtype))
            self.add_module(f"reduce_bn_{i}",
                            MaskedBatchNorm(cfg.reduction_dim, dtype))
        self.n_picked = len(picked)
        self.proj = Dense(cfg.reduction_dim * len(picked), cfg.out_dim, dtype)

    def forward(self, crops, mask=None):
        lead = crops.shape[:-3]
        h, w, c = crops.shape[-3:]
        x = crops.reshape(-1, h, w, c).to(self.compute_dtype)
        stages = self.backbone(x.permute(0, 3, 1, 2))
        pooled = []
        for i, s in enumerate(stages[-self.n_picked:]):
            p = s.amax(dim=(2, 3))                       # global max pool
            p = getattr(self, f"reduce_{i}")(p)
            p = torch.relu(getattr(self, f"reduce_bn_{i}")(p))
            pooled.append(p)
        feat = self.proj(torch.cat(pooled, dim=-1))
        feat = feat.reshape(*lead, self.cfg.out_dim)
        if mask is not None:
            feat = feat * mask[..., None].to(feat.dtype)
        return feat
