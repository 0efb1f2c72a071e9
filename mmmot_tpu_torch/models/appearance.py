"""Image branch: VGG trunk with skip pooling, port of
``mmmot_tpu/models/appearance.py`` (``space_to_depth``, ``trunk_ops``,
``VGGBackbone``, ``AppearanceNet``): with or without BatchNorm, skip
pooling over the last three stages or the last stage alone, DropBlock
on the stage maps in training, and the space-to-depth stem.

Crops arrive as [..., h, w, 3] like the reference; the permute to NCHW is
a view with channels-last strides, which cuDNN runs directly.  In train
mode every BatchNorm takes the flat per-crop mask, and with ``remat``
each stage of the VGG trunk runs under ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from mmmot_tpu_torch.config import AppearanceConfig
from mmmot_tpu_torch.models.layers import (Conv3x3, Dense, DropBlock2D,
                                           MaskedBatchNorm)

VGG_PLANS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
         512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


def space_to_depth(x, block: int = 2):
    """[..., H, W, C] -> [..., H/b, W/b, b*b*C]: channel (dy*b + dx)*C + c
    of output pixel (i, j) is channel c of input pixel (b*i + dy,
    b*j + dx) (a relayout; any dtype)."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // block, block, w // block, block, c)
    x = x.transpose(-4, -3)
    return x.reshape(*lead, h // block, w // block, block * block * c)


def trunk_ops(depth: int, s2d_stem: bool = False):
    """("s2d",) | ("conv", i, ch) | ("pool",) | ("stage",) in execution
    order; a stage boundary follows every 2x2 max-pool.  With
    ``s2d_stem`` the space-to-depth relayout comes first and replaces
    the first pool; every stage's shape is unchanged."""
    ops, conv_i = ([("s2d",)] if s2d_stem else []), 0
    first_pool = s2d_stem
    for item in VGG_PLANS[depth]:
        if item == "M":
            if not first_pool:
                ops.append(("pool",))
            first_pool = False
            ops.append(("stage",))
        else:
            ops.append(("conv", conv_i, item))
            conv_i += 1
    return tuple(ops)


class VGGBackbone(nn.Module):
    """The VGG trunk: ``conv_i`` (and with ``batch_norm`` ``bn_i``) per
    conv; with ``s2d_stem`` conv_0 takes the 12 channels of the
    space-to-depth crops.  With ``remat``, in train mode with gradients
    on, each stage runs under ``torch.utils.checkpoint``: only the
    stage boundaries are kept for the backward pass, and a stage's
    activations are recomputed when its backward runs (with the running
    statistics frozen, so that they move once a step)."""

    def __init__(self, depth: int, width_mult: float, dtype: torch.dtype,
                 remat: bool = False, batch_norm: bool = True,
                 s2d_stem: bool = False):
        super().__init__()
        self.ops = trunk_ops(depth, s2d_stem)
        self.remat = remat
        self.batch_norm = batch_norm
        self.channels = []
        in_ch = 12 if s2d_stem else 3
        for op in self.ops:
            if op[0] != "conv":
                continue
            _, i, item = op
            ch = max(8, int(item * width_mult))
            self.add_module(f"conv_{i}", Conv3x3(in_ch, ch, dtype))
            if batch_norm:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch, dtype, dim=1))
            in_ch = ch
            self.channels.append(ch)

    def forward(self, x, mask=None):
        """x [n, C, H, W] (+ mask [n], read in train mode) -> feature map
        after every pooling stage."""
        stages, segment = [], []
        for op in self.ops:
            if op[0] != "stage":
                segment.append(op)
                continue
            if self.remat and self.training and torch.is_grad_enabled():
                x = checkpoint(self._segment, segment, x, mask,
                               use_reentrant=False,
                               context_fn=lambda: (contextlib.nullcontext(),
                                                   self.frozen_stats()))
            else:
                x = self._segment(segment, x, mask)
            stages.append(x)
            segment = []
        return stages

    def _segment(self, ops, x, mask):
        for op in ops:
            if op[0] == "s2d":
                x = space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            elif op[0] == "pool":
                x = F.max_pool2d(x, 2)
            else:
                i = op[1]
                x = getattr(self, f"conv_{i}")(x)
                if self.batch_norm:
                    x = getattr(self, f"bn_{i}")(x, mask)
                x = torch.relu(x)
        return x

    @contextlib.contextmanager
    def frozen_stats(self):
        """The BatchNorms keep their running statistics while inside (the
        recomputation of a checkpointed forward)."""
        bns = [m for m in self.modules() if isinstance(m, MaskedBatchNorm)]
        for bn in bns:
            bn.freeze_stats = True
        try:
            yield
        finally:
            for bn in bns:
                bn.freeze_stats = False


class AppearanceNet(nn.Module):
    """crops [..., h, w, 3] (+ slot mask [...]) -> embeddings [..., out].

    With ``cfg.dropblock`` every stage map passes a ``DropBlock2D``
    (``dropblock_{i}``; the identity in eval mode) before the pick: the
    last three stages with ``skip_pool``, else the last one."""

    def __init__(self, cfg: AppearanceConfig, dtype: torch.dtype,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.backbone = VGGBackbone(cfg.depth, cfg.width_mult, dtype, remat,
                                    cfg.batch_norm, cfg.s2d_stem)
        # Stage widths are the widths of the last conv before each pool.
        stage_ch, ch = [], None
        for op in self.backbone.ops:
            if op[0] == "conv":
                ch = self.backbone.channels[op[1]]
            elif op[0] == "stage":
                stage_ch.append(ch)
        if cfg.dropblock:
            for i in range(len(stage_ch)):
                self.add_module(f"dropblock_{i}", DropBlock2D(
                    cfg.dropblock_rate, cfg.dropblock_size))
        # Skip pooling over the last three stages (conv3/4/5), or the last.
        picked = stage_ch[-3:] if cfg.skip_pool else stage_ch[-1:]
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
        flat_mask = None if mask is None else mask.reshape(-1)
        stages = self.backbone(x.permute(0, 3, 1, 2), flat_mask)
        if self.cfg.dropblock:
            stages = [getattr(self, f"dropblock_{i}")(s)
                      for i, s in enumerate(stages)]
        pooled = []
        for i, s in enumerate(stages[-self.n_picked:]):
            p = s.amax(dim=(2, 3))                       # global max pool
            p = getattr(self, f"reduce_{i}")(p)
            p = torch.relu(getattr(self, f"reduce_bn_{i}")(p, flat_mask))
            pooled.append(p)
        feat = self.proj(torch.cat(pooled, dim=-1))
        feat = feat.reshape(*lead, self.cfg.out_dim)
        if mask is not None:
            feat = feat * mask[..., None].to(feat.dtype)
        return feat
