"""The composed tracking network: port of
``mmmot_tpu/models/tracking_net.py::TrackingNet``: the tracker's calls
(``extract``, ``affinity`` and the rest) and the training forward over
[B, T, N, ...] samples (``forward``).  The net starts in eval mode;
``net.train()`` switches its BatchNorms to masked batch statistics.

Module and parameter names follow the flax tree (``appear_net``,
``point_net``, ``fusion``, ``affinity_{fused,image,lidar}`` with their
``gnn_{r}`` rounds, ``motion``, ``new_end``, ``det_head``), so
``compat.from_jax`` maps weights across by name.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from mmmot_tpu_torch.config import ModelConfig
from mmmot_tpu_torch.device import dtype_of, resolve_device
from mmmot_tpu_torch.models.affinity import (AffinityModule, MotionScore,
                                             normalize_link)
from mmmot_tpu_torch.models.appearance import AppearanceNet
from mmmot_tpu_torch.models.fusion import FusionModule
from mmmot_tpu_torch.models.layers import MLP2
from mmmot_tpu_torch.models.new_end import NewEndHead
from mmmot_tpu_torch.models.pointnet import PointNet
from mmmot_tpu_torch.ops.masking import compact_indices, scatter_compact

# Branches with their own link scorer, in kernel order (fused first).
BRANCHES = ("fused", "image", "lidar")


class AffinityOutput(NamedTuple):
    link: torch.Tensor         # raw summed link scores [.., Np, Nc]
    link_norm: torch.Tensor    # dual-softmax normalised [.., Np, Nc]
    new: torch.Tensor          # [.., Nc]
    end: torch.Tensor          # [.., Np]


class TrackingNet(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = self.compute_dtype = dtype_of(cfg.compute_dtype)
        d = cfg.fusion.out_dim
        self.appear_net = AppearanceNet(cfg.appearance, dt, cfg.remat)
        self.point_net = PointNet(cfg.point, dt)
        self.fusion = FusionModule(cfg.fusion, cfg.appearance.out_dim,
                                   cfg.point.out_dim, dt)
        for b in BRANCHES:
            self.add_module(f"affinity_{b}", AffinityModule(
                d, cfg.affinity.hidden_dim, dt, cfg.affinity.gnn_rounds))
        if cfg.affinity.motion_dim:
            self.motion = MotionScore(cfg.affinity.motion_dim)
        self.new_end = NewEndHead(d, cfg.new_end.hidden_dim, dt)
        self.det_head = MLP2(d, cfg.new_end.hidden_dim, 1, dt)
        self.eval()
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.det_head.dense_0.weight.device

    def extract(self, crops, points, point_mask, det_mask
                ) -> Dict[str, torch.Tensor]:
        """Per-detection {"fused", "image", "lidar"} embeddings; leading
        axes are free, the last input axes are [h, w, 3] / [P, C]."""
        img = self.appear_net(crops, det_mask)
        lidar = self.point_net(points, point_mask, det_mask)
        return self.fusion(img, lidar, det_mask)

    def gnn_refine(self, feats_prev, feats_curr, mask_prev, mask_curr):
        """Each branch's embeddings after its ``gnn_rounds`` rounds of
        message passing across the pair; other keys pass through."""
        out_p, out_c = dict(feats_prev), dict(feats_curr)
        for b in BRANCHES:
            out_p[b], out_c[b] = getattr(self, f"affinity_{b}").refine(
                feats_prev[b], feats_curr[b], mask_prev, mask_curr)
        return out_p, out_c

    def motion_bias(self, box_prev, box_curr, mask_prev, mask_curr):
        """The learned motion term [.., Np, Nc] float32 (0 at invalid
        pairs): the fused kernel takes it as its ``link_bias``."""
        return self.motion(box_prev, box_curr, mask_prev, mask_curr)

    def affinity_link(self, feats_prev, feats_curr, mask_prev, mask_curr):
        """Raw link scores of the module path: each branch refined and
        scored, summed, plus the motion term (from ``feats["box"]``)
        when ``motion_dim`` > 0."""
        link = sum(getattr(self, f"affinity_{b}")(
            feats_prev[b], feats_curr[b], mask_prev, mask_curr)
            for b in BRANCHES)
        if self.cfg.affinity.motion_dim:
            link = link + self.motion_bias(
                feats_prev["box"], feats_curr["box"], mask_prev,
                mask_curr).to(link.dtype)
        return link

    def affinity(self, feats_prev, feats_curr, mask_prev, mask_curr
                 ) -> AffinityOutput:
        """The unfused module path (``TrackingNet.affinity`` of the
        reference): ``affinity_link``, the v2 heads on the RAW fused
        embeddings, dual softmax."""
        link = self.affinity_link(feats_prev, feats_curr, mask_prev,
                                  mask_curr)
        new, end = self.new_end(feats_prev["fused"], feats_curr["fused"],
                                link, mask_prev, mask_curr)
        return AffinityOutput(link, normalize_link(link, mask_prev,
                                                   mask_curr), new, end)

    def det_score(self, fused, det_mask):
        s = self.det_head(fused)[..., 0]
        return s * det_mask.to(s.dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                compact_capacity: int = 0) -> Dict[str, torch.Tensor]:
        """The training forward (``TrackingNet.__call__`` of the
        reference) over padded samples: batch crops [B, T, N, h, w, 3],
        points [B, T, N, P, 4], point_mask [B, T, N, P], det_mask [B, T,
        N] (and boxes [B, T, N, 4] with ``motion_dim`` > 0).

        Returns link, link_norm [B, T-1, N, N], new, end [B, T-1, N] of
        every adjacent frame pair (the unfused module path) and det [B,
        T, N].  ``compact_capacity`` > 0 extracts features of the first
        ``compact_capacity`` valid (b, t, n) slots only and scatters them
        back; valid slots past it are dropped, and ``kept_mask`` [B, T,
        N] (also returned) replaces det_mask everywhere after."""
        crops, points = batch["crops"], batch["points"]
        point_mask, det_mask = batch["point_mask"], batch["det_mask"]
        B, T, N = det_mask.shape
        if compact_capacity:
            total = B * T * N
            idx, taken = compact_indices(det_mask.reshape(-1),
                                         compact_capacity)

            def g(x):
                return x.reshape((total,) + x.shape[3:])[idx]

            feats_c = self.extract(g(crops), g(points), g(point_mask), taken)
            feats = {k: scatter_compact(v, idx, taken, total).reshape(
                B, T, N, -1) for k, v in feats_c.items()}
            kept = torch.zeros(total, dtype=torch.bool,
                               device=det_mask.device)
            kept[idx] = taken
            det_mask = kept.reshape(B, T, N)
        else:
            feats = self.extract(crops, points, point_mask, det_mask)
        if self.cfg.affinity.motion_dim:
            if "boxes" not in batch:
                raise ValueError(
                    "affinity.motion_dim > 0: training batches must carry "
                    "'boxes' [B, T, N, 4] detection boxes (pixel l,t,r,b)")
            feats = dict(feats, box=batch["boxes"].float())
        outs = [self.affinity({k: v[:, t] for k, v in feats.items()},
                              {k: v[:, t + 1] for k, v in feats.items()},
                              det_mask[:, t], det_mask[:, t + 1])
                for t in range(T - 1)]
        out = {k: torch.stack([getattr(o, k) for o in outs], dim=1)
               for k in AffinityOutput._fields}
        out["det"] = self.det_score(feats["fused"], det_mask)
        if compact_capacity:
            out["kept_mask"] = det_mask
        return out


def init_random_(net: TrackingNet, seed: int) -> TrackingNet:
    """Seeded random weights (He-normal kernels, small biases, BatchNorm
    near identity), drawn on the CPU so every device gets the same
    values."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() >= 2:
                fan_in = t[0].numel()
                v = torch.randn(t.shape, generator=gen) * (2.0 / fan_in) ** 0.5
            elif leaf == "running_var":
                v = 0.5 + torch.rand(t.shape, generator=gen)
            elif leaf == "weight":                       # BN scale
                v = 0.8 + 0.4 * torch.rand(t.shape, generator=gen)
            else:                                        # biases, means
                v = 0.1 * torch.randn(t.shape, generator=gen)
            t.copy_(v)
    return net
