"""Tracker state, and the module that binds the network and the fused
affinity: port of
``mmmot_tpu/tracker/tracker.py`` (``TrackerState``, ``init_state``,
``TrackingModule``) for the plain
branch: no gates, revival, motion or det-score rejection.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.kernels.affinity import (build_affinity_params,
                                              fused_affinity)
from mmmot_tpu_torch.models.tracking_net import (BRANCHES, AffinityOutput,
                                                 TrackingNet)


@dataclass
class TrackerState:
    """Track registry before a frame (M slots): the previous frame's
    per-branch embeddings {name: [M, D]}, its mask [M] bool (slots that
    hold matchable tracks), its track ids [M] int32 (-1 = empty), the
    frames since each track was born [M] int32 and the next fresh id
    (0-dim int32).  A sequence starts from the empty ``init_state`` and a
    window from the state the previous window returned.  A batch of S
    sequences carries a leading [S] axis on every field."""

    feats: Dict[str, torch.Tensor]
    mask: torch.Tensor
    ids: torch.Tensor
    ages: torch.Tensor
    next_id: torch.Tensor


def init_state(feat_dims: Dict[str, int], num_slots: int,
               dtype=torch.float32, device="cuda") -> TrackerState:
    """The empty registry of ``num_slots`` slots on ``device``."""
    z = dict(device=device)
    return TrackerState(
        feats={k: torch.zeros((num_slots, d), dtype=dtype, **z)
               for k, d in feat_dims.items()},
        mask=torch.zeros((num_slots,), dtype=torch.bool, **z),
        ids=torch.full((num_slots,), -1, dtype=torch.int32, **z),
        ages=torch.zeros((num_slots,), dtype=torch.int32, **z),
        next_id=torch.zeros((), dtype=torch.int32, **z))


def stack_states(states) -> TrackerState:
    """S per-sequence states -> one state with a leading [S] axis."""
    s0 = states[0]
    return TrackerState(
        feats={k: torch.stack([s.feats[k] for s in states])
               for k in s0.feats},
        mask=torch.stack([s.mask for s in states]),
        ids=torch.stack([s.ids for s in states]),
        ages=torch.stack([s.ages for s in states]),
        next_id=torch.stack([s.next_id for s in states]))


class TrackingModule:
    """A ``TrackingNet`` with its fused affinity.

    The affinity runs through ``fused_affinity``: the CUDA kernel for
    tensors on the GPU, its plain version on the CPU.  With
    ``compute_dtype`` float32 every call runs with TF32 off (float32
    parity mode).  The kernel's parameters are packed from the net's
    weights at the first affinity call: load weights before it.
    """

    def __init__(self, net: TrackingNet):
        self.net = net
        self.parity = net.compute_dtype == torch.float32
        self._params = None

    @property
    def device(self) -> torch.device:
        return self.net.device

    def affinity_params(self) -> Dict[str, torch.Tensor]:
        """Kernel parameters, packed once from the net's weights."""
        if self._params is None:
            self._params = build_affinity_params(self.net,
                                                 self.net.compute_dtype)
        return self._params

    def init_state(self, num_slots: int) -> TrackerState:
        """Empty state whose feats match what ``extract`` produces
        (``TrackingModule.init_state`` of the reference)."""
        c = self.net.cfg
        dims = {"fused": c.fusion.out_dim, "image": c.appearance.out_dim,
                "lidar": c.point.out_dim}
        return init_state(dims, num_slots, device=self.device)

    def extract(self, crops, points, point_mask, det_mask):
        with torch.inference_mode(), f32_parity(self.parity):
            return self.net.extract(crops, points, point_mask, det_mask)

    def affinity(self, feats_prev, feats_curr, mask_prev, mask_curr
                 ) -> AffinityOutput:
        """Batched frame pairs: feats {branch: [B, N, D]}, masks [B, N]."""
        with torch.inference_mode(), f32_parity(self.parity):
            cdt = self.net.compute_dtype
            a = torch.stack([feats_prev[b].to(cdt) for b in BRANCHES], dim=1)
            b = torch.stack([feats_curr[b].to(cdt) for b in BRANCHES], dim=1)
            return fused_affinity(a.contiguous(), b.contiguous(),
                                  mask_prev.contiguous(),
                                  mask_curr.contiguous(),
                                  self.affinity_params())

    def det_score(self, fused, det_mask):
        with torch.inference_mode(), f32_parity(self.parity):
            return self.net.det_score(fused, det_mask)
