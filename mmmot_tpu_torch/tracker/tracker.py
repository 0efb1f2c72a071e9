"""Tracker state, the association gates, and the module that binds the
network, the fused affinity and the association: port of
``mmmot_tpu/tracker/tracker.py`` (``TrackerState``, ``init_state``,
``apply_spatial_gate``, ``assign_ids``, ``TrackingModule`` with
``step_from_feats`` and ``_revival_state``).

The flagship path (``TrackingModule(net)``) runs the parallel pre-solve
of ``tracker/sequence.py``.  An ``AssocConfig`` adds the quality stack:
y_det detection rejection in the LP, the spatial IoU gate and prior, the
revival ghost pool with its coverage boxes and ``gate_predict``.  Not
ported: the class gate (joint classes) and learned motion.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from mmmot_tpu_torch.assoc.cost import NEG, Decisions
from mmmot_tpu_torch.assoc.solve import associate
from mmmot_tpu_torch.config import AssocConfig
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.kernels.affinity import (build_affinity_params,
                                              fused_affinity)
from mmmot_tpu_torch.models.affinity import normalize_link
from mmmot_tpu_torch.models.layers import fma, sigmoid
from mmmot_tpu_torch.models.tracking_net import (BRANCHES, AffinityOutput,
                                                 TrackingNet)
from mmmot_tpu_torch.ops.boxes import pairwise_iou

# Per-slot feats that stay float32 whatever the compute dtype: bf16
# rounds KITTI pixel coordinates (~1e3) by up to 4 px; "detsc" is the
# frozen coverage score, compared against coverage_min_score.
F32_FEATS = ("box", "boxvel", "detsc")


@dataclass
class TrackerState:
    """Track registry before a frame (M slots): the per-slot feats
    {name: [M, D]} (branch embeddings, and the boxes, velocities and
    det-head logits the quality stack carries), the mask [M] bool (slots
    that hold matchable tracks: live detections, and ghosts when
    ``revival_window`` > 0), the track ids [M] int32 (-1 = empty), the
    frames since each track was born [M] int32, the next fresh id (0-dim
    int32) and, with revival, the frames since each slot last matched
    [M] int32 (0 = live; None otherwise).  M is the detection slot
    count N, or 2N with revival (N live + N ghost slots).  A sequence
    starts from the empty ``init_state`` and a window from the state the
    previous window returned.  A batch of S sequences carries a leading
    [S] axis on every field."""

    feats: Dict[str, torch.Tensor]
    mask: torch.Tensor
    ids: torch.Tensor
    ages: torch.Tensor
    next_id: torch.Tensor
    missed: Optional[torch.Tensor] = None


def init_state(feat_dims: Dict[str, int], num_slots: int,
               dtype=torch.float32, device="cuda",
               with_missed: bool = False) -> TrackerState:
    """The empty registry of ``num_slots`` slots on ``device``;
    ``with_missed`` adds the revival counters."""
    z = dict(device=device)
    return TrackerState(
        feats={k: torch.zeros((num_slots, d), dtype=torch.float32
                              if k in F32_FEATS else dtype, **z)
               for k, d in feat_dims.items()},
        mask=torch.zeros((num_slots,), dtype=torch.bool, **z),
        ids=torch.full((num_slots,), -1, dtype=torch.int32, **z),
        ages=torch.zeros((num_slots,), dtype=torch.int32, **z),
        next_id=torch.zeros((), dtype=torch.int32, **z),
        missed=(torch.zeros((num_slots,), dtype=torch.int32, **z)
                if with_missed else None))


def stack_states(states) -> TrackerState:
    """S per-sequence states -> one state with a leading [S] axis."""
    s0 = states[0]
    return TrackerState(
        feats={k: torch.stack([s.feats[k] for s in states])
               for k in s0.feats},
        mask=torch.stack([s.mask for s in states]),
        ids=torch.stack([s.ids for s in states]),
        ages=torch.stack([s.ages for s in states]),
        next_id=torch.stack([s.next_id for s in states]),
        missed=(None if s0.missed is None
                else torch.stack([s.missed for s in states])))


def apply_spatial_gate(link, box_prev, box_curr, cfg: AssocConfig):
    """The spatial prior on the link scores: ``iou_weight`` adds a soft
    IoU bonus, ``iou_gate`` forbids pairs below the IoU floor with the
    assoc ``NEG`` sentinel (rounded to the link's dtype, as the solver
    compares it).  Boxes are (l, t, r, b); empty slots carry zero boxes
    and are excluded by the solver's masks anyway.

    In float32, for a weight whose product with the IoU rounds (not 0,
    0.5 or 1), the reference's compiled ``link + w * iou`` rounds once
    or twice depending on how XLA fuses it; here it rounds twice."""
    iou = pairwise_iou(box_prev.float(), box_curr.float())
    dt = link.dtype
    if cfg.iou_weight:
        link = link + torch.tensor(cfg.iou_weight, dtype=dt,
                                   device=link.device) * iou.to(dt)
    if cfg.iou_gate > 0.0:
        link = torch.where(iou >= cfg.iou_gate, link,
                           torch.tensor(NEG, dtype=dt, device=link.device))
    return link


def gather_slots(x, idx):
    """x [..., M, *F] at slot indices idx [..., K] -> [..., K, *F] (the
    leading axes of the two agree)."""
    idx = idx.long()
    a = idx.dim() - 1
    tail = x.shape[a + 1:]
    return torch.gather(x, a, idx.reshape(idx.shape + (1,) * len(tail))
                        .expand(idx.shape + tail))


def inherit_ids(ids_prev, next_id, match_curr, is_new, det_mask):
    """Ids for the current detections [S, N]: a linked detection inherits
    the id of its match among ``ids_prev``, a new one takes the next
    fresh id (in slot order), empty slots get -1.  Returns (ids [S, N]
    int32, next_id [S] int32)."""
    linked = match_curr >= 0
    inherited = torch.where(
        linked, gather_slots(ids_prev, match_curr.clamp_min(0)), -1)
    order = torch.cumsum(is_new.to(torch.int32), -1) - 1
    ids = torch.where(is_new, next_id[..., None] + order, inherited)
    ids = torch.where(det_mask, ids, -1).to(torch.int32)
    return ids, (next_id + is_new.sum(-1)).to(torch.int32)


def assign_ids(state: TrackerState, dec: Decisions, det_mask
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``inherit_ids`` against the state's ids (the reference's
    bookkeeping as a function of the decisions)."""
    return inherit_ids(state.ids, state.next_id, dec.match_curr,
                       dec.is_new, det_mask)


def matched_ages(ages_prev, match_curr, kept):
    """Ages [S, N] int32: a kept detection is one frame older than its
    match (a new one is 1); other slots are 0."""
    age = torch.where(match_curr >= 0,
                      gather_slots(ages_prev, match_curr.clamp_min(0)), 0)
    return torch.where(kept, age + 1, 0).to(torch.int32)


def select_ghosts(survive, missed, K: int, G: int):
    """Freshest-first stable choice of up to G surviving slots [S, M]:
    the scores ``(K + 1 - missed) * (M + 1) - slot`` are unique, so
    ``topk`` gives the reference's ``lax.top_k`` order.  Returns (gidx
    [S, G] int64, gtaken [S, G] bool)."""
    M = survive.shape[-1]
    iota = torch.arange(M, device=survive.device)
    score = torch.where(survive, K + 1 - missed.long(), 0) * (M + 1) - iota
    gidx = torch.topk(score, G, dim=-1, sorted=True).indices
    return gidx, torch.gather(survive, 1, gidx)


def link_velocity(box_curr, box_prev, match_curr):
    """Each track's velocity from its last link [S, N, 4] (f32): the
    current box minus its match's; new and unlinked detections get 0."""
    prev = gather_slots(box_prev, match_curr.clamp_min(0))
    return torch.where((match_curr >= 0)[..., None], box_curr - prev,
                       0.0).float()


def predicted_boxes(box, missed, vel):
    """Constant-velocity boxes ``box + missed * vel`` (f32), rounded once
    as the reference's compiled multiply-add."""
    return fma(missed[..., None].float(), vel, box)


class TrackingModule:
    """A ``TrackingNet`` with its fused affinity and its association.

    The affinity runs through ``fused_affinity``: the CUDA kernel for
    tensors on the GPU, its plain version on the CPU.  With
    ``compute_dtype`` float32 every call runs with TF32 off (float32
    parity mode).  The kernel's parameters are packed from the net's
    weights at the first affinity call: load weights before it.

    ``assoc_cfg`` (default ``AssocConfig()``) picks the association.
    ``parallel_assoc`` and ``hybrid_presolve`` pick the execution
    strategy of ``tracker/sequence.py`` as the reference does (None =
    auto): the parallel pre-solve when decisions do not feed the state,
    else the hybrid pre-solves, else the sequential ``step_from_feats``
    scan, their equality oracle.
    """

    def __init__(self, net: TrackingNet,
                 assoc_cfg: Optional[AssocConfig] = None,
                 parallel_assoc: Optional[bool] = None,
                 hybrid_presolve: Optional[bool] = None):
        self.net = net
        self.parity = net.compute_dtype == torch.float32
        self._params = None
        cfg = self.assoc_cfg = assoc_cfg or AssocConfig()
        if cfg.class_gate:
            raise NotImplementedError(
                "assoc.class_gate (joint classes) is not ported to "
                "mmmot_tpu_torch yet")
        # The parallel pre-solve batches every frame pair's LP, which is
        # sound only while decisions never feed the next pair: y_det
        # rejection shrinks the carried mask and revival keeps ghosts.
        if parallel_assoc is None:
            parallel_assoc = (not cfg.use_det_scores
                              and not cfg.revival_window)
        if parallel_assoc and cfg.use_det_scores:
            raise ValueError("parallel_assoc is unsound with "
                             "use_det_scores (decision-dependent state)")
        if parallel_assoc and cfg.revival_window:
            raise ValueError("parallel_assoc is unsound with "
                             "revival_window (decision-dependent "
                             "ghost pool); hybrid_presolve covers it")
        if cfg.ghost_coverage and not cfg.revival_window:
            raise ValueError("ghost_coverage emits boxes for GHOST slots; "
                             "it needs revival_window > 0")
        self.parallel_assoc = parallel_assoc
        # The hybrid pre-solves batch the mask-independent link scores
        # and keep the mask-dependent rest in the scan.  The port has no
        # GNN refine, so they are always sound.
        self.hybrid_presolve = (True if hybrid_presolve is None
                                else hybrid_presolve)

    @property
    def device(self) -> torch.device:
        return self.net.device

    @property
    def spatial_gating(self) -> bool:
        """Whether the IoU gate or prior is configured (the pipeline then
        carries per-detection boxes, ``feats["box"]``)."""
        return (self.assoc_cfg.iou_gate > 0.0
                or self.assoc_cfg.iou_weight != 0.0)

    @property
    def ghost_coverage(self) -> bool:
        """Whether ghost slots emit extrapolated coverage boxes."""
        return bool(self.assoc_cfg.ghost_coverage
                    and self.assoc_cfg.revival_window)

    @property
    def carry_boxes(self) -> bool:
        """Whether the pipeline carries per-detection boxes: the spatial
        gate reads them and ghost coverage extrapolates them."""
        return self.spatial_gating or self.ghost_coverage

    @property
    def carry_det_logits(self) -> bool:
        """Whether each slot carries its det-head logit (``feats
        ["detlogit"]``, frozen with a ghost), which the y_det LP reads on
        the previous side.  The reference recomputes those logits from
        the carried embeddings; carrying the logit computed once per
        window gives every execution strategy bit-identical values on
        every device, as the frozen coverage score ``detsc`` does in
        both."""
        return self.assoc_cfg.use_det_scores

    def affinity_params(self) -> Dict[str, torch.Tensor]:
        """Kernel parameters, packed once from the net's weights."""
        if self._params is None:
            self._params = build_affinity_params(self.net,
                                                 self.net.compute_dtype)
        return self._params

    def make_state0(self, feat_dims: Dict[str, int],
                    num_dets: int) -> TrackerState:
        """Empty state of ``num_dets`` slots, doubled to hold the ghost
        pool (with the ``missed`` counters) when ``revival_window`` > 0."""
        if self.assoc_cfg.revival_window:
            return init_state(feat_dims, 2 * num_dets, device=self.device,
                              with_missed=True)
        return init_state(feat_dims, num_dets, device=self.device)

    def init_state(self, num_slots: int) -> TrackerState:
        """Empty state whose feats match what the tracking path carries
        (``TrackingModule.init_state`` of the reference)."""
        c = self.net.cfg
        dims = {"fused": c.fusion.out_dim, "image": c.appearance.out_dim,
                "lidar": c.point.out_dim}
        if self.carry_boxes:
            dims["box"] = 4
        if self.ghost_coverage:
            dims["boxvel"] = 4
            dims["detsc"] = 1
        if self.carry_det_logits:
            dims["detlogit"] = 1
        return self.make_state0(dims, num_slots)

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

    def affinity_link(self, feats_prev, feats_curr, mask_prev, mask_curr):
        """Raw link scores [B, N, N] only (exactly 0 at invalid pairs), for
        the hybrid pre-solves and the sequential scan: the fused kernel's
        ``link`` output on the GPU, the plain version's on the CPU.  The
        normalisation and the new/end heads are derived from it with the
        exact carried masks."""
        return self.affinity(feats_prev, feats_curr, mask_prev,
                             mask_curr).link

    def det_score(self, fused, det_mask):
        """Det-head logits [..., N], 0 at invalid slots."""
        with torch.inference_mode(), f32_parity(self.parity):
            return self.net.det_score(fused, det_mask)

    def new_end(self, feat_prev, feat_curr, link, mask_prev, mask_curr):
        """The v2 new/end logits from a raw (masked) link."""
        with torch.inference_mode(), f32_parity(self.parity):
            return self.net.new_end(feat_prev, feat_curr, link, mask_prev,
                                    mask_curr)

    def frame_decisions(self, link, fp_fused, fc_fused, mask_prev,
                        mask_curr, det_prev, det_curr, box_prev=None,
                        box_curr=None) -> Decisions:
        """One frame's association from its raw link [S, Mp, Mc]: the
        normalisation, the spatial gate, the new/end heads and the LP.
        ``det_prev``/``det_curr`` are the det-head logits of the two sides
        (read only with ``use_det_scores``).  Shared by the sequential
        scan and the hybrid pre-solves."""
        cfg = self.assoc_cfg
        with torch.inference_mode():
            link_norm = normalize_link(link, mask_prev, mask_curr)
            if self.spatial_gating:
                link_norm = apply_spatial_gate(link_norm, box_prev,
                                               box_curr, cfg)
            new, end = self.new_end(fp_fused, fc_fused, link, mask_prev,
                                    mask_curr)
            if not cfg.raw_new_end:
                new, end = sigmoid(new), sigmoid(end)
            if not cfg.use_det_scores:
                return associate(link_norm, new, end, mask_prev, mask_curr,
                                 cfg)
            w = cfg.det_score_weight
            dt = link.dtype
            return associate(link_norm, new, end, mask_prev, mask_curr, cfg,
                             det_prev=w * det_prev.to(dt),
                             det_curr=w * det_curr.to(dt))

    def step_from_feats(self, state: TrackerState,
                        feats: Dict[str, torch.Tensor], det_mask
                        ) -> Tuple[TrackerState, Dict[str, torch.Tensor]]:
        """Associate one frame's features {k: [S, N, D]} (det_mask
        [S, N]) against the state: the per-frame sequential scan.

        With ``revival_window`` K > 0 the state carries a ghost pool
        (M = 2N slots): unmatched tracks stay matchable for up to K
        frames, and a later detection that matches a ghost revives its
        id.  Per-detection outputs (``ids``, ``det_score``) have the N
        input slots; ``decisions`` spans the M padded slots.

        The raw link comes from the fused kernel and the rest from
        ``frame_decisions``, as in the pre-solves, so the scan is their
        exact oracle on every device: the reference's XLA-path scan
        computes the same function (its Pallas-path scan takes the
        kernel's own normalisation and heads, which round differently
        in bfloat16).
        """
        cfg = self.assoc_cfg
        K = cfg.revival_window
        n_in = det_mask.shape[-1]
        with torch.inference_mode():
            if K:
                pad = state.mask.shape[-1] - n_in
                feats = {k: torch.nn.functional.pad(v, (0, 0, 0, pad))
                         for k, v in feats.items()}
                det_mask = torch.nn.functional.pad(det_mask, (0, pad))
            if self.carry_boxes and "box" not in feats:
                raise ValueError(
                    "the spatial gate and ghost coverage need per-detection "
                    "boxes: carry them as feats['box'] (the raw-frames "
                    "pipeline does)")
            link = self.affinity_link(state.feats, feats, state.mask,
                                      det_mask)
            if "detlogit" in feats:
                dl_curr = feats["detlogit"][..., 0]
            else:
                dl_curr = self.det_score(feats["fused"], det_mask)
                if self.carry_det_logits:
                    feats = dict(feats, detlogit=dl_curr[..., None])
            if self.ghost_coverage and "detsc" not in feats:
                feats = dict(feats, detsc=coverage_score(dl_curr))
            dl_prev = None
            if cfg.use_det_scores:
                dl_prev = (state.feats["detlogit"][..., 0]
                           if "detlogit" in state.feats else
                           self.det_score(state.feats["fused"], state.mask))
            gate_prev = state.feats.get("box")
            if self.spatial_gating and cfg.gate_predict:
                # A slot frozen at its last match, missed m frames, is
                # m + 1 frames behind the current frame.
                gate_prev = predicted_boxes(gate_prev, state.missed + 1,
                                            state.feats["boxvel"])
            dec = self.frame_decisions(
                link, state.feats["fused"], feats["fused"], state.mask,
                det_mask, dl_prev, dl_curr, gate_prev, feats.get("box"))
            kept = det_mask & dec.keep_curr if cfg.use_det_scores \
                else det_mask
            ids_curr, next_id = assign_ids(state, dec, det_mask)
            ages_curr = matched_ages(state.ages, dec.match_curr, kept)
            if self.ghost_coverage:
                feats = dict(feats, boxvel=link_velocity(
                    feats["box"], state.feats["box"], dec.match_curr))
            if K:
                new_state = self._revival_state(
                    state, feats, kept, ids_curr, ages_curr, next_id, dec,
                    n_in)
            else:
                new_state = TrackerState(feats=feats, mask=kept,
                                         ids=ids_curr, ages=ages_curr,
                                         next_id=next_id,
                                         missed=state.missed)
            out = {"ids": ids_curr[..., :n_in], "decisions": dec,
                   "det_score": sigmoid(dl_curr)[..., :n_in], "link": link}
            if self.ghost_coverage:
                out.update(coverage_rows(new_state, n_in, cfg))
        return new_state, out

    def _revival_state(self, state: TrackerState, feats, kept, ids_curr,
                       ages_curr, next_id, dec: Decisions,
                       n_in: int) -> TrackerState:
        """The next state with a ghost pool: slots 0..N-1 hold this
        frame's detections, slots N..M-1 up to G = M - N ghosts, the
        tracks that were matchable, went unmatched now and have missed at
        most K frames, freshest first.  A ghost keeps its frozen feats,
        id and age, so a later match inherits the original id."""
        K = self.assoc_cfg.revival_window
        G = state.mask.shape[-1] - n_in
        survive = state.mask & (dec.match_prev < 0) & (state.missed + 1 <= K)
        gidx, gtaken = select_ghosts(survive, state.missed, K, G)
        return TrackerState(
            feats={k: torch.cat([v[:, :n_in],
                                 gather_slots(state.feats[k], gidx)], 1)
                   for k, v in feats.items()},
            mask=torch.cat([kept[:, :n_in], gtaken], 1),
            ids=torch.cat([ids_curr[:, :n_in], torch.where(
                gtaken, gather_slots(state.ids, gidx), -1)
                .to(torch.int32)], 1),
            ages=torch.cat([ages_curr[:, :n_in],
                            gather_slots(state.ages, gidx)], 1),
            next_id=next_id,
            missed=torch.cat([torch.zeros_like(state.missed[:, :n_in]),
                              torch.where(gtaken, gather_slots(
                                  state.missed, gidx) + 1, 0)
                              .to(torch.int32)], 1))


def coverage_score(det_logit):
    """The coverage score a ghost freezes: its detection's det-head
    confidence [..., 1] in float32.  The sequence paths compute it once
    per window, so every execution strategy freezes the same values."""
    return sigmoid(det_logit)[..., None].float()


def coverage_rows(state: TrackerState, n_in: int, cfg: AssocConfig):
    """Coverage for the tracks missing at this frame: the state's ghost
    slots (after this frame), each at its frozen box extrapolated by its
    last velocity, scored by its track's last det-head confidence.
    Emitted only for the first ``coverage_max_miss`` (0: K) missed frames
    and while that confidence is at least ``coverage_min_score``; the
    ghost stays revivable for the whole window either way."""
    gmask = state.mask[:, n_in:]
    gmiss = state.missed[:, n_in:]
    gsc = state.feats["detsc"][:, n_in:, 0]
    emit = gmask & (gmiss <= (cfg.coverage_max_miss or cfg.revival_window)) \
        & (gsc >= cfg.coverage_min_score)
    return {"ghost_ids": torch.where(emit, state.ids[:, n_in:], -1)
            .to(torch.int32),
            "ghost_scores": torch.where(emit, gsc, 0.0),
            "ghost_boxes": predicted_boxes(state.feats["box"][:, n_in:],
                                           gmiss,
                                           state.feats["boxvel"][:, n_in:])}
