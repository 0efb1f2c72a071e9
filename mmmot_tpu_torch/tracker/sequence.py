"""Whole-sequence tracking: port of ``mmmot_tpu/tracker/sequence.py``,
the crops-given ``track_sequence`` and ``track_sequence_from_frames``
(its compact-first branch and, with ``compact_capacity=None``, its
per-slot branch: whole-frame crops of every slot, no crop window, no
dropped detection) with its execution strategies (``_scan_track``:
``_parallel_track``, ``_hybrid_track``, ``_revival_track`` and the
sequential scan), and of
``track_sequences_from_frames_batched`` (the S axis).

1. The valid (frame, slot) pairs of each sequence are compacted up front,
   every sequence at one shared capacity.
2. For each compacted detection of all S sequences, in chunks: crop a
   band of its frame, resize and normalise it, sample its frustum points
   (or, with ``point_source="box3d"``, the points inside its 3D box),
   and extract features.
3. The features are scattered back to [S, T, N] slots.
4. The association (``_scan_track``).  The flagship's parallel pre-solve
   runs all S*T frame-pair affinities as one batched call (the fused
   kernel on the GPU), then one batched solve (the auction, or the
   configured Sinkhorn or greedy solver), then propagates the IDs frame
   by frame.  The quality stack's hybrid pre-solves run the raw
   link scores as one or two batched calls, then a loop over the frames
   with one batched auction over the S sequences per frame.

The reference vmaps the one-sequence function over S; here S is a batch
dimension of every tensor, which gives the same ids.  A window of a
longer sequence starts from the ``TrackerState`` the previous window
returned (``state0``/``return_state``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mmmot_tpu_torch.assoc.solve import associate
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.models.layers import sigmoid
from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_batched,
                                             crop_and_resize_gathered,
                                             normalize_crops)
from mmmot_tpu_torch.ops.frustum import box3d_sample, frustum_sample
from mmmot_tpu_torch.ops.masking import (compact_indices, pair_mask,
                                         scatter_compact)
from mmmot_tpu_torch.tracker.tracker import (
    F32_FEATS, TrackerState, TrackingModule, apply_class_gate,
    apply_spatial_gate, coverage_score, gather_slots, inherit_ids,
    link_velocity, matched_ages, predicted_boxes, select_ghosts,
    stack_states)


def _chunked(fn, args, capacity: int, chunk: Optional[int]):
    """Run ``fn`` over ``args`` (leading axis = capacity) ``chunk`` rows at
    a time and concatenate the per-key outputs; a remainder runs as one
    smaller call.  Eval-mode BatchNorm is per element, so chunking is
    exact."""
    if not chunk or capacity <= chunk:
        return fn(*args)
    outs = [fn(*(x[s:s + chunk] for x in args))
            for s in range(0, capacity, chunk)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def pair_inputs(feats: Dict[str, torch.Tensor], det_mask,
                state0: TrackerState):
    """Prev-side inputs of the T frame pairs: pair t joins frame t-1 and
    t, pair 0 joins ``state0`` (empty at a sequence start).  feats
    {branch: [..., T, N, D]}, det_mask [..., T, N]."""
    prev = {k: torch.cat([state0.feats[k].unsqueeze(-3).to(v.dtype),
                          v[..., :-1, :, :]], dim=-3)
            for k, v in feats.items()}
    return prev, torch.cat([state0.mask.unsqueeze(-2), det_mask[..., :-1, :]],
                           dim=-2)


def propagate_ids(match_curr, is_new, det_mask, state0: TrackerState):
    """Frame-by-frame ID bookkeeping over [..., T, N]: a linked detection
    inherits its match's ID and age, a new one takes the next fresh ID (in
    slot order) and age 1, empty slots get -1 and age 0.  Returns (ids
    [..., T, N] int32, the last frame's ages [..., N] int32, the next
    fresh id [...] int32)."""
    ids_prev, ages_prev, next_id = state0.ids, state0.ages, state0.next_id
    ids_all = []
    for t in range(det_mask.shape[-2]):
        match, new, dm = (x[..., t, :] for x in (match_curr, is_new,
                                                 det_mask))
        ids_prev, next_id = inherit_ids(ids_prev, next_id, match, new, dm)
        ages_prev = matched_ages(ages_prev, match, dm)
        ids_all.append(ids_prev)
    return torch.stack(ids_all, dim=-2), ages_prev, next_id


def det_logits(module: TrackingModule, feats, det_mask):
    """Det-head logits [S, T, N] of a window: carried in ``feats
    ["detlogit"]`` when the module carries them, else computed."""
    if "detlogit" in feats:
        return feats["detlogit"][..., 0]
    return module.det_score(feats["fused"], det_mask)


def _scan_track(module: TrackingModule, feats: Dict[str, torch.Tensor],
                det_mask, state0: Optional[TrackerState] = None):
    """Association and ID bookkeeping over the frames of a window.

    feats {k: [S, T, N, D]}, det_mask [S, T, N] bool, ``state0`` the
    state the previous window returned (default: empty).  Returns
    (outputs, final state).  The execution strategies give the same ids
    (tested), as the reference's do:

    * the parallel pre-solve (``module.parallel_assoc``, the flagship):
      every frame pair's affinity in one fused-kernel call and one
      batched auction, then the ID propagation;
    * the y_det hybrid pre-solve (``use_det_scores``) and the revival
      hybrid pre-solve (``revival_window`` > 0), with
      ``hybrid_presolve``: the raw link scores of every pair the scan can
      need in one or two batched fused-kernel calls with optimistic
      masks, then a loop over the frames for the mask-dependent rest;
    * the sequential scan: ``step_from_feats`` frame by frame, the
      equality oracle of the two above, and the strategy whenever the
      model has GNN rounds and decisions feed the state (the look-alike
      stack): each frame runs the GNN rounds, the motion term and one
      fused-kernel call over its pairs.

    The frames are a Python loop vectorised over S: each frame's LP is
    one batched auction over the S sequences.
    """
    S, T, N = det_mask.shape
    if ((module.carry_det_logits and "detlogit" not in feats)
            or (module.ghost_coverage and "detsc" not in feats)):
        # One batched det-head call for the whole window, so that every
        # strategy reads (and freezes into ghosts) the same logits and
        # coverage scores.
        dl = det_logits(module, feats, det_mask)
        if module.carry_det_logits:
            feats = dict(feats, detlogit=dl[..., None])
        if module.ghost_coverage:
            feats = dict(feats, detsc=coverage_score(dl))
    if state0 is None:
        # The registry of what this window carries (2N slots and the
        # missed counters with revival).
        dims = {k: v.shape[-1] for k, v in feats.items()}
        if module.ghost_coverage:
            dims["boxvel"] = 4
        state0 = stack_states([module.make_state0(dims, N)
                               for _ in range(S)])
    cdt = feats["fused"].dtype
    state0 = dataclasses.replace(state0, feats={
        k: v if k in F32_FEATS else v.to(cdt)
        for k, v in state0.feats.items()})
    with torch.inference_mode():
        if module.parallel_assoc:
            return _parallel_track(module, feats, det_mask, state0)
        if module.hybrid_presolve and module.assoc_cfg.revival_window:
            return _revival_track(module, feats, det_mask, state0)
        if module.hybrid_presolve and module.assoc_cfg.use_det_scores:
            return _hybrid_track(module, feats, det_mask, state0)
        return _sequential_track(module, feats, det_mask, state0)


def _stack_outputs(outs, keys):
    return {k: torch.stack([o[k] for o in outs], dim=1) for k in keys}


def _output_keys(module: TrackingModule):
    keys = ("ids", "det_score")
    if module.ghost_coverage:
        keys += ("ghost_ids", "ghost_boxes", "ghost_scores")
    return keys


def _sequential_track(module: TrackingModule, feats, det_mask, state0):
    """``step_from_feats`` frame by frame."""
    state, outs = state0, []
    for t in range(det_mask.shape[1]):
        state, out = module.step_from_feats(
            state, {k: v[:, t] for k, v in feats.items()}, det_mask[:, t])
        outs.append(out)
    return _stack_outputs(outs, _output_keys(module)), state


def _parallel_track(module: TrackingModule, feats: Dict[str, torch.Tensor],
                    det_mask, state0: TrackerState):
    """All frame-pair affinities (every leading axis flattened into one
    batch) in one call of the fused kernel, one batched auction, then the
    ID propagation.  Returns (outputs, final state)."""
    prev_feats, mask_prev = pair_inputs(feats, det_mask, state0)
    lead, N = det_mask.shape[:-1], det_mask.shape[-1]
    cfg = module.assoc_cfg

    def flat(x):
        return x.reshape((-1,) + x.shape[len(lead):])

    aff = module.affinity({k: flat(v) for k, v in prev_feats.items()},
                          {k: flat(v) for k, v in feats.items()},
                          flat(mask_prev), flat(det_mask))
    with torch.inference_mode():
        link = aff.link_norm
        if module.spatial_gating:
            link = apply_spatial_gate(link, flat(prev_feats["box"]),
                                      flat(feats["box"]), cfg)
        if module.class_gating:
            link = apply_class_gate(link, flat(prev_feats["cls"])[..., 0],
                                    flat(feats["cls"])[..., 0])
        new, end = aff.new, aff.end
        if not cfg.raw_new_end:
            new, end = sigmoid(new), sigmoid(end)
        dec = associate(link, new, end, flat(mask_prev), flat(det_mask), cfg)
        det_score = sigmoid(module.det_score(feats["fused"], det_mask))
        ids, ages, next_id = propagate_ids(
            dec.match_curr.reshape(lead + (N,)),
            dec.is_new.reshape(lead + (N,)), det_mask, state0)
    final = TrackerState(feats={k: v[..., -1, :, :] for k, v in feats.items()},
                         mask=det_mask[..., -1, :], ids=ids[..., -1, :],
                         ages=ages, next_id=next_id)
    return {"ids": ids, "det_score": det_score}, final


def _hybrid_track(module: TrackingModule, feats, det_mask, state0):
    """The y_det hybrid pre-solve (reference ``_hybrid_track``).

    LP rejection makes the carried state depend on the decisions, but
    only through its MASK: the previous side's features are the previous
    frame's whatever was rejected.  So the raw link scores of all S*T
    pairs run as one fused-kernel call with optimistic masks (every
    valid detection); the loop re-masks each frame's scores with the
    carried mask and keeps the normalisation, the gate, the new/end
    heads, the LP and the ids.  Exact, because rejections only shrink
    the mask and the raw link is exactly 0 at invalid pairs.
    """
    S, T, N = det_mask.shape
    prev_feats, mask_prev_opt = pair_inputs(feats, det_mask, state0)
    link_all = module.affinity_link(
        {k: v.flatten(0, 1) for k, v in prev_feats.items()},
        {k: v.flatten(0, 1) for k, v in feats.items()},
        mask_prev_opt.flatten(0, 1), det_mask.flatten(0, 1)
    ).reshape(S, T, N, N)
    dl_all = det_logits(module, feats, det_mask)
    dl_prev = prev_feats["detlogit"][..., 0]
    box_prev, box_curr = prev_feats.get("box"), feats.get("box")
    mask, ids, ages, next_id = (state0.mask, state0.ids, state0.ages,
                                state0.next_id)
    all_ids = []
    for t in range(T):
        dm = det_mask[:, t]
        link = link_all[:, t] * pair_mask(mask, dm).to(link_all.dtype)
        cls = {}
        if module.class_gating:
            cls = dict(cls_prev=prev_feats["cls"][:, t, :, 0],
                       cls_curr=feats["cls"][:, t, :, 0])
        dec = module.frame_decisions(
            link, prev_feats["fused"][:, t], feats["fused"][:, t], mask,
            dm, dl_prev[:, t], dl_all[:, t],
            None if box_prev is None else box_prev[:, t],
            None if box_curr is None else box_curr[:, t], **cls)
        mask = dm & dec.keep_curr
        ages = matched_ages(ages, dec.match_curr, mask)
        ids, next_id = inherit_ids(ids, next_id, dec.match_curr, dec.is_new,
                                   dm)
        all_ids.append(ids)
    final = TrackerState(feats={k: v[:, -1] for k, v in feats.items()},
                         mask=mask, ids=ids, ages=ages, next_id=next_id)
    return {"ids": torch.stack(all_ids, 1), "det_score": sigmoid(dl_all)}, \
        final


def _revival_track(module: TrackingModule, feats, det_mask, state0):
    """The ghost-pool hybrid pre-solve (reference ``_revival_track``).

    Which tracks survive as ghosts depends on the decisions, but every
    ghost's features are a frozen copy of an earlier detection's.  A slot
    matchable at frame t has missed m <= K frames, so its source frame is
    t-1-m in [t-K-1, t-1]: every link score the scan can need is one of

        band[d][t] = link(feats[t-d], feats[t]),   d = 1..K+1
        entry[t]   = link(state0.feats, feats[t]), t < min(K+1, T)

    (the entry band holds the slots carried in from the previous
    window, live and ghost; with the motion term, each slot's link to a
    detection reads its frozen box).  Raw link scores are exactly 0 at
    invalid pairs and the masks only shrink, so the K+1 bands run as ONE
    fused-kernel call of S*(K+1)*T frame pairs at N slots and the entry
    band as a second call of S*min(K+1, T) pairs at M = 2N slots.  The
    loop carries each slot's PROVENANCE (an index into the window's
    detections, then the M state0 slots) and gathers link rows, features,
    det logits and boxes by it.
    """
    cfg = module.assoc_cfg
    K = cfg.revival_window
    S, T, N = det_mask.shape
    M = state0.mask.shape[-1]
    G, Dd = M - N, K + 1
    cdt = feats["fused"].dtype
    dev = det_mask.device
    coverage = module.ghost_coverage

    # ---- batched link scores (optimistic masks) --------------------------
    link_keys = module.net.present_branches(feats, state0.feats) + (
        ("box",) if module.motion_on else ())
    D_run = min(Dd, T - 1)              # bands d >= T pair no frame
    bands = torch.zeros((S, T, Dd, N, N), dtype=cdt, device=dev)
    if D_run > 0:
        def shifted(x, d):
            return F.pad(x[:, :T - d], (0, 0) * (x.dim() - 2) + (d, 0))

        branch = {k: feats[k] for k in link_keys}
        fp = {k: torch.stack([shifted(v, d) for d in range(1, D_run + 1)],
                             1).flatten(0, 2) for k, v in branch.items()}
        fc = {k: v[:, None].expand((S, D_run) + v.shape[1:]).flatten(0, 2)
              for k, v in branch.items()}
        mp = torch.stack([shifted(det_mask, d) for d in range(1, D_run + 1)],
                         1).flatten(0, 2)
        mc = det_mask[:, None].expand(S, D_run, T, N).flatten(0, 2)
        bands[:, :, :D_run] = module.affinity_link(fp, fc, mp, mc).reshape(
            S, D_run, T, N, N).transpose(1, 2)
    E = min(Dd, T)
    f0 = {k: state0.feats[k][:, None].expand((S, E) + state0.feats[k].shape[1:])
          .flatten(0, 1) for k in link_keys}
    fcE = {k: F.pad(feats[k][:, :E], (0, 0, 0, G)).flatten(0, 1)
           for k in link_keys}
    entry = module.affinity_link(
        f0, fcE, state0.mask[:, None].expand(S, E, M).flatten(0, 1),
        F.pad(det_mask[:, :E], (0, G)).flatten(0, 1)
    ).reshape(S, E, M, M)[..., :N]
    entry_full = torch.zeros((S, T, M, N), dtype=cdt, device=dev)
    entry_full[:, :E] = entry
    bank = torch.cat([bands.reshape(S, T, Dd * N, N), entry_full], 2)

    # ---- flat per-slot banks: the window's T*N slots, then state0's M ---
    def flat(x_win, x0):
        return torch.cat([x_win.flatten(1, 2), x0.to(x_win.dtype)], 1)

    dl_all = det_logits(module, feats, det_mask)
    banks = {"fused": flat(feats["fused"], state0.feats["fused"])}
    if cfg.use_det_scores:
        banks["detlogit"] = flat(dl_all, state0.feats["detlogit"][..., 0])
    if module.carry_boxes:
        banks["box"] = flat(feats["box"], state0.feats["box"])
    if coverage:
        banks["score"] = flat(feats["detsc"], state0.feats["detsc"])[..., 0]
    if module.class_gating:
        banks["cls"] = flat(feats["cls"], state0.feats["cls"])[..., 0]

    pool = {"mask": state0.mask, "ids": state0.ids, "ages": state0.ages,
            "next_id": state0.next_id, "missed": state0.missed,
            "src": (T * N + torch.arange(M, device=dev)).expand(S, M)}
    if coverage:
        pool["vel"] = state0.feats["boxvel"].float()
    outs = []
    R = bank.shape[2]
    for t in range(T):
        src = pool["src"]
        in_win = src < T * N
        d = t - torch.div(src, N, rounding_mode="floor")
        row = torch.where(in_win, (d - 1) * N + src % N, Dd * N + src - T * N)
        link = gather_slots(bank[:, t], row.clamp(0, R - 1))
        dm = F.pad(det_mask[:, t], (0, G))
        link = F.pad(link, (0, G)) * pair_mask(pool["mask"], dm).to(cdt)
        box_c = None
        gate_prev = None
        if module.carry_boxes:
            box_c = F.pad(feats["box"][:, t], (0, 0, 0, G))
            gate_prev = gather_slots(banks["box"], src)
            if cfg.gate_predict:
                gate_prev = predicted_boxes(gate_prev, pool["missed"] + 1,
                                            pool["vel"])
        dlp = dlc = None
        if cfg.use_det_scores:
            dlp = gather_slots(banks["detlogit"], src)
            dlc = F.pad(dl_all[:, t], (0, G))
        cls = {}
        if module.class_gating:
            cls = dict(cls_prev=gather_slots(banks["cls"], src),
                       cls_curr=F.pad(feats["cls"][:, t, :, 0], (0, G)))
        dec = module.frame_decisions(
            link, gather_slots(banks["fused"], src),
            F.pad(feats["fused"][:, t], (0, 0, 0, G)), pool["mask"], dm,
            dlp, dlc, gate_prev, box_c, **cls)
        pool, out = advance_pool(pool, dec, dm, box_c, banks, t, N, K, cfg,
                                 coverage)
        outs.append(out)
    out = _stack_outputs(outs, [k for k in _output_keys(module)
                                if k != "det_score"])
    out["det_score"] = sigmoid(dl_all)
    src = pool["src"]
    final_feats = {k: gather_slots(flat(v, state0.feats[k]), src)
                   for k, v in feats.items()}
    if coverage:
        final_feats["boxvel"] = pool["vel"]
    final = TrackerState(feats=final_feats, mask=pool["mask"],
                         ids=pool["ids"], ages=pool["ages"],
                         next_id=pool["next_id"], missed=pool["missed"])
    return out, final


def advance_pool(pool, dec, det_mask, box_curr, banks, t: int, N: int,
                 K: int, cfg, coverage: bool):
    """The revival hybrid's bookkeeping for frame t (the reference's
    ``_revival_state`` over provenance): ids and ages of this frame's
    detections, then the ghost pool, freshest first; with coverage, each
    track's last link velocity and this frame's coverage rows.  Returns
    (next pool, {"ids" [S, N], and with coverage "ghost_*"})."""
    mask, ids, ages, missed, src = (pool[k] for k in ("mask", "ids",
                                                      "ages", "missed",
                                                      "src"))
    kept = det_mask & dec.keep_curr if cfg.use_det_scores else det_mask
    ids_c, next_id = inherit_ids(ids, pool["next_id"], dec.match_curr,
                                 dec.is_new, det_mask)
    ages_c = matched_ages(ages, dec.match_curr, kept)
    survive = mask & (dec.match_prev < 0) & (missed + 1 <= K)
    gidx, gtaken = select_ghosts(survive, missed, K, mask.shape[-1] - N)
    ids_g = torch.where(gtaken, gather_slots(ids, gidx), -1).to(torch.int32)
    missed_g = torch.where(gtaken, gather_slots(missed, gidx) + 1,
                           0).to(torch.int32)
    src_g = gather_slots(src, gidx)
    nxt = {"mask": torch.cat([kept[:, :N], gtaken], 1),
           "ids": torch.cat([ids_c[:, :N], ids_g], 1),
           "ages": torch.cat([ages_c[:, :N], gather_slots(ages, gidx)], 1),
           "next_id": next_id,
           "missed": torch.cat([torch.zeros_like(missed_g), missed_g], 1),
           "src": torch.cat([(t * N + torch.arange(N, device=src.device))
                             .expand(src.shape[0], N), src_g], 1)}
    out = {"ids": ids_c[:, :N]}
    if coverage:
        vel_c = link_velocity(box_curr, gather_slots(banks["box"], src),
                              dec.match_curr)
        vel_g = gather_slots(pool["vel"], gidx)
        nxt["vel"] = torch.cat([vel_c[:, :N], vel_g], 1)
        gsc = gather_slots(banks["score"], src_g)
        emit = gtaken & (missed_g <= (cfg.coverage_max_miss or K)) \
            & (gsc >= cfg.coverage_min_score)
        out["ghost_ids"] = torch.where(emit, ids_g, -1).to(torch.int32)
        out["ghost_boxes"] = predicted_boxes(
            gather_slots(banks["box"], src_g), missed_g, vel_g)
        out["ghost_scores"] = torch.where(emit, gsc, 0.0)
    return nxt, out


def check_dead_sensor(dead_sensor: Optional[str]) -> None:
    if dead_sensor not in (None, "camera", "lidar"):
        raise ValueError(f"dead_sensor must be camera/lidar, "
                         f"got {dead_sensor!r}")


def check_point_source(point_source: str, boxes3d) -> None:
    if point_source not in ("frustum", "box3d"):
        raise ValueError(f"unknown point_source {point_source!r}")
    if point_source == "box3d" and boxes3d is None:
        raise ValueError("point_source='box3d' requires boxes3d [T, N, 7]")


def extract_frames_batched(module: TrackingModule, images, clouds, boxes,
                           det_mask, proj, crop_size: Tuple[int, int],
                           points_per_det: int,
                           compact_capacity: Optional[int],
                           extract_chunk: Optional[int] = None,
                           crop_window: int = 512, cloud_valid=None,
                           det_cls=None, dead_sensor: Optional[str] = None,
                           boxes3d=None, velo_to_rect=None,
                           point_source: str = "frustum"):
    """Feature extraction over S sequences of raw frames: compact-first
    with ``compact_capacity``, per slot without it.

    Arguments as for :func:`track_sequences_from_frames_batched`, as
    tensors on ``module``'s device.  A dead camera (``dead_sensor=
    "camera"``) skips the crops, a dead LiDAR the point sampling, and
    the net runs on the modality left; a net without a modality
    (``use_image`` / ``use_lidar`` off) skips its input work too (the
    reference's compiled window drops it as dead code).  Returns (feats
    {branch: [S, T, N, D]}, and ``"box"`` [S, T, N, 4] f32 when
    ``module.carry_boxes``, ``"cls"`` [S, T, N, 1] f32 when
    ``module.class_gating``; kept [S, T, N] bool: the valid slots that
    fit in the capacity, every valid slot per slot).
    """
    check_dead_sensor(dead_sensor)
    check_point_source(point_source, boxes3d)
    mcfg = module.net.cfg
    use_cam = dead_sensor != "camera" and mcfg.use_image
    use_lidar = dead_sensor != "lidar" and mcfg.use_lidar
    det_mask = det_mask.bool()
    boxes, proj = boxes.float(), proj.float()
    scale = 1.0 / 255.0 if images.dtype == torch.uint8 else 1.0
    S, T, N = det_mask.shape
    dev = det_mask.device
    images = images.reshape((S * T,) + images.shape[2:])
    clouds = clouds.reshape((S * T,) + clouds.shape[2:])
    if cloud_valid is not None:
        cloud_valid = cloud_valid.bool().reshape(S * T, -1)
    proj_s = proj.expand(S, 3, 4)
    if point_source == "box3d":
        boxes3d = boxes3d.float().reshape(S * T, N, 7)
        if velo_to_rect is not None:
            velo_to_rect = velo_to_rect.float().expand(S, 3, 4)

    def sample_points(f_k, s_k, m_k):
        """Point samples [n, k, P, C] and masks [n, k, P] of the k
        detections s_k [n, k] (slots of the frame) of frames f_k [n];
        m_k [n, k] their validity."""
        cl = clouds[f_k]
        pv = cloud_valid[f_k] if cloud_valid is not None else None
        if point_source == "box3d":
            return box3d_sample(
                cl, boxes3d[f_k[:, None], s_k], points_per_det,
                None if velo_to_rect is None else velo_to_rect[f_k // T],
                det_mask=m_k, point_valid=pv)
        return frustum_sample(
            cl, boxes.reshape(S * T, N, 4)[f_k[:, None], s_k],
            proj_s[f_k // T], points_per_det, det_mask=m_k,
            point_valid=pv)

    if compact_capacity is None:
        return _extract_per_slot(module, images, boxes, det_mask,
                                 crop_size, extract_chunk, det_cls,
                                 use_cam, use_lidar, scale, sample_points)
    capacity = min(compact_capacity, T * N)
    idx, taken = compact_indices(det_mask.reshape(S, T * N), capacity)
    # Row r of sequence s reads frame s*T + idx // N and slot s*T*N + idx.
    seq = torch.arange(S, device=dev)[:, None]
    frame = (seq * T + idx // N).reshape(-1)
    slot = (seq * (T * N) + idx).reshape(-1)
    taken = taken.reshape(-1)

    def extract(f_k, s_k, m_k):
        bx_k = boxes.reshape(S * T * N, 4)[s_k]
        crops = pts = pmask = None
        if use_cam:
            crops = crop_and_resize_gathered(images, f_k, bx_k, crop_size,
                                             mask=m_k, window=crop_window)
            crops = normalize_crops(crops, scale=scale)
        if use_lidar:
            pts, pmask = sample_points(f_k, (s_k % N)[:, None],
                                       m_k[:, None])
            pts, pmask = pts[:, 0], pmask[:, 0]
        return module.extract(crops, pts, pmask, m_k)

    with torch.inference_mode(), f32_parity(module.parity):
        feats_c = _chunked(extract, (frame, slot, taken), S * capacity,
                           extract_chunk)
        feats = {k: scatter_compact(v, slot, taken, S * T * N)
                 .reshape(S, T, N, -1) for k, v in feats_c.items()}
        kept = torch.zeros(S * T * N, dtype=torch.bool, device=dev)
        kept[slot] = taken
    return _with_boxes_and_classes(module, feats, boxes, det_cls), \
        kept.reshape(S, T, N)


def _extract_per_slot(module, images, boxes, det_mask, crop_size,
                      extract_chunk, det_cls, use_cam, use_lidar, scale,
                      sample_points):
    """The reference's per-slot branch (``compact_capacity=None``): every
    slot of every frame, valid or not, cropped from the whole frame
    (``crop_and_resize_batched``, no crop window) and sampled; the net
    extracts all S * T * N rows (``extract_chunk`` at a time) and nothing
    is dropped.  ``images`` are [S * T, H, W, 3]; returns what
    :func:`extract_frames_batched` returns."""
    S, T, N = det_mask.shape
    flat = det_mask.reshape(-1)
    dev = det_mask.device
    with torch.inference_mode(), f32_parity(module.parity):
        crops = pts = pmask = None
        if use_cam:
            crops = crop_and_resize_batched(
                images.float(), boxes.reshape(S * T, N, 4), crop_size,
                det_mask.reshape(S * T, N))
            crops = normalize_crops(crops, scale=scale).flatten(0, 1)
        if use_lidar:
            pts, pmask = sample_points(
                torch.arange(S * T, device=dev),
                torch.arange(N, device=dev).expand(S * T, N),
                det_mask.reshape(S * T, N))
            pts, pmask = pts.flatten(0, 1), pmask.flatten(0, 1)
        rows = tuple(x for x in (crops, pts, pmask) if x is not None)

        def extract(*args):
            it = iter(args)
            c = next(it) if use_cam else None
            p, pm = (next(it), next(it)) if use_lidar else (None, None)
            return module.extract(c, p, pm, next(it))

        feats = _chunked(extract, rows + (flat,), S * T * N, extract_chunk)
        feats = {k: v.reshape(S, T, N, -1) for k, v in feats.items()}
    return _with_boxes_and_classes(module, feats, boxes, det_cls), det_mask


def _with_boxes_and_classes(module, feats, boxes, det_cls):
    """``feats`` with the ``"box"`` and ``"cls"`` entries the module reads
    (its carried boxes, its class gate)."""
    if module.carry_boxes:
        feats["box"] = boxes
    if module.class_gating:
        if det_cls is None:
            raise ValueError("class_gate needs det_cls, the class-group id "
                             "of every detection slot")
        feats["cls"] = det_cls.float()[..., None]
    return feats


def extract_frames(module: TrackingModule, images, clouds, boxes, det_mask,
                   proj, crop_size: Tuple[int, int], points_per_det: int,
                   compact_capacity: Optional[int] = None,
                   extract_chunk: Optional[int] = None,
                   crop_window: int = 512, cloud_valid=None, det_cls=None,
                   boxes3d=None, velo_to_rect=None,
                   point_source: str = "frustum"):
    """:func:`extract_frames_batched` for one sequence (no S axis)."""
    def one(x):
        return None if x is None else x[None]

    feats, kept = extract_frames_batched(
        module, images[None], clouds[None], boxes[None], det_mask[None],
        proj, crop_size, points_per_det, compact_capacity, extract_chunk,
        crop_window, one(cloud_valid), one(det_cls), boxes3d=one(boxes3d),
        velo_to_rect=velo_to_rect, point_source=point_source)
    return {k: v[0] for k, v in feats.items()}, kept[0]


def track_sequences_from_frames_batched(
        module: TrackingModule, images, clouds, boxes, det_mask, proj,
        crop_size: Tuple[int, int], points_per_det: int,
        cloud_valid=None, compact_capacity: Optional[int] = None,
        extract_chunk: Optional[int] = None, crop_window: int = 512,
        state0: Optional[TrackerState] = None, return_state: bool = False,
        det_cls=None, dead_sensor: Optional[str] = None, boxes3d=None,
        velo_to_rect=None, point_source: str = "frustum"):
    """Track S sequences from raw frames on ``module``'s device.

    images [S, T, H, W, 3] uint8 (or float pixels), clouds [S, T, M, C],
    boxes [S, T, N, 4] (l, t, r, b pixels), det_mask [S, T, N] bool, proj
    [S, 3, 4] (or one [3, 4] for all), cloud_valid [S, T, M] bool or None,
    det_cls [S, T, N] class-group ids (read with the class gate, which
    needs them); numpy arrays or tensors.  ``point_source="box3d"``
    samples the points inside each detection's 3D box, boxes3d [S, T, N,
    7] (KITTI (h, w, l, x, y, z, ry) in rect coordinates), from the
    clouds taken to rect coordinates by velo_to_rect [S, 3, 4] (or one
    [3, 4]; None: the clouds are rectified already).
    ``compact_capacity`` bounds the detections extracted per sequence;
    valid detections past it are dropped and counted in ``n_dropped``.
    ``None`` runs the reference's per-slot branch: every slot cropped
    from its whole frame (no crop window, ``crop_window`` unread) and
    extracted, none dropped.  ``state0`` is a state with a leading [S]
    axis (default: empty).  ``dead_sensor`` ("camera" or "lidar")
    simulates a failed sensor: its input work is skipped and the
    affinity scores the branches left (see
    :func:`extract_frames_batched`); a ``state0`` then carries no feats
    of the dead branch (``TrackingModule.init_state(N, dead_sensor)``).
    Returns {"ids": [S, T, N] int32 (-1 at empty slots),
    "det_score": [S, T, N], "n_dropped": [S]} and, with ghost coverage,
    "ghost_ids" [S, T, N] (-1 where no row), "ghost_boxes" [S, T, N, 4]
    and "ghost_scores" [S, T, N]; the final state too with
    ``return_state``.
    """
    dev = module.device
    images, clouds, boxes, det_mask, proj = (
        torch.as_tensor(x, device=dev)
        for x in (images, clouds, boxes, det_mask, proj))
    cloud_valid, det_cls, boxes3d, velo_to_rect = (
        None if x is None else torch.as_tensor(x, device=dev)
        for x in (cloud_valid, det_cls, boxes3d, velo_to_rect))
    det_mask = det_mask.bool()
    feats, kept = extract_frames_batched(
        module, images, clouds, boxes, det_mask, proj, crop_size,
        points_per_det, compact_capacity, extract_chunk, crop_window,
        cloud_valid, det_cls, dead_sensor, boxes3d, velo_to_rect,
        point_source)
    out, final = _scan_track(module, feats, kept, state0)
    out["n_dropped"] = (det_mask.sum((1, 2)) - kept.sum((1, 2))).to(
        torch.int32)
    return (out, final) if return_state else out


def compact_extract(module: TrackingModule, crops, points, point_mask,
                    det_mask, capacity: int):
    """Features of the valid slots of padded, already cropped detections
    (the reference's ``_compact_extract``): crops [T, N, h, w, 3], points
    [T, N, P, C], point_mask [T, N, P], det_mask [T, N] bool, on
    ``module``'s device.  The valid (frame, slot) pairs are gathered
    valid-first over the flattened [T * N] grid into ``capacity`` rows,
    extracted in one call and scattered back.
    Valid slots past the capacity are dropped.  Returns (feats {branch:
    [T, N, D]}, zero at every slot not kept; kept [T, N] bool)."""
    T, N = det_mask.shape
    capacity = min(capacity, T * N)
    idx, taken = compact_indices(det_mask.reshape(-1), capacity)

    def gather(x):
        return None if x is None else x.reshape((T * N,) + x.shape[2:])[idx]

    with torch.inference_mode():
        feats_c = module.extract(gather(crops), gather(points),
                                 gather(point_mask), taken)
        feats = {k: scatter_compact(v, idx, taken, T * N).reshape(T, N, -1)
                 for k, v in feats_c.items()}
        kept = torch.zeros(T * N, dtype=torch.bool, device=det_mask.device)
        kept[idx] = taken
    return feats, kept.reshape(T, N)


def track_sequence(module: TrackingModule, crops, points, point_mask,
                   det_mask, compact_capacity: Optional[int] = None,
                   boxes=None):
    """Track one sequence of ``T`` frames of padded, already cropped
    detections (``tracker/sequence.py::track_sequence`` of the
    reference) on ``module``'s device.

    crops [T, N, h, w, 3], points [T, N, P, C], point_mask [T, N, P],
    det_mask [T, N] (numpy arrays or tensors; ``crops=None`` or
    ``points=None`` and ``point_mask=None`` for a dead sensor, whose
    branch then drops out of the affinity); boxes [T, N, 4] when the
    module carries boxes (a class-gated module is refused: it needs the
    class ids of ``track_sequence_from_frames``).  With
    ``compact_capacity`` only the first ``compact_capacity`` valid
    (frame, slot) pairs are extracted (the rest are dropped and counted);
    without it every slot is.  Returns {"ids": [T, N] int32, "det_score":
    [T, N], "n_dropped": 0-dim int32} (and the ghost outputs with
    coverage)."""
    if module.class_gating:
        raise ValueError("track_sequence takes no class ids: a class-gated "
                         "module tracks through track_sequence_from_frames")
    dev = module.device
    crops, points, point_mask, det_mask = (
        None if x is None else torch.as_tensor(x, device=dev)
        for x in (crops, points, point_mask, det_mask))
    det_mask = det_mask.bool()
    point_mask = None if point_mask is None else point_mask.bool()
    n_valid = det_mask.sum()
    if compact_capacity is not None:
        feats, det_mask = compact_extract(module, crops, points, point_mask,
                                          det_mask, compact_capacity)
    else:
        feats = module.extract(crops, points, point_mask, det_mask)
    if module.carry_boxes:
        if boxes is None:
            raise ValueError("this module carries boxes (spatial gate, "
                             "coverage or motion): pass boxes [T, N, 4]")
        feats["box"] = torch.as_tensor(boxes, device=dev).float()
    out, _ = _scan_track(module, {k: v[None] for k, v in feats.items()},
                         det_mask[None])
    out = {k: v[0] for k, v in out.items()}
    out["n_dropped"] = (n_valid - det_mask.sum()).to(torch.int32)
    return out


def track_sequences_batched(module: TrackingModule, crops, points,
                            point_mask, det_mask, boxes=None):
    """Track S sequences of padded, already cropped detections at once
    (the reference's ``track_sequences_batched``, ``track_sequence``
    vmapped over S): crops [S, T, N, h, w, 3], points [S, T, N, P, C],
    point_mask [S, T, N, P], det_mask [S, T, N], boxes [S, T, N, 4] when
    the module carries boxes; every slot is extracted.  Returns {"ids":
    [S, T, N] int32, "det_score": [S, T, N], "n_dropped": [S] zeros} (and
    the ghost outputs with coverage).  Sequences share nothing, so the S
    axis splits over data-parallel ranks (``parallel/mesh.py``): each
    sequence is extracted by a call of its own, so that its features do
    not hang on how many sequences share a call (cuBLAS and cuDNN pick
    their kernels by the batch), and its ids on one rank are its ids in
    one process."""
    if module.class_gating:
        raise ValueError("track_sequences_batched takes no class ids: a "
                         "class-gated module tracks raw frames")
    dev = module.device
    crops, points, point_mask, det_mask = (
        None if x is None else torch.as_tensor(x, device=dev)
        for x in (crops, points, point_mask, det_mask))
    det_mask = det_mask.bool()
    point_mask = None if point_mask is None else point_mask.bool()
    per = [module.extract(None if crops is None else crops[i],
                          None if points is None else points[i],
                          None if point_mask is None else point_mask[i],
                          det_mask[i]) for i in range(det_mask.shape[0])]
    feats = {k: torch.stack([f[k] for f in per]) for k in per[0]}
    if module.carry_boxes:
        if boxes is None:
            raise ValueError("this module carries boxes (spatial gate, "
                             "coverage or motion): pass boxes [S, T, N, 4]")
        feats["box"] = torch.as_tensor(boxes, device=dev).float()
    out, _ = _scan_track(module, feats, det_mask)
    out["n_dropped"] = torch.zeros(det_mask.shape[0], dtype=torch.int32,
                                   device=dev)
    return out


def track_sequence_from_frames(module: TrackingModule, images, clouds, boxes,
                               det_mask, proj, crop_size: Tuple[int, int],
                               points_per_det: int, cloud_valid=None,
                               compact_capacity: Optional[int] = None,
                               extract_chunk: Optional[int] = None,
                               crop_window: int = 512,
                               state0: Optional[TrackerState] = None,
                               return_state: bool = False, det_cls=None,
                               dead_sensor: Optional[str] = None,
                               boxes3d=None, velo_to_rect=None,
                               point_source: str = "frustum"):
    """Track one sequence from raw frames on ``module``'s device.

    images [T, H, W, 3] uint8 (or float pixels), clouds [T, M, C], boxes
    [T, N, 4] (l, t, r, b pixels), det_mask [T, N] bool, proj [3, 4],
    cloud_valid [T, M] bool or None (padded cloud entries), det_cls [T, N]
    class-group ids (read with the class gate); numpy arrays or tensors.
    ``dead_sensor`` ("camera" or "lidar"), ``boxes3d`` [T, N, 7],
    ``velo_to_rect`` [3, 4] and ``point_source`` as for
    :func:`track_sequences_from_frames_batched`.  ``compact_capacity``
    bounds the detections extracted; valid detections past it are
    dropped and counted in ``n_dropped`` (``None``: the per-slot branch,
    which drops none).  ``state0`` continues
    a longer sequence from the state an earlier window returned.  Returns
    {"ids": [T, N] int32 (-1 at empty slots), "det_score": [T, N],
    "n_dropped": 0-dim int} (and the ghost outputs of
    :func:`track_sequences_from_frames_batched` without their S axis),
    and the final state too with ``return_state``.
    """
    dev = module.device

    def one(x):
        return None if x is None else torch.as_tensor(x, device=dev)[None]

    if state0 is not None:
        state0 = stack_states([state0])
    out, final = track_sequences_from_frames_batched(
        module, *(one(x) for x in (images, clouds, boxes, det_mask)),
        torch.as_tensor(proj, device=dev), crop_size, points_per_det,
        cloud_valid=one(cloud_valid), compact_capacity=compact_capacity,
        extract_chunk=extract_chunk, crop_window=crop_window, state0=state0,
        return_state=True, det_cls=one(det_cls), dead_sensor=dead_sensor,
        boxes3d=one(boxes3d), velo_to_rect=None if velo_to_rect is None
        else torch.as_tensor(velo_to_rect, device=dev),
        point_source=point_source)
    out = {k: v[0] for k, v in out.items()}
    if not return_state:
        return out
    return out, TrackerState(
        feats={k: v[0] for k, v in final.feats.items()}, mask=final.mask[0],
        ids=final.ids[0], ages=final.ages[0], next_id=final.next_id[0],
        missed=None if final.missed is None else final.missed[0])
