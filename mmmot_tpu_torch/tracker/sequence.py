"""Whole-sequence tracking from raw frames: port of the compact-first
branch of ``mmmot_tpu/tracker/sequence.py::track_sequence_from_frames``
with the parallel association pre-solve (``_parallel_track``), and of
``track_sequences_from_frames_batched`` (the S axis).

1. The valid (frame, slot) pairs of each sequence are compacted up front,
   every sequence at one shared capacity.
2. For each compacted detection of all S sequences, in chunks: crop a
   band of its frame, resize and normalise it, sample its frustum points,
   and extract features.
3. The features are scattered back to [S, T, N] slots.
4. All S*T frame-pair affinities run as one batched call (the fused
   kernel on the GPU), then one batched auction.
5. IDs propagate frame by frame in a Python loop over T on the device
   (the reference's ``lax.scan``), vectorised over S.

The reference vmaps the one-sequence function over S; here S is a batch
dimension of every tensor, which gives the same ids.  A window of a
longer sequence starts from the ``TrackerState`` the previous window
returned (``state0``/``return_state``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mmmot_tpu_torch.assoc.solve import associate
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.models.layers import sigmoid
from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_gathered,
                                             normalize_crops)
from mmmot_tpu_torch.ops.frustum import frustum_sample
from mmmot_tpu_torch.ops.masking import compact_indices, scatter_compact
from mmmot_tpu_torch.tracker.tracker import (TrackerState, TrackingModule,
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
        linked = match >= 0
        safe = match.clamp_min(0).long()
        inherited = torch.where(linked, torch.gather(ids_prev, -1, safe), -1)
        order = torch.cumsum(new.to(torch.int32), -1) - 1
        ids = torch.where(new, next_id[..., None] + order, inherited)
        ids = torch.where(dm, ids, -1).to(torch.int32)
        age = torch.where(linked, torch.gather(ages_prev, -1, safe), 0)
        ages_prev = torch.where(dm, age + 1, 0).to(torch.int32)
        next_id = next_id + new.to(torch.int32).sum(-1)
        ids_all.append(ids)
        ids_prev = ids
    return torch.stack(ids_all, dim=-2), ages_prev, next_id


def _parallel_track(module: TrackingModule, feats: Dict[str, torch.Tensor],
                    det_mask, state0: TrackerState):
    """All frame-pair affinities (every leading axis flattened into one
    batch) in one call of the fused kernel, one batched auction, then the
    ID propagation.  Returns (outputs, final state)."""
    prev_feats, mask_prev = pair_inputs(feats, det_mask, state0)
    lead, N = det_mask.shape[:-1], det_mask.shape[-1]

    def flat(x):
        return x.reshape((-1,) + x.shape[len(lead):])

    aff = module.affinity({k: flat(v) for k, v in prev_feats.items()},
                          {k: flat(v) for k, v in feats.items()},
                          flat(mask_prev), flat(det_mask))
    with torch.inference_mode():
        dec = associate(aff.link_norm, sigmoid(aff.new), sigmoid(aff.end),
                        flat(mask_prev), flat(det_mask))
        det_score = sigmoid(module.det_score(feats["fused"], det_mask))
        ids, ages, next_id = propagate_ids(
            dec.match_curr.reshape(lead + (N,)),
            dec.is_new.reshape(lead + (N,)), det_mask, state0)
    final = TrackerState(feats={k: v[..., -1, :, :] for k, v in feats.items()},
                         mask=det_mask[..., -1, :], ids=ids[..., -1, :],
                         ages=ages, next_id=next_id)
    return {"ids": ids, "det_score": det_score}, final


def _require_capacity(compact_capacity: Optional[int]) -> int:
    if compact_capacity is None:
        raise ValueError(
            "compact_capacity=None selects the reference's per-slot branch "
            "(full-width crops of every slot, no crop window), which is not "
            "ported; pass a capacity (the compact-first branch)")
    return compact_capacity


def extract_frames_batched(module: TrackingModule, images, clouds, boxes,
                           det_mask, proj, crop_size: Tuple[int, int],
                           points_per_det: int, compact_capacity: int,
                           extract_chunk: Optional[int] = None,
                           crop_window: int = 512, cloud_valid=None):
    """Compact-first feature extraction over S sequences of raw frames.

    Arguments as for :func:`track_sequences_from_frames_batched`, as
    tensors on ``module``'s device.  Returns (feats {branch: [S, T, N,
    D]}, kept [S, T, N] bool: the valid slots that fit in the capacity).
    """
    det_mask = det_mask.bool()
    boxes, proj = boxes.float(), proj.float()
    scale = 1.0 / 255.0 if images.dtype == torch.uint8 else 1.0
    S, T, N = det_mask.shape
    capacity = min(_require_capacity(compact_capacity), T * N)
    dev = det_mask.device
    idx, taken = compact_indices(det_mask.reshape(S, T * N), capacity)
    # Row r of sequence s reads frame s*T + idx // N and slot s*T*N + idx.
    seq = torch.arange(S, device=dev)[:, None]
    frame = (seq * T + idx // N).reshape(-1)
    slot = (seq * (T * N) + idx).reshape(-1)
    taken = taken.reshape(-1)
    images = images.reshape((S * T,) + images.shape[2:])
    clouds = clouds.reshape((S * T,) + clouds.shape[2:])
    if cloud_valid is not None:
        cloud_valid = cloud_valid.bool().reshape(S * T, -1)
    proj_s = proj.expand(S, 3, 4)

    def extract(f_k, s_k, m_k):
        bx_k = boxes.reshape(S * T * N, 4)[s_k]
        crops = crop_and_resize_gathered(images, f_k, bx_k, crop_size,
                                         mask=m_k, window=crop_window)
        crops = normalize_crops(crops, scale=scale)
        pv = cloud_valid[f_k] if cloud_valid is not None else None
        pts, pmask = frustum_sample(clouds[f_k], bx_k[:, None, :],
                                    proj_s[f_k // T], points_per_det,
                                    det_mask=m_k[:, None], point_valid=pv)
        return module.extract(crops, pts[:, 0], pmask[:, 0], m_k)

    with torch.inference_mode(), f32_parity(module.parity):
        feats_c = _chunked(extract, (frame, slot, taken), S * capacity,
                           extract_chunk)
        feats = {k: scatter_compact(v, slot, taken, S * T * N)
                 .reshape(S, T, N, -1) for k, v in feats_c.items()}
        kept = torch.zeros(S * T * N, dtype=torch.bool, device=dev)
        kept[slot] = taken
    return feats, kept.reshape(S, T, N)


def extract_frames(module: TrackingModule, images, clouds, boxes, det_mask,
                   proj, crop_size: Tuple[int, int], points_per_det: int,
                   compact_capacity: Optional[int] = None,
                   extract_chunk: Optional[int] = None,
                   crop_window: int = 512, cloud_valid=None):
    """:func:`extract_frames_batched` for one sequence (no S axis)."""
    feats, kept = extract_frames_batched(
        module, images[None], clouds[None], boxes[None], det_mask[None],
        proj, crop_size, points_per_det, _require_capacity(compact_capacity),
        extract_chunk, crop_window,
        None if cloud_valid is None else cloud_valid[None])
    return {k: v[0] for k, v in feats.items()}, kept[0]


def track_sequences_from_frames_batched(
        module: TrackingModule, images, clouds, boxes, det_mask, proj,
        crop_size: Tuple[int, int], points_per_det: int,
        cloud_valid=None, compact_capacity: Optional[int] = None,
        extract_chunk: Optional[int] = None, crop_window: int = 512,
        state0: Optional[TrackerState] = None, return_state: bool = False):
    """Track S sequences from raw frames on ``module``'s device.

    images [S, T, H, W, 3] uint8 (or float pixels), clouds [S, T, M, C],
    boxes [S, T, N, 4] (l, t, r, b pixels), det_mask [S, T, N] bool, proj
    [S, 3, 4] (or one [3, 4] for all), cloud_valid [S, T, M] bool or None;
    numpy arrays or tensors.  ``compact_capacity`` bounds the detections
    extracted per sequence (``None``, the reference's per-slot branch,
    raises); valid detections past it are dropped and counted in
    ``n_dropped``.  ``state0`` is a state with a leading [S] axis (default:
    empty).  Returns {"ids": [S, T, N] int32 (-1 at empty slots),
    "det_score": [S, T, N], "n_dropped": [S]}, and the final state too
    with ``return_state``.
    """
    _require_capacity(compact_capacity)
    dev = module.device
    images, clouds, boxes, det_mask, proj = (
        torch.as_tensor(x, device=dev)
        for x in (images, clouds, boxes, det_mask, proj))
    if cloud_valid is not None:
        cloud_valid = torch.as_tensor(cloud_valid, device=dev)
    det_mask = det_mask.bool()
    S, _, N = det_mask.shape
    feats, kept = extract_frames_batched(
        module, images, clouds, boxes, det_mask, proj, crop_size,
        points_per_det, compact_capacity, extract_chunk, crop_window,
        cloud_valid)
    if state0 is None:
        state0 = stack_states([module.init_state(N) for _ in range(S)])
    out, final = _parallel_track(module, feats, kept, state0)
    out["n_dropped"] = (det_mask.sum((1, 2)) - kept.sum((1, 2))).to(
        torch.int32)
    return (out, final) if return_state else out


def track_sequence_from_frames(module: TrackingModule, images, clouds, boxes,
                               det_mask, proj, crop_size: Tuple[int, int],
                               points_per_det: int, cloud_valid=None,
                               compact_capacity: Optional[int] = None,
                               extract_chunk: Optional[int] = None,
                               crop_window: int = 512,
                               state0: Optional[TrackerState] = None,
                               return_state: bool = False):
    """Track one sequence from raw frames on ``module``'s device.

    images [T, H, W, 3] uint8 (or float pixels), clouds [T, M, C], boxes
    [T, N, 4] (l, t, r, b pixels), det_mask [T, N] bool, proj [3, 4],
    cloud_valid [T, M] bool or None (padded cloud entries); numpy arrays
    or tensors.  ``compact_capacity`` bounds the detections extracted
    (``None``, the reference's per-slot branch, raises); valid detections
    past it are dropped and counted in ``n_dropped``.  ``state0`` continues
    a longer sequence from the state an earlier window returned.  Returns
    {"ids": [T, N] int32 (-1 at empty slots), "det_score": [T, N],
    "n_dropped": 0-dim int}, and the final state too with
    ``return_state``.
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
        return_state=True)
    out = {k: v[0] for k, v in out.items()}
    if not return_state:
        return out
    return out, TrackerState(
        feats={k: v[0] for k, v in final.feats.items()}, mask=final.mask[0],
        ids=final.ids[0], ages=final.ages[0], next_id=final.next_id[0])
