"""Whole-sequence tracking from raw frames: port of the compact-first
branch of ``mmmot_tpu/tracker/sequence.py::track_sequence_from_frames``
with the parallel association pre-solve (``_parallel_track``).

1. The valid (frame, slot) pairs are compacted up front.
2. For each valid detection, in chunks: crop a band of its frame, resize
   and normalise it, sample its frustum points, and extract features.
3. The features are scattered back to [T, N] slots.
4. All T frame-pair affinities run as one batched call (the fused
   kernel on the GPU), then one batched auction.
5. IDs propagate frame by frame in a Python loop over T on the device
   (the reference's ``lax.scan``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from mmmot_tpu_torch.assoc.solve import associate
from mmmot_tpu_torch.device import f32_parity
from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_gathered,
                                             normalize_crops)
from mmmot_tpu_torch.ops.frustum import frustum_sample
from mmmot_tpu_torch.ops.masking import compact_indices, scatter_compact
from mmmot_tpu_torch.tracker.tracker import (TrackerState, TrackingModule,
                                             init_state)


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
    t, pair 0 joins ``state0`` (empty at a sequence start)."""
    prev = {k: torch.cat([state0.feats[k][None], v[:-1]])
            for k, v in feats.items()}
    return prev, torch.cat([state0.mask[None], det_mask[:-1]])


def propagate_ids(match_curr, is_new, det_mask, state0: TrackerState):
    """Frame-by-frame ID bookkeeping: a linked detection inherits its
    match's ID, a new one takes the next fresh ID (in slot order), empty
    slots get -1.  Returns ids [T, N] int32."""
    ids_prev, next_id = state0.ids, state0.next_id
    ids_all = []
    for t in range(det_mask.shape[0]):
        match, new, dm = match_curr[t], is_new[t], det_mask[t]
        linked = match >= 0
        safe = match.clamp_min(0).long()
        inherited = torch.where(linked, ids_prev[safe], -1)
        order = torch.cumsum(new.to(torch.int32), 0) - 1
        ids = torch.where(new, next_id + order, inherited)
        ids = torch.where(dm, ids, -1).to(torch.int32)
        next_id = next_id + new.to(torch.int32).sum()
        ids_all.append(ids)
        ids_prev = ids
    return torch.stack(ids_all)


def _parallel_track(module: TrackingModule, feats: Dict[str, torch.Tensor],
                    det_mask, state0: TrackerState):
    """All T frame-pair affinities in one batched call (the fused kernel
    on the GPU), one batched auction, then the ID propagation."""
    prev_feats, mask_prev = pair_inputs(feats, det_mask, state0)
    aff = module.affinity(prev_feats, feats, mask_prev, det_mask)
    with torch.inference_mode():
        dec = associate(aff.link_norm, torch.sigmoid(aff.new),
                        torch.sigmoid(aff.end), mask_prev, det_mask)
        det_score = torch.sigmoid(module.det_score(feats["fused"], det_mask))
        ids = propagate_ids(dec.match_curr, dec.is_new, det_mask, state0)
    return {"ids": ids, "det_score": det_score}


def extract_frames(module: TrackingModule, images, clouds, boxes, det_mask,
                   proj, crop_size: Tuple[int, int], points_per_det: int,
                   compact_capacity: Optional[int] = None,
                   extract_chunk: Optional[int] = None,
                   crop_window: int = 512):
    """Compact-first feature extraction over a sequence of raw frames.

    Arguments as for :func:`track_sequence_from_frames`, as tensors on
    ``module``'s device.  Returns (feats {branch: [T, N, D]}, kept [T, N]
    bool: the valid slots that fit in the capacity).
    """
    det_mask = det_mask.bool()
    boxes, proj = boxes.float(), proj.float()
    scale = 1.0 / 255.0 if images.dtype == torch.uint8 else 1.0
    T, N = det_mask.shape
    capacity = min(compact_capacity or T * N, T * N)
    idx, taken = compact_indices(det_mask.reshape(-1), capacity)

    def extract(ts_k, bx_k, m_k):
        crops = crop_and_resize_gathered(images, ts_k, bx_k, crop_size,
                                         mask=m_k, window=crop_window)
        crops = normalize_crops(crops, scale=scale)
        pts, pmask = frustum_sample(clouds[ts_k], bx_k[:, None, :], proj,
                                    points_per_det, det_mask=m_k[:, None])
        return module.extract(crops, pts[:, 0], pmask[:, 0], m_k)

    with torch.inference_mode(), f32_parity(module.parity):
        feats_c = _chunked(extract, (idx // N, boxes.reshape(T * N, 4)[idx],
                                     taken), capacity, extract_chunk)
        feats = {k: scatter_compact(v, idx, taken, T * N).reshape(T, N, -1)
                 for k, v in feats_c.items()}
        kept = torch.zeros(T * N, dtype=torch.bool, device=det_mask.device)
        kept[idx] = taken
    return feats, kept.reshape(T, N)


def track_sequence_from_frames(module: TrackingModule, images, clouds, boxes,
                               det_mask, proj, crop_size: Tuple[int, int],
                               points_per_det: int,
                               compact_capacity: Optional[int] = None,
                               extract_chunk: Optional[int] = None,
                               crop_window: int = 512):
    """Track one sequence from raw frames on ``module``'s device.

    images [T, H, W, 3] uint8 (or float pixels), clouds [T, M, C], boxes
    [T, N, 4] (l, t, r, b pixels), det_mask [T, N] bool, proj [3, 4];
    numpy arrays or tensors.  ``compact_capacity`` (default T*N) bounds
    the detections extracted; valid detections past it are dropped and
    counted in ``n_dropped``.  Returns {"ids": [T, N] int32 (-1 at empty
    slots), "det_score": [T, N], "n_dropped": 0-dim int}.
    """
    dev = module.device
    images, clouds, boxes, det_mask, proj = (
        torch.as_tensor(x, device=dev)
        for x in (images, clouds, boxes, det_mask, proj))
    det_mask = det_mask.bool()
    feats, kept = extract_frames(module, images, clouds, boxes, det_mask,
                                 proj, crop_size, points_per_det,
                                 compact_capacity, extract_chunk, crop_window)
    state0 = init_state({k: v.shape[-1] for k, v in feats.items()},
                        det_mask.shape[1], module.net.compute_dtype, dev)
    out = _parallel_track(module, feats, kept, state0)
    out["n_dropped"] = det_mask.sum() - kept.sum()
    return out
