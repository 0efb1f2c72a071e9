"""Synthetic KITTI-like tracking sequences (host side, numpy): the
port's copy of ``mmmot_tpu/data/synthetic.py``, which must give the same
arrays from the same ``numpy`` generator.

Padded-slot tracking data with the shape contract of the KITTI packer:
per-detection image crops (each object has a persistent visual
signature), per-detection point clusters (a persistent geometric
signature), 2D boxes, validity masks and ground-truth track ids, with
optional detector noise (drop-outs, false positives, box jitter and
degraded true detections) so that association is non-trivial.  The
train CLI trains on ``make_training_batch`` and validates on
``make_synthetic_sequence``; ``association_labels`` also labels the
KITTI pair loader's batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

IMG_W, IMG_H = 1242.0, 375.0


@dataclass
class SyntheticWorld:
    """Arrays describing one synthetic sequence (time-major, padded)."""

    crops: np.ndarray        # [T, N, h, w, 3] float32
    points: np.ndarray      # [T, N, P, 4] float32
    point_mask: np.ndarray  # [T, N, P] bool
    det_mask: np.ndarray    # [T, N] bool
    boxes2d: np.ndarray     # [T, N, 4] float32 (l, t, r, b) — DETECTOR
                            # boxes (jittered when jitter_px > 0)
    gt_ids: np.ndarray      # [T, N] int32 (-1 for padding / false positives)
    scores: np.ndarray      # [T, N] float32 detection confidence
    gt_boxes2d: np.ndarray = None  # [T, N, 4] clean GT boxes (== boxes2d
                            # when the detector is noise-free)
    gt_alive: np.ndarray = None       # [T, K] object visible at t (even if
                            # the detector dropped it — real FNs for the
                            # noisy-quality regime)
    gt_traj_boxes: np.ndarray = None  # [T, K, 4] clean per-object boxes


def make_synthetic_sequence(
        rng: np.random.Generator, num_frames: int = 20, num_slots: int = 8,
        crop_size: Tuple[int, int] = (32, 32), points_per_det: int = 16,
        num_objects: int = 6, appear_noise: float = 0.05,
        drop_prob: float = 0.0, fp_prob: float = 0.0,
        jitter_px: float = 0.0,
        degrade_prob: float = 0.0) -> SyntheticWorld:
    """Simulate objects with persistent appearance/geometry signatures.

    Objects move with constant velocity across the image, are born/die at
    random frames, may be dropped by the "detector" (drop_prob), spurious
    detections may appear (fp_prob), detector boxes may carry Gaussian
    corner jitter of ``jitter_px`` pixels, and with ``degrade_prob`` a true
    detection is DEGRADED (washed-out crop, sparse points — occlusion/blur):
    its per-detection statistics drift toward false-positive clutter, so a
    det head scores it low, while its (attenuated) signature still
    correlates with its track — exactly the case where LP-level y_det
    rejection (association evidence in the loop) beats post-hoc score
    thresholding (``gt_boxes2d`` stays clean, so
    devkit scoring matches against the true geometry — a realistic
    detector-noise regime for the quality gates).
    """
    T, N = num_frames, num_slots
    h, w = crop_size
    P = points_per_det

    # Per-object persistent signatures.
    sig_img = rng.normal(0, 1, (num_objects, h, w, 3)).astype(np.float32)
    sig_pts = rng.normal(0, 1, (num_objects, P, 4)).astype(np.float32)
    birth = rng.integers(0, max(T // 2, 1), num_objects)
    death = birth + rng.integers(T // 2, T + 1, num_objects)
    x0 = rng.uniform(100, IMG_W - 200, num_objects)
    y0 = rng.uniform(120, 250, num_objects)
    vx = rng.uniform(-6, 6, num_objects)
    vy = rng.uniform(-1.5, 1.5, num_objects)
    bw = rng.uniform(40, 140, num_objects)
    bh = rng.uniform(30, 90, num_objects)

    crops = np.zeros((T, N, h, w, 3), np.float32)
    points = np.zeros((T, N, P, 4), np.float32)
    point_mask = np.zeros((T, N, P), bool)
    det_mask = np.zeros((T, N), bool)
    boxes2d = np.zeros((T, N, 4), np.float32)
    gt_boxes2d = np.zeros((T, N, 4), np.float32)
    gt_ids = np.full((T, N), -1, np.int32)
    scores = np.zeros((T, N), np.float32)
    gt_alive = np.zeros((T, num_objects), bool)
    gt_traj_boxes = np.zeros((T, num_objects, 4), np.float32)

    for t in range(T):
        # Full GT trajectories, independent of detector noise.
        for k in range(num_objects):
            cx, cy = x0[k] + vx[k] * t, y0[k] + vy[k] * t
            if birth[k] <= t < death[k] and 0 <= cx <= IMG_W \
                    and 0 <= cy <= IMG_H:
                gt_alive[t, k] = True
                gt_traj_boxes[t, k] = (cx - bw[k] / 2, cy - bh[k] / 2,
                                       cx + bw[k] / 2, cy + bh[k] / 2)
        slot = 0
        order = rng.permutation(num_objects)  # slot order varies per frame
        for k in order:
            if not (birth[k] <= t < death[k]) or slot >= N:
                continue
            if rng.random() < drop_prob:
                continue
            cx, cy = x0[k] + vx[k] * t, y0[k] + vy[k] * t
            if not (0 <= cx <= IMG_W and 0 <= cy <= IMG_H):
                continue
            if degrade_prob > 0 and rng.random() < degrade_prob:
                # Degraded TP: attenuated signature + clutter-level noise.
                crops[t, slot] = (0.3 * sig_img[k]
                                  + rng.normal(0, 0.38, (h, w, 3)))
                npts = rng.integers(2, max(P // 4, 3))
                points[t, slot, :npts] = (0.3 * sig_pts[k][:npts]
                                          + rng.normal(0, 0.38, (npts, 4)))
            else:
                crops[t, slot] = sig_img[k] + appear_noise * rng.normal(
                    0, 1, (h, w, 3))
                npts = rng.integers(P // 2, P + 1)
                points[t, slot, :npts] = (sig_pts[k][:npts]
                                          + appear_noise * rng.normal(
                                              0, 1, (npts, 4)))
            point_mask[t, slot, :npts] = True
            clean = np.array((cx - bw[k] / 2, cy - bh[k] / 2,
                              cx + bw[k] / 2, cy + bh[k] / 2), np.float32)
            gt_boxes2d[t, slot] = clean
            boxes2d[t, slot] = clean + (
                rng.normal(0, jitter_px, 4).astype(np.float32)
                if jitter_px > 0 else 0.0)
            gt_ids[t, slot] = k
            det_mask[t, slot] = True
            scores[t, slot] = rng.uniform(0.7, 1.0)
            slot += 1
        # False positives: one-frame lifetime, drawn from the SAME
        # per-detection distribution as a degraded true detection (a fresh
        # fake signature at the degraded contrast).  A per-detection head
        # therefore CANNOT fully separate them from degraded TPs — only
        # temporal correlation can, which is exactly the evidence the
        # y_det ILP has and a post-hoc score threshold does not.  (Against
        # CLEAR detections the head still separates easily.)
        while slot < N and rng.random() < fp_prob:
            fake_sig = rng.normal(0, 1, (h, w, 3))
            crops[t, slot] = 0.3 * fake_sig + rng.normal(0, 0.38,
                                                         (h, w, 3))
            nfp = rng.integers(2, max(P // 4, 3))
            points[t, slot, :nfp] = (0.3 * rng.normal(0, 1, (nfp, 4))
                                     + rng.normal(0, 0.38, (nfp, 4)))
            point_mask[t, slot, :nfp] = True
            cx, cy = rng.uniform(100, IMG_W - 100), rng.uniform(100, 300)
            boxes2d[t, slot] = (cx - 30, cy - 20, cx + 30, cy + 20)
            gt_boxes2d[t, slot] = boxes2d[t, slot]
            det_mask[t, slot] = True
            gt_ids[t, slot] = -1
            scores[t, slot] = rng.uniform(0.3, 0.7)
            slot += 1

    return SyntheticWorld(crops=crops, points=points, point_mask=point_mask,
                          det_mask=det_mask, boxes2d=boxes2d, gt_ids=gt_ids,
                          scores=scores, gt_boxes2d=gt_boxes2d,
                          gt_alive=gt_alive, gt_traj_boxes=gt_traj_boxes)


def association_labels(gt_ids_prev: np.ndarray, gt_ids_curr: np.ndarray,
                       mask_prev: np.ndarray, mask_curr: np.ndarray
                       ) -> Dict[str, np.ndarray]:
    """GT link/new/end targets from track IDs of an adjacent frame pair.

    Mirrors the reference's GT generation (reference: utils/data_util.py —
    link matrix from shared track ids, new/end indicators).  False positives
    (id -1) still get new/end = 1 here (they match nothing), but
    ``tracking_loss`` EXCLUDES id<0 rows from association supervision —
    under the y_det ILP an FP's correct decision is rejection, and its
    supervision is the det-confidence BCE (train/losses.py).
    """
    N = gt_ids_prev.shape[-1]
    same = (gt_ids_prev[..., :, None] == gt_ids_curr[..., None, :])
    valid_pair = (mask_prev[..., :, None] & mask_curr[..., None, :]
                  & (gt_ids_prev[..., :, None] >= 0))
    link = (same & valid_pair).astype(np.float32)
    linked_prev = link.sum(-1) > 0
    linked_curr = link.sum(-2) > 0
    end = (mask_prev & ~linked_prev).astype(np.float32)
    new = (mask_curr & ~linked_curr).astype(np.float32)
    return {"link": link, "new": new, "end": end}


def make_training_batch(rng: np.random.Generator, batch_size: int = 4,
                        num_slots: int = 8,
                        crop_size: Tuple[int, int] = (32, 32),
                        points_per_det: int = 16,
                        **world_kw) -> Dict[str, np.ndarray]:
    """Adjacent-frame-pair training batches (reference sample_max_len=2)."""
    out = {k: [] for k in ("crops", "points", "point_mask", "boxes",
                           "det_mask", "gt_link", "gt_new", "gt_end",
                           "gt_ids")}
    for _ in range(batch_size):
        world = make_synthetic_sequence(
            rng, num_frames=2, num_slots=num_slots, crop_size=crop_size,
            points_per_det=points_per_det, **world_kw)
        lab = association_labels(world.gt_ids[0], world.gt_ids[1],
                                 world.det_mask[0], world.det_mask[1])
        out["crops"].append(world.crops)
        out["points"].append(world.points)
        out["point_mask"].append(world.point_mask)
        out["boxes"].append(world.boxes2d)
        out["det_mask"].append(world.det_mask)
        out["gt_ids"].append(world.gt_ids)
        out["gt_link"].append(lab["link"][None])
        out["gt_new"].append(lab["new"][None])
        out["gt_end"].append(lab["end"][None])
    return {k: np.stack(v) for k, v in out.items()}
