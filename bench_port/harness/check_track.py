"""What decides ``correct`` in a tracking cell: the program's outputs of a
window, held against the plain reference (``reference/mmmot.py``) on
the same frames and weights.

Three numbers are compared, each over the sampled sequences of the
sampled window:

- ``feat_err``: the widest relative gap of one detection's embedding,
  ``|program - reference|`` over the larger of ``|reference|`` and the
  median of the frame's ``|reference|``, over the valid detections of
  the window's last frame and the three branches (the program hands
  these on in its final state);
- ``det_err``: the widest gap of a det score (a sigmoid) over every
  valid detection of the window;
- ``assoc_gap``: the widest amount by which the program's decisions of
  one frame pair (read from its ids) fall below the LP's optimum, both
  scored by the reference.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_port.reference.mmmot import (BRANCHES, Ref, assoc_gap,
                                        crops_of, exact_matmuls,
                                        frustum_points, pair_scores,
                                        resize_dtype)


def sequence_features(ref: Ref, images, clouds, boxes, det_mask, proj,
                      crop, P) -> List[Dict[str, torch.Tensor]]:
    """Features of the valid detections of each of T frames (images [T,
    H, W, 3] ...), the trunk run over all of them in blocks."""
    crops, pts, pms, counts = [], [], [], []
    rd = resize_dtype(ref.cfg)
    for t in range(len(det_mask)):
        b = boxes[t][det_mask[t]]
        counts.append(len(b))
        if len(b):
            crops.append(crops_of(images[t], b, crop, rd))
            p, m = frustum_points(clouds[t], b, proj, P)
            pts.append(p)
            pms.append(m)
    if not crops:
        return [dict() for _ in counts]
    feats = ref.extract(torch.cat(crops), torch.cat(pts), torch.cat(pms))
    out, at = [], 0
    for n in counts:
        out.append({k: v[at:at + n] for k, v in feats.items()})
        at += n
    return out


@torch.no_grad()
def readings(ref: Ref, frames: dict, prev: dict, got: dict, crop,
             P) -> Dict[str, float]:
    """The three numbers of one sequence's window.

    ``frames``: images [T, H, W, 3], clouds, boxes, det_mask [T, N] of
    the window and ``proj``; ``prev``: the frame before it (one frame of
    each, ``ids`` [N] as the program gave them); ``got``: the program's
    ``ids`` [T, N] (numpy), ``det_score`` [T, N] and ``last`` {branch:
    [N, D]} embeddings of the last frame."""
    with exact_matmuls():
        seq = sequence_features(
            ref, torch.cat([prev["images"][None], frames["images"]]),
            torch.cat([prev["clouds"][None], frames["clouds"]]),
            torch.cat([prev["boxes"][None], frames["boxes"]]),
            torch.cat([prev["det_mask"][None], frames["det_mask"]]),
            frames["proj"], crop, P)
        masks = np.concatenate([prev["det_mask"].cpu().numpy()[None],
                                frames["det_mask"].cpu().numpy()])
        ids = np.concatenate([prev["ids"][None], got["ids"]])
        det_gaps, gaps, feat_gaps = [], [], []
        for t in range(1, len(seq)):
            f = seq[t]
            if not f:
                continue
            want = torch.sigmoid(ref.det_logit(f["fused"]))
            have = got["det_score"][t - 1][frames["det_mask"][t - 1]].float()
            det_gaps.append((have - want).abs())
            if seq[t - 1]:
                gaps.append(assoc_gap(ref, seq[t - 1], f,
                                      ids[t - 1][masks[t - 1]],
                                      ids[t][masks[t]]))
        last_mask = frames["det_mask"][-1]
        if seq[-1]:
            for b in BRANCHES:
                want = seq[-1][b]
                have = got["last"][b][last_mask].float()
                norm = want.norm(dim=-1)
                feat_gaps.append((have - want).norm(dim=-1) / torch.maximum(
                    norm, norm.median()).clamp_min(1e-12))
        det = torch.cat(det_gaps) if det_gaps else torch.zeros(1)
        feat = torch.cat(feat_gaps) if feat_gaps else torch.zeros(1)
        gaps = gaps or [0.0]
    return {"feat_err": float(feat.max()),
            "feat_err_median": float(feat.median()),
            "det_err": float(det.max()), "det_err_mean": float(det.mean()),
            "assoc_gap": max(gaps), "assoc_gap_mean": sum(gaps) / len(gaps)}


@torch.no_grad()
def reference_outputs(ref: Ref, frames: dict, prev: dict, crop,
                      P) -> dict:
    """What the reference ``ref`` (the control: the reference in a lower
    precision) would hand on in the program's place for one sequence's
    window: its det scores, its last frame's embeddings, and ids from its
    own exact decisions (a fresh id for every detection it leaves
    unmatched)."""
    from scipy.optimize import linear_sum_assignment

    with exact_matmuls():
        seq = sequence_features(
            ref, torch.cat([prev["images"][None], frames["images"]]),
            torch.cat([prev["clouds"][None], frames["clouds"]]),
            torch.cat([prev["boxes"][None], frames["boxes"]]),
            torch.cat([prev["det_mask"][None], frames["det_mask"]]),
            frames["proj"], crop, P)
        dm = frames["det_mask"].cpu().numpy()
        T, N = dm.shape
        ids = np.full((T, N), -1, np.int64)
        det = torch.zeros((T, N), device=frames["det_mask"].device)
        prev_ids = prev["ids"][prev["det_mask"].cpu().numpy()]
        fresh = int(max(prev["ids"].max(), 0)) + 1
        for t in range(1, T + 1):
            f = seq[t]
            cur = np.full(int(dm[t - 1].sum()), -1, np.int64)
            if f:
                det[t - 1][frames["det_mask"][t - 1]] = torch.sigmoid(
                    ref.det_logit(f["fused"]))
                if seq[t - 1]:
                    link, new, end = pair_scores(ref, seq[t - 1], f)
                    g = (link.double() - end.double()[:, None]
                         - new.double()[None, :]).cpu().numpy()
                    r, c = linear_sum_assignment(np.maximum(g, 0.0),
                                                 maximize=True)
                    for i, j in zip(r, c):
                        if g[i, j] > 0.0:
                            cur[j] = prev_ids[i]
            for j in range(len(cur)):
                if cur[j] < 0:
                    cur[j], fresh = fresh, fresh + 1
            ids[t - 1][dm[t - 1]] = cur
            prev_ids = cur
        last = {}
        for b in BRANCHES:
            v = torch.zeros((N, ref.cfg["fusion"]["out_dim"]),
                            device=frames["det_mask"].device)
            if seq[T]:
                v[frames["det_mask"][-1]] = seq[T][b]
            last[b] = v
    return {"ids": ids, "det_score": det, "last": last}
