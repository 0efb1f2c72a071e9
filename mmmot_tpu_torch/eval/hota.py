"""HOTA tracking metrics (Luiten et al., IJCV 2020) for KITTI.

The port's copy of ``mmmot_tpu/eval/hota.py`` (numpy and scipy only); it
must score a result set exactly as the reference does.

The official KITTI tracking benchmark replaced CLEAR MOT with HOTA as its
headline metric in 2021 (scored by TrackEval); a user of the reference
(which bundles only the CLEAR devkit, kitti_devkit/evaluate_tracking.py)
migrating here gets both.  This implements the TrackEval algorithm
(trackeval/metrics/hota.py) over the SAME KITTI preprocessing semantics as
the CLEAR port in :mod:`mmmot_tpu_torch.eval.kitti_devkit`:

* tracker boxes are filtered to the evaluated class;
* GT of a distractor class ("Van" for car, "Person_sitting" for
  pedestrian) or above the truncation threshold is ignored: it is removed
  from the GT set, and tracker boxes that match it (preliminary Hungarian
  at IoU >= 0.5 against valid+ignored GT jointly, so a box matching a
  valid GT better is never stolen) are removed from the tracker set;
* unmatched tracker boxes inside "DontCare" regions
  (intersection-over-detection-area > 0.5) are removed.

Algorithm per sequence (TrackEval):

1. Accumulate ``potential_matches[i, j] = sum_t iou / (row_sum + col_sum -
   iou)`` and per-track detection counts; the global alignment score is the
   Jaccard ``potential / (|gt_i| + |pred_j| - potential)``.
2. For each localisation threshold alpha in {0.05, ..., 0.95}: per frame,
   Hungarian-match on ``global_alignment * iou``, keep matches with
   ``iou >= alpha``; accumulate TP/FN/FP, per-pair match counts and
   localisation sums.
3. ``DetA = TP / (TP+FN+FP)``; ``AssA = mean over TPs of TPA /
   (TPA+FNA+FPA)``; ``HOTA_alpha = sqrt(DetA * AssA)``; HOTA is the mean
   over the 19 alphas.

Sequences combine exactly like TrackEval's ``combine_sequences``: TP/FN/FP
and the TP-weighted association/localisation sums add per alpha.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.optimize as sopt

from mmmot_tpu_torch.data.kitti_io import (KittiObject,
                                           read_kitti_tracking_labels)
from mmmot_tpu_torch.eval.kitti_devkit import (IGNORED_BY_CLASS,
                                               intersection_over_area,
                                               iou_2d)

ALPHAS = np.arange(0.05, 0.96, 0.05)
_EPS = np.finfo("float64").eps


@dataclass
class HotaMetrics:
    """Alpha-averaged HOTA family (fractions in [0, 1])."""

    hota: float = 0.0
    deta: float = 0.0
    assa: float = 0.0
    detre: float = 0.0
    detpr: float = 0.0
    assre: float = 0.0
    asspr: float = 0.0
    loca: float = 0.0
    # Per-alpha curves (length 19), for the HOTA(0) / LocA(0) style analyses.
    hota_alpha: np.ndarray = field(default_factory=lambda: np.zeros(0))
    alphas: np.ndarray = field(default_factory=lambda: ALPHAS.copy())

    def summary(self) -> str:
        return (f"HOTA {self.hota*100:6.2f}%  DetA {self.deta*100:6.2f}%  "
                f"AssA {self.assa*100:6.2f}%  DetRe {self.detre*100:5.2f}%  "
                f"DetPr {self.detpr*100:5.2f}%  AssRe {self.assre*100:5.2f}%  "
                f"AssPr {self.asspr*100:5.2f}%  LocA {self.loca*100:5.2f}%")

    def summary_text(self) -> str:
        s = "HOTA evaluation summary:\n"
        for label, v in (("HOTA", self.hota), ("DetA", self.deta),
                         ("AssA", self.assa), ("DetRe", self.detre),
                         ("DetPr", self.detpr), ("AssRe", self.assre),
                         ("AssPr", self.asspr), ("LocA", self.loca)):
            s += f" {label:<68}{v:.6f}\n"
        s += "=" * 80 + "\n"
        return s


class _SeqFrames:
    """Preprocessed per-sequence frame data: compact ids + similarities."""

    def __init__(self):
        self.frames: List[tuple] = []  # (gt_idx [n_g], trk_idx [n_t], sim)
        self.gt_ids: Dict[int, int] = {}
        self.trk_ids: Dict[int, int] = {}

    def gid(self, tid: int) -> int:
        return self.gt_ids.setdefault(tid, len(self.gt_ids))

    def pid(self, tid: int) -> int:
        return self.trk_ids.setdefault(tid, len(self.trk_ids))


class HotaEvaluation:
    """Accumulates HOTA over sequences; mirror of TrackingEvaluation usage:
    ``add_sequence(gt_frames, trk_frames)`` then ``compute()``."""

    def __init__(self, cls: str = "car", max_truncation: float = 0.15,
                 preproc_overlap: float = 0.5):
        self.cls = cls.lower()
        self.max_truncation = max_truncation
        self.preproc_overlap = preproc_overlap
        self.seqs: List[_SeqFrames] = []

    # ------------------------------------------------------------------
    def add_sequence(self, gt: Dict[int, List[KittiObject]],
                     trk: Dict[int, List[KittiObject]],
                     num_frames: Optional[int] = None) -> None:
        cls = self.cls
        distractors = tuple(t.lower() for t in IGNORED_BY_CLASS.get(cls, ()))
        last = max(list(gt.keys()) + list(trk.keys()) + [-1])
        num_frames = num_frames if num_frames is not None else last + 1
        sf = _SeqFrames()

        for f in range(num_frames):
            gt_objs = gt.get(f, [])
            trk_objs = [o for o in trk.get(f, [])
                        if o.obj_type.lower() == cls]
            gt_valid, gt_ignored = [], []
            dontcare = []
            for o in gt_objs:
                t = o.obj_type.lower()
                if t == cls:
                    (gt_ignored if o.truncated > self.max_truncation
                     else gt_valid).append(o)
                elif t in distractors:
                    gt_ignored.append(o)
                elif t == "dontcare":
                    dontcare.append(o)

            trk_boxes = np.array([o.bbox for o in trk_objs]).reshape(-1, 4)
            val_boxes = np.array([o.bbox for o in gt_valid]).reshape(-1, 4)

            # Preliminary removal match against valid+ignored GT jointly:
            # a tracker box is dropped only when its assigned GT is an
            # ignored one (so it can never be stolen from a valid GT it
            # overlaps better).
            drop = np.zeros(len(trk_objs), bool)
            matched_to_valid = np.zeros(len(trk_objs), bool)
            all_gt = gt_valid + gt_ignored
            if all_gt and trk_objs:
                all_boxes = np.array([o.bbox for o in all_gt]).reshape(-1, 4)
                ov = iou_2d(all_boxes, trk_boxes)
                costs = np.where(ov >= self.preproc_overlap, 1.0 - ov, 1e9)
                rows, cols = sopt.linear_sum_assignment(costs)
                for r, c in zip(rows, cols):
                    if ov[r, c] >= self.preproc_overlap:
                        if r >= len(gt_valid):
                            drop[c] = True
                        else:
                            matched_to_valid[c] = True
            # DontCare absorption of boxes not matched to valid GT.
            if dontcare and trk_objs:
                dc_boxes = np.array([o.bbox for o in dontcare]
                                    ).reshape(-1, 4)
                ioa = intersection_over_area(trk_boxes, dc_boxes)
                drop |= (ioa > 0.5).any(axis=1) & ~matched_to_valid

            keep_idx = [i for i in range(len(trk_objs)) if not drop[i]]
            kept_boxes = trk_boxes[keep_idx] if keep_idx else \
                np.zeros((0, 4))
            sim = iou_2d(val_boxes, kept_boxes)
            g_idx = np.array([sf.gid(o.track_id) for o in gt_valid],
                             np.int64)
            t_idx = np.array([sf.pid(trk_objs[i].track_id)
                              for i in keep_idx], np.int64)
            sf.frames.append((g_idx, t_idx, sim))
        self.seqs.append(sf)

    # ------------------------------------------------------------------
    def compute(self) -> HotaMetrics:
        A = len(ALPHAS)
        tp = np.zeros(A)
        fn = np.zeros(A)
        fp = np.zeros(A)
        ass_sum = np.zeros(A)    # sum over TPs of TPA/(TPA+FNA+FPA)
        assre_sum = np.zeros(A)  # sum over TPs of TPA/(TPA+FNA)
        asspr_sum = np.zeros(A)  # sum over TPs of TPA/(TPA+FPA)
        loc_sum = np.zeros(A)    # sum over TPs of the matched IoU

        for sf in self.seqs:
            G, Tk = len(sf.gt_ids), len(sf.trk_ids)
            if G == 0 and Tk == 0:
                continue
            gt_count = np.zeros(G)
            trk_count = np.zeros(Tk)
            potential = np.zeros((G, Tk))
            for g_idx, t_idx, sim in sf.frames:
                gt_count[g_idx] += 1
                trk_count[t_idx] += 1
                if len(g_idx) and len(t_idx):
                    denom = (sim.sum(0)[None, :] + sim.sum(1)[:, None]
                             - sim)
                    sim_iou = np.where(denom > _EPS,
                                       sim / np.maximum(denom, _EPS), 0.0)
                    potential[np.ix_(g_idx, t_idx)] += sim_iou
            if G and Tk:
                align = potential / np.maximum(
                    gt_count[:, None] + trk_count[None, :] - potential,
                    _EPS)
            else:
                align = np.zeros((G, Tk))

            matches = np.zeros((A, G, Tk))
            for g_idx, t_idx, sim in sf.frames:
                n_g, n_t = len(g_idx), len(t_idx)
                if n_g and n_t:
                    score = align[np.ix_(g_idx, t_idx)] * sim
                    rows, cols = sopt.linear_sum_assignment(-score)
                    m_sim = sim[rows, cols]
                    for a, alpha in enumerate(ALPHAS):
                        ok = m_sim >= alpha - _EPS
                        n_m = int(ok.sum())
                        tp[a] += n_m
                        fn[a] += n_g - n_m
                        fp[a] += n_t - n_m
                        loc_sum[a] += m_sim[ok].sum()
                        matches[a][g_idx[rows[ok]], t_idx[cols[ok]]] += 1
                else:
                    fn += n_g
                    fp += n_t
            for a in range(A):
                m = matches[a]
                if not m.any():
                    continue
                union = gt_count[:, None] + trk_count[None, :] - m
                ass_sum[a] += (m * (m / np.maximum(union, _EPS))).sum()
                assre_sum[a] += (m * (m / np.maximum(gt_count[:, None],
                                                     _EPS))).sum()
                asspr_sum[a] += (m * (m / np.maximum(trk_count[None, :],
                                                     _EPS))).sum()

        out = HotaMetrics()
        tp_safe = np.maximum(tp, 1.0)
        deta = tp / np.maximum(tp + fn + fp, _EPS)
        assa = ass_sum / tp_safe
        hota_a = np.sqrt(deta * assa)
        out.hota_alpha = hota_a
        out.hota = float(hota_a.mean())
        out.deta = float(deta.mean())
        out.assa = float(assa.mean())
        out.detre = float((tp / np.maximum(tp + fn, _EPS)).mean())
        out.detpr = float((tp / np.maximum(tp + fp, _EPS)).mean())
        out.assre = float((assre_sum / tp_safe).mean())
        out.asspr = float((asspr_sum / tp_safe).mean())
        # TrackEval: LocA = max(eps, loc_sum)/max(eps, TP) — an alpha with
        # zero TPs contributes 1.0, not 0.
        out.loca = float(np.where(tp > 0, loc_sum / tp_safe, 1.0).mean())
        return out


def evaluate_hota(gt_dir: str, result_dir: str, sequences: Sequence[str],
                  cls: str = "car", summary_dir: Optional[str] = None,
                  num_frames: Optional[Dict[str, int]] = None
                  ) -> HotaMetrics:
    """Score result txts with HOTA (same file layout as
    :func:`mmmot_tpu_torch.eval.kitti_devkit.evaluate_tracking`)."""
    ev = HotaEvaluation(cls=cls)
    for seq in sequences:
        gt = read_kitti_tracking_labels(os.path.join(gt_dir, f"{seq}.txt"))
        trk = read_kitti_tracking_labels(
            os.path.join(result_dir, f"{seq}.txt"))
        nf = num_frames.get(seq) if num_frames else None
        ev.add_sequence(gt, trk, num_frames=nf)
    m = ev.compute()
    if summary_dir:
        os.makedirs(summary_dir, exist_ok=True)
        with open(os.path.join(summary_dir, f"hota_{cls}.txt"), "w") as f:
            f.write(m.summary_text())
    return m
