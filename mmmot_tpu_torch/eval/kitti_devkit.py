"""KITTI tracking evaluation — CLEAR MOT metrics port.

The port's copy of ``mmmot_tpu/eval/kitti_devkit.py`` (numpy and scipy
only); it must score a result set exactly as the reference does.

Behaviour-identical rebuild of the devkit the reference bundles
(reference: kitti_devkit/evaluate_tracking.py -> trackingEvaluation):
per-frame Hungarian matching of GT to tracker boxes at IoU >= 0.5,
accumulation of TP/FP/FN, trajectory-level MT/PT/ML, ID switches and
fragmentations, and the summary metrics MOTA, MOTP, recall, precision, F1,
FAR.  scipy's Hungarian replaces the reference's ``munkres`` dependency.

Ignore semantics mirror the devkit:
* for class "Car", GT of type "Van" is *ignored* (neither TP nor FN, and a
  tracker box matching one is not FP); same for "Person_sitting" when
  evaluating "Pedestrian";
* "DontCare" GT regions absorb otherwise-unmatched tracker boxes by
  intersection-over-detection-area > 0.5;
* GT with truncation above threshold is ignored.

ID-switch/fragmentation semantics (devkit state machine): for each GT
trajectory, the last matched tracker id persists across untracked gaps; a
later match with a different id counts one IDS.  A tracked->untracked
transition (with the trajectory continuing afterwards) counts one FRAG.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.optimize as sopt

from mmmot_tpu_torch.data.kitti_io import (KittiObject,
                                           read_kitti_tracking_labels)

IGNORED_BY_CLASS = {"car": ("van",), "pedestrian": ("person_sitting",)}


def iou_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [Na, 4] x [Nb, 4] boxes (l, t, r, b)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def intersection_over_area(det: np.ndarray, dc: np.ndarray) -> np.ndarray:
    """Intersection over *detection* area vs DontCare regions."""
    if len(det) == 0 or len(dc) == 0:
        return np.zeros((len(det), len(dc)))
    lt = np.maximum(det[:, None, :2], dc[None, :, :2])
    rb = np.minimum(det[:, None, 2:], dc[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    return inter / np.maximum(area[:, None], 1e-9)


@dataclass
class TrackingMetrics:
    mota: float = 0.0
    motp: float = 0.0
    moda: float = 0.0
    modp: float = 0.0
    recall: float = 0.0
    precision: float = 0.0
    f1: float = 0.0
    far: float = 0.0
    mt: float = 0.0
    pt: float = 0.0
    ml: float = 0.0
    id_switches: int = 0
    fragments: int = 0
    tp: int = 0
    fp: int = 0
    fn: int = 0
    n_gt: int = 0
    n_gt_trajectories: int = 0
    n_tracker_trajectories: int = 0
    # Ignore-machinery accounting (diagnostics; not devkit-summary fields):
    # tracker boxes absorbed by ignored GT (Van/Person_sitting/truncated)
    # or DontCare regions instead of counting FP, and GT rows moved to the
    # ignored set instead of counting FN.
    absorbed: int = 0
    ignored_gt: int = 0

    def summary(self) -> str:
        return (f"MOTA {self.mota*100:6.2f}%  MOTP {self.motp*100:6.2f}%  "
                f"R {self.recall*100:5.2f}%  P {self.precision*100:5.2f}%  "
                f"MT {self.mt*100:5.2f}%  ML {self.ml*100:5.2f}%  "
                f"IDS {self.id_switches}  FRAG {self.fragments}  "
                f"TP {self.tp}  FP {self.fp}  FN {self.fn}")

    def summary_text(self) -> str:
        """Devkit-format stats block (reference: createSummary /
        ``summary_<class>.txt`` emission in evaluate_tracking.py)."""
        def e(label, value, fmt="{:.6f}"):
            v = fmt.format(value) if isinstance(value, float) else str(value)
            return f" {label:<68}{v}\n"

        s = "tracking evaluation summary:\n"
        s += e("Multiple Object Tracking Accuracy (MOTA)", self.mota)
        s += e("Multiple Object Tracking Precision (MOTP)", self.motp)
        s += e("Multiple Object Detection Accuracy (MODA)", self.moda)
        s += e("Multiple Object Detection Precision (MODP)", self.modp)
        s += "\n"
        s += e("Recall", self.recall)
        s += e("Precision", self.precision)
        s += e("F1", self.f1)
        s += e("False Alarm Rate", self.far)
        s += "\n"
        s += e("Mostly Tracked", self.mt)
        s += e("Partly Tracked", self.pt)
        s += e("Mostly Lost", self.ml)
        s += "\n"
        s += e("True Positives", self.tp)
        s += e("False Positives", self.fp)
        s += e("Missed Targets", self.fn)
        s += e("ID-switches", self.id_switches)
        s += e("Fragmentations", self.fragments)
        s += "\n"
        s += e("Ground Truth Objects (Total)", self.n_gt)
        s += e("Ground Truth Trajectories", self.n_gt_trajectories)
        s += e("Tracker Trajectories", self.n_tracker_trajectories)
        s += "=" * 80 + "\n"
        return s


class TrackingEvaluation:
    """Accumulates CLEAR MOT statistics over sequences.

    Usage: ``add_sequence(gt_frames, tracker_frames)`` per sequence, then
    ``compute()``.  Frames are dicts {frame_idx: [KittiObject]}.
    """

    def __init__(self, cls: str = "car", min_overlap: float = 0.5,
                 max_truncation: float = 0.15, mt_threshold: float = 0.8,
                 ml_threshold: float = 0.2, boundary: str = "strict"):
        if boundary not in ("strict", "closed"):
            raise ValueError(f"boundary must be strict/closed, "
                             f"got {boundary!r}")
        self.cls = cls.lower()
        self.min_overlap = min_overlap
        self.max_truncation = max_truncation
        self.mt_threshold = mt_threshold
        self.ml_threshold = ml_threshold
        self.boundary = boundary
        self.tp = self.fp = self.fn = 0
        self.absorbed = self.ignored_gt = 0
        self.total_overlap = 0.0
        self.n_gt = 0
        self.n_frames = 0
        self.modp_sum = 0.0
        self.tracker_ids: set = set()
        self.seq_gt_traj: List[Dict[int, List[int]]] = []
        self.seq_gt_ignored: List[Dict[int, List[bool]]] = []

    # ------------------------------------------------------------------
    def add_sequence(self, gt: Dict[int, List[KittiObject]],
                     trk: Dict[int, List[KittiObject]],
                     num_frames: Optional[int] = None) -> None:
        cls = self.cls
        ignored_types = tuple(t.lower() for t in IGNORED_BY_CLASS.get(cls, ()))
        last = max(list(gt.keys()) + list(trk.keys()) + [-1])
        num_frames = num_frames if num_frames is not None else last + 1
        self.n_frames += num_frames

        # Per-GT-trajectory per-frame assigned tracker id (-1 unmatched) and
        # ignored flags, for the trajectory-level pass.
        traj: Dict[int, List[int]] = {}
        traj_ign: Dict[int, List[bool]] = {}
        all_gt_ids = sorted({o.track_id for objs in gt.values()
                             for o in objs
                             if o.obj_type.lower() == cls})
        for tid in all_gt_ids:
            traj[tid] = [-1] * num_frames
            traj_ign[tid] = [True] * num_frames

        for f in range(num_frames):
            gt_objs = gt.get(f, [])
            # Tracker results are filtered to the evaluated class (devkit
            # loadTracker keeps only the class under evaluation).
            trk_objs = [o for o in trk.get(f, [])
                        if o.obj_type.lower() == cls]
            self.tracker_ids.update(
                (len(self.seq_gt_traj), o.track_id) for o in trk_objs)

            gt_eval = [o for o in gt_objs if o.obj_type.lower() == cls]
            gt_ignored_cls = [o for o in gt_objs
                              if o.obj_type.lower() in ignored_types]
            dontcare = [o for o in gt_objs
                        if o.obj_type.lower() == "dontcare"]

            # GT of the evaluated class above truncation threshold is
            # ignored (devkit: moved to the ignored set, not FN).
            gt_valid, gt_ign = [], []
            for o in gt_eval:
                (gt_ign if o.truncated > self.max_truncation
                 else gt_valid).append(o)

            trk_boxes = np.array([o.bbox for o in trk_objs]).reshape(-1, 4)
            val_boxes = np.array([o.bbox for o in gt_valid]).reshape(-1, 4)

            # Hungarian on IoU, threshold min_overlap.
            matched_trk = np.zeros(len(trk_objs), bool)
            frame_pairs: List[Tuple[int, int, float]] = []
            if len(gt_valid) and len(trk_objs):
                overlaps = iou_2d(val_boxes, trk_boxes)
                costs = np.where(overlaps >= self.min_overlap,
                                 1.0 - overlaps, 1e9)
                rows, cols = sopt.linear_sum_assignment(costs)
                for r, c in zip(rows, cols):
                    if overlaps[r, c] >= self.min_overlap:
                        frame_pairs.append((r, c, overlaps[r, c]))
                        matched_trk[c] = True

            self.tp += len(frame_pairs)
            self.fn += len(gt_valid) - len(frame_pairs)
            self.n_gt += len(gt_valid)
            self.total_overlap += sum(p[2] for p in frame_pairs)
            # Per-frame detection precision for MODP: mean mapped overlap;
            # frames with nothing to map count 1.0 (perfect) when no valid
            # GT exists, 0.0 when GT went entirely unmapped.
            if frame_pairs:
                self.modp_sum += sum(p[2] for p in frame_pairs) / \
                    len(frame_pairs)
            elif not gt_valid:
                self.modp_sum += 1.0

            for r, c, _ in frame_pairs:
                tid = gt_valid[r].track_id
                traj[tid][f] = trk_objs[c].track_id
                traj_ign[tid][f] = False
            for o in gt_valid:
                traj_ign[o.track_id][f] = False

            # Unmatched tracker boxes: absorb into ignored GT / DontCare.
            um_idx = [i for i in range(len(trk_objs)) if not matched_trk[i]]
            um_boxes = trk_boxes[um_idx] if um_idx else \
                np.zeros((0, 4))
            absorbed = np.zeros(len(um_idx), bool)
            ign_boxes = np.array(
                [o.bbox for o in gt_ignored_cls + gt_ign]).reshape(-1, 4)
            if len(um_idx) and len(ign_boxes):
                ov = iou_2d(um_boxes, ign_boxes)
                absorbed |= (ov >= self.min_overlap).any(axis=1)
            dc_boxes = np.array([o.bbox for o in dontcare]).reshape(-1, 4)
            if len(um_idx) and len(dc_boxes):
                ioa = intersection_over_area(um_boxes, dc_boxes)
                absorbed |= (ioa > 0.5).any(axis=1)
            self.fp += int((~absorbed).sum())
            self.absorbed += int(absorbed.sum())
            self.ignored_gt += len(gt_ignored_cls) + len(gt_ign)

        self.seq_gt_traj.append(traj)
        self.seq_gt_ignored.append(traj_ign)

    # ------------------------------------------------------------------
    def compute(self) -> TrackingMetrics:
        m = TrackingMetrics(tp=self.tp, fp=self.fp, fn=self.fn,
                            n_gt=self.n_gt, absorbed=self.absorbed,
                            ignored_gt=self.ignored_gt)
        ids = frag = 0
        mt = pt = ml = 0
        n_traj = 0
        for traj, traj_ign in zip(self.seq_gt_traj, self.seq_gt_ignored):
            for tid, g in traj.items():
                ign = traj_ign[tid]
                frames = [f for f in range(len(g)) if not ign[f]]
                if not frames:
                    continue
                n_traj += 1
                tracked = sum(1 for f in frames if g[f] >= 0)
                coverage = tracked / len(frames)
                # MT/PT/ML boundary convention, selectable because the
                # reference mount is unavailable to settle it ([VERIFY]
                # SURVEY §2.17; round-1 advice claimed the closed form,
                # round-2 review the strict form):
                #   strict (ships): coverage > 0.8 -> MT, < 0.2 -> ML,
                #     PT covers the closed interval [0.2, 0.8] — matches
                #     the recalled devkit source (`if best > 0.8: MT
                #     elif best < 0.2: ML else PT`).
                #   closed: coverage >= 0.8 -> MT, <= 0.2 -> ML.
                # Exact-boundary trajectories (coverage == 0.2 or 0.8)
                # are the only ones affected; tests pin both behaviours.
                if self.boundary == "strict":
                    if coverage > self.mt_threshold:
                        mt += 1
                    elif coverage < self.ml_threshold:
                        ml += 1
                    else:
                        pt += 1
                else:
                    if coverage >= self.mt_threshold:
                        mt += 1
                    elif coverage <= self.ml_threshold:
                        ml += 1
                    else:
                        pt += 1
                # IDS: last matched id persists across gaps.
                last_id = -1
                prev_tracked = False
                for k, f in enumerate(frames):
                    cur = g[f]
                    if cur >= 0:
                        if last_id >= 0 and cur != last_id:
                            ids += 1
                        last_id = cur
                    # FRAG: tracked -> untracked with later coverage.
                    if prev_tracked and cur < 0 and any(
                            g[f2] >= 0 for f2 in frames[k:]):
                        frag += 1
                    prev_tracked = cur >= 0
        m.id_switches = ids
        m.fragments = frag
        m.n_gt_trajectories = n_traj
        m.n_tracker_trajectories = len(self.tracker_ids)
        if n_traj:
            m.mt, m.pt, m.ml = mt / n_traj, pt / n_traj, ml / n_traj
        if self.n_gt:
            m.mota = 1.0 - (self.fn + self.fp + ids) / self.n_gt
            m.moda = 1.0 - (self.fn + self.fp) / self.n_gt
            m.recall = self.tp / self.n_gt
        if self.tp:
            m.motp = self.total_overlap / self.tp
        if self.n_frames:
            m.modp = self.modp_sum / self.n_frames
            m.far = self.fp / self.n_frames
        if self.tp + self.fp:
            m.precision = self.tp / (self.tp + self.fp)
        if m.precision + m.recall > 0:
            m.f1 = 2 * m.precision * m.recall / (m.precision + m.recall)
        return m


def evaluate_tracking(gt_dir: str, result_dir: str,
                      sequences: Sequence[str], cls: str = "car",
                      per_sequence: bool = False,
                      summary_dir: Optional[str] = None,
                      num_frames: Optional[Dict[str, int]] = None):
    """Score result txt files against GT txt files (devkit ``evaluate``).

    ``gt_dir/<seq>.txt`` and ``result_dir/<seq>.txt`` per sequence.
    With ``per_sequence`` returns ``(overall, {seq: TrackingMetrics})``;
    with ``summary_dir`` also writes ``summary_<cls>.txt`` (devkit stats
    block) plus ``summary_<cls>_per_sequence.txt`` there.  ``num_frames``
    optionally maps sequence name -> frame count (a seqmap) like the
    devkit's per-sequence ``n_frames``;
    without it the count is inferred from the labels present.
    """
    ev = TrackingEvaluation(cls=cls)
    seq_metrics: Dict[str, TrackingMetrics] = {}
    for seq in sequences:
        gt = read_kitti_tracking_labels(os.path.join(gt_dir, f"{seq}.txt"))
        trk = read_kitti_tracking_labels(
            os.path.join(result_dir, f"{seq}.txt"))
        nf = num_frames.get(seq) if num_frames else None
        ev.add_sequence(gt, trk, num_frames=nf)
        if per_sequence or summary_dir:
            one = TrackingEvaluation(
                cls=cls, min_overlap=ev.min_overlap,
                max_truncation=ev.max_truncation,
                mt_threshold=ev.mt_threshold, ml_threshold=ev.ml_threshold,
                boundary=ev.boundary)
            one.add_sequence(gt, trk, num_frames=nf)
            seq_metrics[seq] = one.compute()
    overall = ev.compute()
    if summary_dir:
        os.makedirs(summary_dir, exist_ok=True)
        with open(os.path.join(summary_dir, f"summary_{cls}.txt"),
                  "w") as f:
            f.write(overall.summary_text())
        with open(os.path.join(summary_dir,
                               f"summary_{cls}_per_sequence.txt"),
                  "w") as f:
            for seq in sequences:
                f.write(f"{seq}: {seq_metrics[seq].summary()}\n")
    if per_sequence:
        return overall, seq_metrics
    return overall
