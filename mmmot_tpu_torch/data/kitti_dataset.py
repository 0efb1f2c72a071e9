"""Real KITTI tracking dataset reader + padded-array packer (host side).

Rebuild of the reference data layer (reference: root dataset classes +
utils/data_util.py: KITTI label parsing, detection loading, per-det crop /
point extraction; SURVEY.md §2.14/§2.15/§2.18) with one structural change:
the packer emits *full frames + boxes + clouds* in fixed-shape padded
arrays, and all per-detection extraction happens on-device
(ops/crop_resize.py, ops/frustum.py).

Expected tree (standard KITTI tracking layout):

    root/
      image_02/<seq>/<frame>.png
      velodyne/<seq>/<frame>.bin
      label_02/<seq>.txt          (GT; also usable as oracle detections)
      calib/<seq>.txt
      detections/<det_source>/<seq>.txt   (optional, KITTI-format dets)

Detections default to GT boxes ("oracle" mode) when no detection files are
present, which is also how parity fixtures are produced.

The port's copy of ``mmmot_tpu/data/kitti_dataset.py``: PNG frames are
decoded by ``data/png.py`` (numpy and zlib) in place of PIL, all frames of
a sequence in one batch.  The arrays must equal the reference's field by
field.  With ``data.packed_cache`` two caches of the reference's layout
sit under ``<root>/.packed/``: every decoded frame as
``frames/<seq>/<png>-<size>-<mtime_ns>.npy`` (training pairs read
random offsets, which the sequence cache never serves), and whole
sequences (``data/packed_cache.py``); a tree cached by either package
reads the same in the other.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from mmmot_tpu_torch.config import DataConfig
from mmmot_tpu_torch.data.calib import Calibration
from mmmot_tpu_torch.data.kitti_io import (KittiObject,
                                           read_kitti_tracking_labels)
from mmmot_tpu_torch.data.png import read_pngs

IMG_H, IMG_W = 376, 1248            # pad target (covers all KITTI cams)


@dataclass
class SequenceArrays:
    """One packed sequence for the raw-frames tracker."""

    images: np.ndarray          # [T, H, W, 3] uint8
    clouds: np.ndarray          # [T, M, 4] float32 (velodyne frame)
    cloud_valid: np.ndarray     # [T, M] bool
    boxes: np.ndarray           # [T, N, 4] float32
    det_mask: np.ndarray        # [T, N] bool
    scores: np.ndarray          # [T, N] float32
    gt_ids: np.ndarray          # [T, N] int32 (-1 when no GT match)
    proj: np.ndarray            # [3, 4] velodyne -> image projection
    frame_ids: np.ndarray       # [T] original frame indices
    boxes3d: np.ndarray = None  # [T, N, 7] KITTI (h,w,l,x,y,z,ry) rect
    has_3d: np.ndarray = None   # [T, N] bool — detection carries a 3D box
    velo_to_rect: np.ndarray = None   # [3, 4] velodyne -> rect transform
    cls_ids: np.ndarray = None  # [T, N] int8 — class-group index per det
                                # (KittiTrackingDataset.CLASS_GROUPS;
                                # -1 invalid).  Drives the joint multi-
                                # class association gate + result types.


class KittiTrackingDataset:
    """Sequence-level access to a KITTI tracking split."""

    # Types grouped with each trackable class: the devkit treats the extra
    # types as "ignored" for that class (neither TP nor FN), so tracking
    # them alongside costs nothing and matches the reference's Car+Van
    # handling (eval/kitti_devkit.py IGNORED_BY_CLASS).
    CLASS_FILTERS = {"car": ("car", "van"),
                     "pedestrian": ("pedestrian", "person_sitting"),
                     "cyclist": ("cyclist",),
                     # Joint single-pass multi-class (track_class "All"):
                     # every trackable group in one program; per-det class
                     # ids (CLASS_GROUPS indices) ride SequenceArrays.
                     "all": ("car", "van", "pedestrian", "person_sitting",
                             "cyclist")}
    # Canonical group per raw KITTI type and the result-row type written
    # for each group (vans track with cars and are written as Car — the
    # devkit ignores Van rows for the car class, same as per-class mode).
    CLASS_GROUPS = ("Car", "Pedestrian", "Cyclist")
    GROUP_OF = {"car": 0, "van": 0, "pedestrian": 1, "person_sitting": 1,
                "cyclist": 2}

    def __init__(self, cfg: DataConfig, max_cloud_points: int = 65536,
                 class_filter: Optional[Tuple[str, ...]] = None):
        self.cfg = cfg
        self.root = cfg.root
        self.max_cloud_points = max_cloud_points
        if class_filter is None:
            class_filter = self.CLASS_FILTERS[cfg.track_class.lower()]
        self.class_filter = tuple(c.lower() for c in class_filter)
        img_root = os.path.join(self.root, "image_02")
        if not os.path.isdir(img_root):
            raise FileNotFoundError(f"no KITTI tracking tree at {self.root}")
        self.sequences = sorted(os.listdir(img_root))
        self.decode_s = 0.0          # seconds spent decoding PNG frames

    # ------------------------------------------------------------------
    def _frames(self, seq: str) -> List[str]:
        d = os.path.join(self.root, "image_02", seq)
        return sorted(f for f in os.listdir(d) if f.endswith(".png"))

    def _frame_cache_path(self, seq: str, fname: str) -> str:
        """The frame cache's file of ``fname``, keyed by the PNG's size and
        mtime (a stale entry is never hit again)."""
        st = os.stat(os.path.join(self.root, "image_02", seq, fname))
        return os.path.join(self.root, ".packed", "frames", seq,
                            f"{fname}-{st.st_size}-{st.st_mtime_ns}.npy")

    def _load_images(self, seq: str, fnames: List[str]) -> np.ndarray:
        """Decode frames and pad each to IMG_H x IMG_W: [T, H, W, 3]
        uint8.  The decode time adds to ``self.decode_s``.  With the
        packed cache a frame decoded before is read from its ``.npy``,
        and a frame decoded now is written there."""
        out = np.zeros((len(fnames), IMG_H, IMG_W, 3), np.uint8)
        cpaths = ([self._frame_cache_path(seq, f) for f in fnames]
                  if self.cfg.packed_cache else [None] * len(fnames))
        todo = []
        for t, cpath in enumerate(cpaths):
            if cpath is not None and os.path.exists(cpath):
                out[t] = np.load(cpath, mmap_mode="r")
            else:
                todo.append(t)
        if not todo:
            return out
        t0 = time.perf_counter()
        imgs = read_pngs([os.path.join(self.root, "image_02", seq,
                                       fnames[t]) for t in todo])
        self.decode_s += time.perf_counter() - t0
        for t, img in zip(todo, imgs):
            h, w = min(img.shape[0], IMG_H), min(img.shape[1], IMG_W)
            out[t, :h, :w] = img[:h, :w]
            if cpaths[t] is not None:
                os.makedirs(os.path.dirname(cpaths[t]), exist_ok=True)
                tmp = f"{cpaths[t]}.tmp-{os.getpid()}.npy"
                np.save(tmp, out[t])
                os.replace(tmp, cpaths[t])
        return out

    def _load_image(self, seq: str, fname: str) -> np.ndarray:
        return self._load_images(seq, [fname])[0]

    def _load_cloud(self, seq: str, frame: str) -> np.ndarray:
        path = os.path.join(self.root, "velodyne", seq,
                            frame.replace(".png", ".bin"))
        if not os.path.exists(path):
            return np.zeros((0, 4), np.float32)
        return np.fromfile(path, np.float32).reshape(-1, 4)

    @staticmethod
    def _filter_cloud_to_boxes(pc: np.ndarray, boxes: np.ndarray,
                               proj: np.ndarray,
                               margin: float = 4.0) -> np.ndarray:
        """Scan-order points whose projection falls inside any detection
        box (dilated by ``margin`` px, depth > 0.05) — a strict superset
        of the device frustum criterion (ops/frustum.py: inside box,
        depth > 0.1), so on-device per-detection selection is unchanged.
        A raw KITTI scan is ~120k azimuth-ordered points; truncating it
        to M cuts a spatial wedge, while this keeps every box-relevant
        point AND shrinks what ships to the chip."""
        if len(pc) == 0 or len(boxes) == 0:
            return pc[:0]
        uvw = pc[:, :3] @ proj[:, :3].T + proj[:, 3]
        w = uvw[:, 2]
        safe_w = np.where(np.abs(w) < 1e-9, 1e-9, w)
        u, v = uvw[:, 0] / safe_w, uvw[:, 1] / safe_w
        inside = np.zeros(len(pc), bool)
        for left, top, right, bottom in boxes:
            inside |= ((u >= left - margin) & (u <= right + margin)
                       & (v >= top - margin) & (v <= bottom + margin))
        return pc[inside & (w > 0.05)]

    def _load_detections(self, seq: str) -> Dict[int, List[KittiObject]]:
        det_dir = os.path.join(self.root, "detections", self.cfg.det_source)
        path = os.path.join(det_dir, f"{seq}.txt")
        if os.path.exists(path):
            return read_kitti_tracking_labels(path)
        # Oracle mode: GT boxes as detections.
        gt_path = os.path.join(self.root, "label_02", f"{seq}.txt")
        return read_kitti_tracking_labels(gt_path)

    def _load_gt(self, seq: str) -> Dict[int, List[KittiObject]]:
        path = os.path.join(self.root, "label_02", f"{seq}.txt")
        if not os.path.exists(path):
            return {}
        return read_kitti_tracking_labels(path)

    # ------------------------------------------------------------------
    def load_sequence(self, seq: str, start: int = 0,
                      max_frames: Optional[int] = None) -> SequenceArrays:
        cfg = self.cfg
        # Whole-sequence loads with the packed cache memory-map the
        # arrays of an earlier load (data/packed_cache.py).
        use_cache = cfg.packed_cache and start == 0 and max_frames is None
        if use_cache:
            from mmmot_tpu_torch.data import packed_cache

            n_frames = len(self._frames(seq))
            cached = packed_cache.load(self, seq, n_frames)
            if cached is not None:
                return cached
        N = cfg.max_dets
        frames = self._frames(seq)[start:]
        if max_frames is not None:
            frames = frames[:max_frames]
        T = len(frames)
        M = self.max_cloud_points
        calib = Calibration.from_file(
            os.path.join(self.root, "calib", f"{seq}.txt"))
        dets = self._load_detections(seq)
        gt = self._load_gt(seq)

        images = self._load_images(seq, frames)
        boxes = np.zeros((T, N, 4), np.float32)
        boxes3d = np.zeros((T, N, 7), np.float32)
        has_3d = np.zeros((T, N), bool)
        det_mask = np.zeros((T, N), bool)
        scores = np.zeros((T, N), np.float32)
        gt_ids = np.full((T, N), -1, np.int32)
        cls_ids = np.full((T, N), -1, np.int8)
        frame_ids = np.zeros((T,), np.int32)

        # Host cloud prefilter (cfg.cloud_filter): only meaningful for the
        # 2D-box frustum criterion — box3d selection is in 3D, where an
        # image-plane filter could drop in-box points.
        filter_boxes = (cfg.cloud_filter == "boxes"
                        and cfg.point_source == "frustum")
        proj = calib.projection_matrix().astype(np.float32)
        pcs = []

        for t, fname in enumerate(frames):
            fid = int(fname.split(".")[0])
            frame_ids[t] = fid

            objs = [o for o in dets.get(fid, [])
                    if o.obj_type.lower() in self.class_filter
                    and (o.score is None
                         or o.score >= cfg.score_threshold)][:N]
            pc = self._load_cloud(seq, fname)
            if filter_boxes:
                frame_boxes = (np.stack([o.bbox for o in objs])
                               if objs else np.zeros((0, 4), np.float32))
                pc = self._filter_cloud_to_boxes(pc, frame_boxes, proj)
                pcs.append(pc[:M])
            else:
                # Copy: a [:M] VIEW would pin every raw ~120k-point scan
                # in memory until the whole sequence is packed.
                pcs.append(pc[:M].copy())
            gt_objs = [o for o in gt.get(fid, [])
                       if o.obj_type.lower() in self.class_filter]
            for n, o in enumerate(objs):
                boxes[t, n] = o.bbox
                det_mask[t, n] = True
                scores[t, n] = 1.0 if o.score is None else o.score
                cls_ids[t, n] = self.GROUP_OF.get(o.obj_type.lower(), 0)
                # KITTI 3D fields (rotation_y == -10 marks 2D-only dets).
                if o.rotation_y > -10.0 and np.any(o.dimensions > 0):
                    boxes3d[t, n] = np.concatenate(
                        [o.dimensions, o.location, [o.rotation_y]])
                    has_3d[t, n] = True
            # GT ids by one-to-one Hungarian matching on IoU (>= 0.5) so no
            # two detections can claim the same GT track (reference:
            # utils/data_util.py GT link-label generation; SURVEY.md §3.4) —
            # a double assignment would put two 1s in one association-label
            # row and corrupt the training target.
            if objs and gt_objs:
                det_b = np.stack([o.bbox for o in objs])
                gt_b = np.stack([g.bbox for g in gt_objs])
                ious = _iou_pair(det_b, gt_b)
                # Class-consistent GT assignment (joint multi-class: a
                # pedestrian det must not claim an overlapping car GT).
                same = (cls_ids[t, :len(objs), None]
                        == np.asarray([self.GROUP_OF.get(
                            g.obj_type.lower(), 0)
                            for g in gt_objs], np.int8)[None, :])
                cost = np.where((ious >= 0.5) & same, 1.0 - ious, 1e9)
                rows, cols = _lsa(cost)
                for r, c in zip(rows, cols):
                    if ious[r, c] >= 0.5 and same[r, c]:
                        gt_ids[t, r] = gt_objs[c].track_id

        # Pack clouds.  Filtered mode shrinks the padded M to a 4096
        # bucket of the sequence's true max (fewer host->device bytes;
        # bucketing keeps the number of distinct compiled shapes small).
        if filter_boxes:
            m_eff = max((len(p) for p in pcs), default=0)
            m_eff = min(M, max(4096, -(-m_eff // 4096) * 4096))
        else:
            m_eff = M
        clouds = np.zeros((T, m_eff, 4), np.float32)
        cloud_valid = np.zeros((T, m_eff), bool)
        for t, pc in enumerate(pcs):
            clouds[t, :len(pc)] = pc
            cloud_valid[t, :len(pc)] = True

        arrs = SequenceArrays(images=images, clouds=clouds,
                              cloud_valid=cloud_valid, boxes=boxes,
                              det_mask=det_mask, scores=scores,
                              gt_ids=gt_ids,
                              proj=proj,
                              frame_ids=frame_ids,
                              boxes3d=boxes3d, has_3d=has_3d,
                              velo_to_rect=calib.velo_to_rect_matrix()
                              .astype(np.float32),
                              cls_ids=cls_ids)
        if use_cache:
            packed_cache.save(self, seq, n_frames, arrs)
        return arrs

    def training_pairs(self, seq: str, rng: np.random.Generator,
                       num_pairs: int):
        """Yield ``num_pairs`` adjacent-frame pairs of ``seq`` (two-frame
        ``SequenceArrays``), each starting at a frame drawn from
        ``rng``."""
        frames = self._frames(seq)
        if len(frames) < 2:
            return
        for _ in range(num_pairs):
            t0 = int(rng.integers(0, len(frames) - 1))
            yield self.load_sequence(seq, start=t0, max_frames=2)


def _iou_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [Na, 4] x [Nb, 4] (l, t, r, b) boxes."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


def _lsa(cost: np.ndarray):
    import scipy.optimize as sopt

    return sopt.linear_sum_assignment(cost)
