"""KITTI tracking label / result file I/O (host side).

The port's copy of ``mmmot_tpu/data/kitti_io.py``: result files must be
byte-equal to the reference's.

File format (per the KITTI tracking devkit, one object per line):

    frame track_id type truncated occluded alpha
    bbox_left bbox_top bbox_right bbox_bottom
    height width length x y z rotation_y [score]

The reference parses these in utils/data_util.py and writes results with
``write_kitti_result``; the devkit reads them back for scoring.  We keep the
format bit-identical so result files interoperate with the official devkit
and with the reference's outputs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

KITTI_TYPES = ("Car", "Van", "Truck", "Pedestrian", "Person_sitting",
               "Cyclist", "Tram", "Misc", "DontCare")


@dataclass
class KittiObject:
    frame: int
    track_id: int
    obj_type: str
    truncated: float = 0.0
    occluded: int = 0
    alpha: float = -10.0
    bbox: np.ndarray = field(default_factory=lambda: np.zeros(4))  # l,t,r,b
    dimensions: np.ndarray = field(default_factory=lambda: np.zeros(3))  # h,w,l
    location: np.ndarray = field(default_factory=lambda: np.zeros(3))  # x,y,z
    rotation_y: float = -10.0
    score: Optional[float] = None

    def to_line(self) -> str:
        parts = [
            str(self.frame), str(self.track_id), self.obj_type,
            f"{self.truncated:.6f}", str(int(self.occluded)),
            f"{self.alpha:.6f}",
            *(f"{v:.6f}" for v in self.bbox),
            *(f"{v:.6f}" for v in self.dimensions),
            *(f"{v:.6f}" for v in self.location),
            f"{self.rotation_y:.6f}",
        ]
        if self.score is not None:
            parts.append(f"{self.score:.6f}")
        return " ".join(parts)

    @staticmethod
    def from_line(line: str) -> "KittiObject":
        f = line.split()
        if len(f) < 17:
            raise ValueError(f"malformed KITTI line ({len(f)} fields): "
                             f"{line!r}")
        return KittiObject(
            frame=int(float(f[0])), track_id=int(float(f[1])), obj_type=f[2],
            truncated=float(f[3]), occluded=int(float(f[4])),
            alpha=float(f[5]),
            bbox=np.array([float(x) for x in f[6:10]]),
            dimensions=np.array([float(x) for x in f[10:13]]),
            location=np.array([float(x) for x in f[13:16]]),
            rotation_y=float(f[16]),
            score=float(f[17]) if len(f) > 17 else None,
        )


def read_kitti_tracking_labels(path: str) -> Dict[int, List[KittiObject]]:
    """Read one sequence's label/result txt -> {frame: [objects]}."""
    frames: Dict[int, List[KittiObject]] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            obj = KittiObject.from_line(line)
            frames.setdefault(obj.frame, []).append(obj)
    return frames


def write_kitti_result(objects: Sequence[KittiObject], path: str) -> None:
    """Write one sequence's tracking result (reference: utils/data_util.py
    write_kitti_result — KITTI 17(+score)-column txt)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ordered = sorted(objects, key=lambda o: (o.frame, o.track_id))
    with open(path, "w") as fh:
        for o in ordered:
            fh.write(o.to_line() + "\n")


def package_submission(res_dir: str, zip_path: str) -> List[str]:
    """Package a result directory as a KITTI tracking-benchmark submission.

    The KITTI server expects a zip with one ``<seq>.txt`` per test sequence
    at the archive root (the reference leaves this step to the user after
    ``eval_seq.py`` writes its txts — same txts, same names here).  Only
    four-digit sequence files are packaged; devkit side-products
    (``summary_<cls>.txt``, ``hota_<cls>.txt``, ``thr_*/`` sweep dirs) are
    skipped.  Returns the packaged sequence file names.
    """
    import re
    import zipfile

    names = sorted(f for f in os.listdir(res_dir)
                   if re.fullmatch(r"\d{4}\.txt", f))
    if not names:
        raise FileNotFoundError(
            f"no NNNN.txt sequence results in {res_dir!r} to package")
    os.makedirs(os.path.dirname(zip_path) or ".", exist_ok=True)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for n in names:
            zf.write(os.path.join(res_dir, n), arcname=n)
    return names


def tracker_output_to_objects(ids: np.ndarray, det_mask: np.ndarray,
                              boxes2d: np.ndarray,
                              scores: Optional[np.ndarray] = None,
                              boxes3d: Optional[np.ndarray] = None,
                              obj_type: str = "Car",
                              frame_ids: Optional[np.ndarray] = None,
                              has_3d: Optional[np.ndarray] = None,
                              obj_types: Optional[np.ndarray] = None,
                              type_names: Optional[List[str]] = None
                              ) -> List[KittiObject]:
    """Convert padded tracker outputs into KITTI objects.

    ids [T, N] int32 (-1 invalid), det_mask [T, N] bool,
    boxes2d [T, N, 4] (l, t, r, b), scores [T, N] optional,
    boxes3d [T, N, 7] optional as (h, w, l, x, y, z, rot_y),
    frame_ids [T] optional KITTI frame numbers (default: the row index),
    has_3d [T, N] optional per-detection 3D validity (default: every det
    when boxes3d is given; 2D-only dets keep the -10 rotation sentinel).
    ``obj_types`` [T, N] optional per-detection class-group indices into
    ``type_names`` (joint multi-class; overrides ``obj_type``).
    """
    out: List[KittiObject] = []
    T, N = ids.shape
    for t in range(T):
        for n in range(N):
            if not det_mask[t, n] or ids[t, n] < 0:
                continue
            frame = int(frame_ids[t]) if frame_ids is not None else t
            typ = obj_type
            if obj_types is not None and type_names is not None \
                    and obj_types[t, n] >= 0:
                typ = type_names[int(obj_types[t, n])]
            obj = KittiObject(frame=frame, track_id=int(ids[t, n]),
                              obj_type=typ,
                              bbox=np.asarray(boxes2d[t, n], float))
            if boxes3d is not None and (has_3d is None or has_3d[t, n]):
                obj.dimensions = np.asarray(boxes3d[t, n, :3], float)
                obj.location = np.asarray(boxes3d[t, n, 3:6], float)
                obj.rotation_y = float(boxes3d[t, n, 6])
            if scores is not None:
                obj.score = float(scores[t, n])
            out.append(obj)
    return out
