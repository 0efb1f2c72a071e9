"""Detection-pickle ingestion: external detector outputs -> KITTI-format
detection txt files; port of ``mmmot_tpu/data/det_convert.py``, writing
through the port's ``data/kitti_io.py``.

The reference consumes pre-computed detections shipped as pickle files
(from RRC or PointPillars).  Their exact schema is not known, so the
loader accepts the common layouts:

* ``{frame_idx: ndarray [n, >=4]}`` — columns l,t,r,b[,score]
* ``{frame_idx: {"bbox"|"boxes": [n, >=4], "scores"|"score": [n],
  optional "dimensions"/"location"/"rotation_y" for 3D dets}}``
* ``[per-frame entries]`` — list indexed by frame, same per-frame forms

SECURITY: pickle deserialization executes arbitrary code — only convert
files you trust.  The loader is a host-side offline tool (like the
reference's prep scripts); nothing in the serving/tracking path reads
pickles.

CLI:
    python -m mmmot_tpu_torch.data.det_convert dets_0000.pkl \\
        out/0000.txt --type Car [--min-score 0.0]
"""

from __future__ import annotations

import pickle
from typing import Dict, List

import numpy as np

from mmmot_tpu_torch.data.kitti_io import KittiObject, write_kitti_result


def _to_objects(frame: int, entry, obj_type: str,
                min_score: float) -> List[KittiObject]:
    if entry is None:
        return []
    if isinstance(entry, dict):
        boxes = np.asarray(entry.get("bbox", entry.get("boxes", [])),
                           np.float64).reshape(-1, 4)
        n = len(boxes)
        scores = entry.get("scores", entry.get("score"))
        scores = (np.asarray(scores, np.float64).reshape(-1) if scores
                  is not None else np.ones(n))
        dims = np.asarray(entry.get("dimensions",
                                    np.zeros((n, 3)))).reshape(-1, 3)
        locs = np.asarray(entry.get("location",
                                    np.zeros((n, 3)))).reshape(-1, 3)
        rys = np.asarray(entry.get("rotation_y",
                                   np.full(n, -10.0))).reshape(-1)
    else:
        arr = np.asarray(entry, np.float64)
        if arr.size == 0:
            return []
        arr = arr.reshape(-1, arr.shape[-1])
        boxes = arr[:, :4]
        n = len(boxes)
        scores = arr[:, 4] if arr.shape[1] > 4 else np.ones(n)
        dims = np.zeros((n, 3))
        locs = np.zeros((n, 3))
        rys = np.full(n, -10.0)
    out = []
    for k in range(len(boxes)):
        if scores[k] < min_score:
            continue
        out.append(KittiObject(
            frame=frame, track_id=-1, obj_type=obj_type,
            bbox=boxes[k], dimensions=dims[k], location=locs[k],
            rotation_y=float(rys[k]), score=float(scores[k])))
    return out


def load_detection_pickle(path: str, obj_type: str = "Car",
                          min_score: float = 0.0
                          ) -> Dict[int, List[KittiObject]]:
    """Read a detection pickle into {frame: [KittiObject]} (UNSAFE: pickle)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    frames: Dict[int, List[KittiObject]] = {}
    if isinstance(data, dict):
        items = data.items()
    else:
        items = enumerate(data)
    for frame, entry in items:
        objs = _to_objects(int(frame), entry, obj_type, min_score)
        if objs:
            frames[int(frame)] = objs
    return frames


def convert_detection_pickle(in_path: str, out_path: str,
                             obj_type: str = "Car",
                             min_score: float = 0.0) -> int:
    """pickle -> KITTI-format det txt (readable by KittiTrackingDataset).

    Returns the number of detections written.
    """
    frames = load_detection_pickle(in_path, obj_type, min_score)
    objs = [o for f in sorted(frames) for o in frames[f]]
    write_kitti_result(objs, out_path)
    return len(objs)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pkl")
    ap.add_argument("out")
    ap.add_argument("--type", default="Car")
    ap.add_argument("--min-score", type=float, default=0.0)
    args = ap.parse_args(argv)
    n = convert_detection_pickle(args.pkl, args.out, args.type,
                                 args.min_score)
    print(f"{n} detections -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
