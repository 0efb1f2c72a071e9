"""Persistent packed-sequence cache: port of
``mmmot_tpu/data/packed_cache.py``.

With ``data.packed_cache`` a whole-sequence load of
``KittiTrackingDataset.load_sequence`` writes the packed
``SequenceArrays`` to ``<root>/.packed/<seq>-<key>/``, one ``.npy`` a
field and a ``manifest.json`` written last, and later loads memory-map
it (images and clouds) instead of decoding PNG and velodyne files.  The
layout, the key and the manifest are the reference's, byte for byte, so
a tree packed by either package reads the same in the other.

The key covers every setting that changes the packed bytes (detection
source and score threshold, slots, class filter, cloud filter and
capacity, point source, frame count) and the size and mtime of the
label, detection and calib txts.  Image and velodyne edits that keep the
frame count are not fingerprinted: delete ``<root>/.packed/`` after
such an edit.  Only whole-sequence loads (``start == 0``, ``max_frames``
None) are cached.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

_FIELDS = ("images", "clouds", "cloud_valid", "boxes", "det_mask",
           "scores", "gt_ids", "proj", "frame_ids", "boxes3d", "has_3d",
           "velo_to_rect", "cls_ids")
_MANIFEST = "manifest.json"
_FORMAT = 2    # the reference's format: with cls_ids


def _stat_sig(path: str):
    try:
        st = os.stat(path)
        return [int(st.st_size), int(st.st_mtime_ns)]
    except OSError:
        return None


def cache_key(ds, seq: str, n_frames: int) -> str:
    """Fingerprint of everything that shapes the packed arrays (the
    reference's payload, serialised as it serialises it)."""
    cfg, root = ds.cfg, ds.root
    det_path = os.path.join(root, "detections", cfg.det_source,
                            f"{seq}.txt")
    payload = {
        "format": _FORMAT,
        "seq": seq,
        "n_frames": n_frames,
        "max_dets": cfg.max_dets,
        "det_source": cfg.det_source,
        "score_threshold": cfg.score_threshold,
        "cloud_filter": cfg.cloud_filter,
        "point_source": cfg.point_source,
        "class_filter": list(ds.class_filter),
        "max_cloud_points": ds.max_cloud_points,
        "det_stat": _stat_sig(det_path),
        "label_stat": _stat_sig(os.path.join(root, "label_02",
                                             f"{seq}.txt")),
        "calib_stat": _stat_sig(os.path.join(root, "calib", f"{seq}.txt")),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _cache_dir(ds, seq: str, key: str) -> str:
    return os.path.join(ds.root, ".packed", f"{seq}-{key}")


def load(ds, seq: str, n_frames: int):
    """The cached ``SequenceArrays`` (images and clouds memory-mapped),
    or None on a miss."""
    from mmmot_tpu_torch.data.kitti_dataset import SequenceArrays

    d = _cache_dir(ds, seq, cache_key(ds, seq, n_frames))
    manifest = os.path.join(d, _MANIFEST)
    if not os.path.exists(manifest):   # the manifest marks a whole entry
        return None
    with open(manifest) as fh:
        fields = json.load(fh)["fields"]
    return SequenceArrays(**{
        name: np.load(os.path.join(d, f"{name}.npy"),
                      mmap_mode="r" if name in ("images", "clouds")
                      else None)
        for name in fields})


def save(ds, seq: str, n_frames: int, arrs) -> None:
    """Write the packed arrays: into a directory of this process, renamed
    into place whole (a concurrent writer that renamed first wins, and
    this one's directory is removed)."""
    d = _cache_dir(ds, seq, cache_key(ds, seq, n_frames))
    if os.path.exists(os.path.join(d, _MANIFEST)):
        return
    tmp = f"{d}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    fields = []
    for name in _FIELDS:
        v = getattr(arrs, name, None)
        if v is None:
            continue
        np.save(os.path.join(tmp, f"{name}.npy"), np.asarray(v))
        fields.append(name)
    with open(os.path.join(tmp, _MANIFEST), "w") as fh:
        json.dump({"format": _FORMAT, "fields": fields}, fh)
    try:
        os.rename(tmp, d)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
