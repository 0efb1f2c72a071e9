"""Adjacent-frame-pair training batches from a KITTI tracking tree: port
of ``mmmot_tpu/data/kitti_loader.py``.

The host reads frames, clouds and boxes (``kitti_dataset.py``); the crops
(the per-slot resize of each frame, ``crop_and_resize_batched``) and the
frustum samples are made on the device, and the association labels come
from ``synthetic.association_labels``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mmmot_tpu_torch.config import DataConfig
from mmmot_tpu_torch.data.kitti_dataset import (KittiTrackingDataset,
                                                SequenceArrays)
from mmmot_tpu_torch.data.synthetic import association_labels
from mmmot_tpu_torch.device import resolve_device
from mmmot_tpu_torch.ops.crop_resize import (crop_and_resize_batched,
                                             normalize_crops)
from mmmot_tpu_torch.ops.frustum import frustum_sample_batched

MAX_CLOUD_POINTS = 32768        # a frame's cloud is cut to its first points


class KittiPairLoader:
    """Training batches of adjacent frame pairs.  Each sample draws a
    sequence, then a start frame, from a numpy generator seeded with
    ``seed`` (the reference's order of draws)."""

    def __init__(self, cfg: DataConfig, seed: int = 0,
                 sequences: Optional[Tuple[str, ...]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.ds = KittiTrackingDataset(cfg, max_cloud_points=MAX_CLOUD_POINTS)
        self.sequences = (list(sequences) if sequences is not None
                          else self.ds.sequences)
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    def preprocess(self, arrs: SequenceArrays):
        """(crops [T, N, h, w, 3], points [T, N, P, 4], point_mask [T, N,
        P]) of a packed pair, on the device."""
        dev = self.device
        images, clouds, valid, boxes, det_mask, proj = (
            torch.as_tensor(x, device=dev) for x in (
                arrs.images, arrs.clouds, arrs.cloud_valid, arrs.boxes,
                arrs.det_mask, arrs.proj))
        crops = crop_and_resize_batched(images.float(), boxes,
                                        tuple(self.cfg.crop_size), det_mask)
        crops = normalize_crops(crops, scale=1.0 / 255.0)
        pts, pmask = frustum_sample_batched(
            clouds, boxes, proj, self.cfg.point_len, det_mask=det_mask,
            point_valid=valid)
        return crops, pts, pmask

    def sample(self) -> Optional[Dict[str, torch.Tensor]]:
        """One training sample ([1, ...] labels), or None when the drawn
        sequence has fewer than two frames."""
        seqs = self.sequences
        seq = seqs[int(self.rng.integers(len(seqs)))]
        pair = next(iter(self.ds.training_pairs(seq, self.rng, 1)), None)
        if pair is None:
            return None
        crops, pts, pmask = self.preprocess(pair)
        lab = association_labels(pair.gt_ids[0], pair.gt_ids[1],
                                 pair.det_mask[0], pair.det_mask[1])
        dev = self.device
        return {"crops": crops, "points": pts, "point_mask": pmask,
                "boxes": torch.as_tensor(pair.boxes, device=dev),
                "det_mask": torch.as_tensor(pair.det_mask, device=dev),
                "gt_ids": torch.as_tensor(pair.gt_ids, device=dev),
                **{f"gt_{k}": torch.as_tensor(lab[k][None], device=dev)
                   for k in ("link", "new", "end")}}

    def batches(self, batch_size: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Endless [B, 2, ...] batches (a drawn sequence without a pair
        leaves the batch one sample short)."""
        while True:
            samples = [s for s in (self.sample() for _ in range(batch_size))
                       if s is not None]
            if not samples:
                raise RuntimeError("no usable training pairs found")
            yield {k: torch.stack([s[k] for s in samples])
                   for k in samples[0]}
