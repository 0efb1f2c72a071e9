"""Windowed KITTI tracking runner: port of
``mmmot_tpu/tracker/kitti_runner.py`` (``_crop_window``, ``_seq_plan``,
``track_kitti_sequences``).

Sequences of any length stream through fixed windows of ``window``
frames, with the ``TrackerState`` carried from window to window, so ids
continue across window boundaries.  The last window of a sequence is
padded with all-invalid frames.  Every window is one call of
``track_sequences_from_frames_batched`` for a group of
``batch_sequences`` sequences (the S axis: one fused-affinity launch and
one auction per window for the whole group; with S=1 it is
``track_sequence_from_frames``).  A loader thread
reads the next group (PNG decode, cloud read) while the device tracks the
current one.

With ghost coverage (``assoc.ghost_coverage``), each window also returns
the coverage rows of the tracks missing at each frame; they are written
into the result files beside the detections, under their track's id and
scored by its last det-head confidence, and filtered by that score in
the ``thr_<t>/`` sweep (as the reference does, ``score_threshold``
filters only the detections).

``track_class="All"`` tracks every class group in one pass with the
class gate (``assoc.class_gate``, which it requires): each window carries
the detections' class ids, a result row is written under its
detection's class (a coverage row under its track's), and the files are
scored once per class (``summary_<cls>.txt``, ``hota_<cls>.txt`` for
car, pedestrian and cyclist).

``dead_sensor`` ("camera" or "lidar") simulates a failed sensor on the
real pipeline: the dead modality's input work is skipped, the net runs
on the one left and the affinity scores the branches left (two for the
flagship), with a carried state that holds no feats of the dead branch.

Not ported, and raising ``NotImplementedError``: ``point_source="box3d"``
and ``packed_cache``.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mmmot_tpu_torch.config import DataConfig
from mmmot_tpu_torch.tracker.sequence import (
    check_dead_sensor, track_sequences_from_frames_batched)
from mmmot_tpu_torch.tracker.tracker import TrackingModule, stack_states


def _crop_window(boxes: np.ndarray, det_mask: np.ndarray,
                 frame_width: int) -> int:
    """Crop band width for a sequence: >= the widest valid box (a narrower
    band silently crops edge-replicated content), rounded to 128 so a
    handful of buckets cover a dataset, capped at the frame width.  The
    floor is 256: band slicing cost is linear in the window, and typical
    KITTI car boxes are well under 256 px wide."""
    widths = (boxes[..., 2] - boxes[..., 0])[det_mask]
    wmax = float(widths.max()) if widths.size else 0.0
    return int(min(max(256, -(-wmax // 128) * 128), frame_width))


def _seq_plan(arrs, window: int) -> Dict:
    """Per-sequence window parameters: windows, compaction capacity (the
    densest window's valid detections, in steps of 256, capped at
    window * N) and crop band."""
    T, N = arrs.det_mask.shape
    n_windows = max(1, -(-T // window))
    dens = max(int(arrs.det_mask[w * window:(w + 1) * window].sum())
               for w in range(n_windows))
    capacity = min(max(256, -(-dens // 256) * 256), window * N)
    crop_window = _crop_window(arrs.boxes, arrs.det_mask,
                               arrs.images.shape[2])
    return {"n_windows": n_windows, "capacity": capacity,
            "crop_window": crop_window}


def _unsupported(data_cfg: DataConfig) -> None:
    for what, bad in (
            ("data.point_source='box3d'", data_cfg.point_source == "box3d"),
            ("data.packed_cache", data_cfg.packed_cache)):
        if bad:
            raise NotImplementedError(f"{what} is not ported to "
                                      "mmmot_tpu_torch")


def _window(x: np.ndarray, w: int, W: int, M: Optional[int] = None):
    """Frames [w*W, (w+1)*W) of ``x``, zero-padded to W frames and, for
    clouds, to M points."""
    part = x[w * W:(w + 1) * W]
    if part.shape[0] == W and (M is None or x.shape[1] == M):
        return part
    shape = (W,) + ((M,) + x.shape[2:] if M is not None else x.shape[1:])
    buf = np.zeros(shape, x.dtype)
    buf[:part.shape[0], :part.shape[1]] = part
    return buf


def track_kitti_sequences(module: TrackingModule, data_cfg: DataConfig,
                          res_dir: str,
                          sequences: Optional[Sequence[str]] = None,
                          window: int = 64, chunk: int = 256,
                          score_threshold: float = 0.0,
                          score_sweep: Optional[Sequence[float]] = None,
                          evaluate: bool = True,
                          max_frames: Optional[int] = None,
                          batch_sequences: int = 1,
                          dead_sensor: Optional[str] = None,
                          log=None) -> Dict:
    """Track KITTI sequences, write result txts, optionally score them.

    Returns a stats dict: n_programs (distinct window shapes), n_dropped,
    total_frames, fps (frames over seconds of every window after the
    run's first, which pays the warm-up), and with ``evaluate``
    ``metrics`` (TrackingMetrics), ``hota`` and ``per_sequence`` (with
    ``track_class="All"``: ``metrics_by_class`` and ``hota_by_class``,
    keyed by class, in their place).  Also,
    for measurement: ``n_windows``, ``window_s`` (seconds per window
    call, the first included), ``load_s`` (seconds the loader spent
    reading groups), ``decode_s`` (of which PNG decoding) and
    ``frames_loaded``.

    ``outputs`` maps each sequence to its tracker output: ids [T, N],
    det_score [T, N] and the det_mask [T, N] it was run on, and with
    ghost coverage ghost_ids [T, N], ghost_boxes [T, N, 4] and
    ghost_scores [T, N].

    ``score_sweep`` writes the result txts again under
    ``res_dir/thr_<t>/`` for each det-head score threshold t, from the
    same tracked output, and scores them into ``stats["sweep"][t]`` (by
    class with ``track_class="All"``).
    """
    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.data.kitti_io import (read_kitti_tracking_labels,
                                               tracker_output_to_objects,
                                               write_kitti_result)
    from mmmot_tpu_torch.eval import HotaEvaluation, TrackingEvaluation

    _unsupported(data_cfg)
    check_dead_sensor(dead_sensor)
    joint = data_cfg.track_class == "All"
    if joint and not module.class_gating:
        raise ValueError(
            "track_class 'All' (joint multi-class) requires "
            "assoc.class_gate: true — without it the LP would link "
            "detections across classes")
    crop = tuple(data_cfg.crop_size)
    P = data_cfg.point_len
    ds = KittiTrackingDataset(data_cfg, max_cloud_points=32768)
    seqs = list(sequences) if sequences is not None else ds.sequences
    unknown = [s for s in seqs if s not in set(ds.sequences)]
    if unknown:
        raise SystemExit(f"unknown sequence name(s) {unknown}; available: "
                         f"{ds.sequences}")
    dev = module.device
    shapes = set()
    n_dropped = 0
    window_s: List[float] = []

    def run_group(members: List[str], arrs_l):
        """Track a group of sequences window by window; returns
        ([(seq, arrs, {"ids" [T', N], "det_score" [T', N] and the ghost
        outputs})], frames counted, seconds counted)."""
        nonlocal n_dropped
        plans = [_seq_plan(a, window) for a in arrs_l]
        S_b, W = len(members), window
        N = arrs_l[0].det_mask.shape[1]
        n_windows = max(p["n_windows"] for p in plans)
        capacity = max(p["capacity"] for p in plans)
        crop_window = max(p["crop_window"] for p in plans)
        shapes.add((S_b, W, capacity, crop_window))
        # Frustum ranks go by cloud index, so padding clouds to a common
        # M changes no sampled point: only a group needs one M.
        M_g = max(a.clouds.shape[1] for a in arrs_l)
        proj = torch.as_tensor(np.stack([a.proj for a in arrs_l]),
                               device=dev)
        state = stack_states([module.init_state(N, dead_sensor)
                              for _ in members])
        # Per output: its fill value and trailing shape (ghost outputs
        # have the N ghost slots of the 2N-slot state).
        fields = {"ids": (-1, ()), "det_score": (0.0, ())}
        if module.ghost_coverage:
            fields.update(ghost_ids=(-1, ()), ghost_boxes=(0.0, (4,)),
                          ghost_scores=(0.0, ()))
        res = [{k: np.full((n_windows * W, N) + tail, fill,
                           np.int32 if fill == -1 else np.float32)
                for k, (fill, tail) in fields.items()} for _ in members]
        frames_ctd, secs_ctd = 0, 0.0
        per_window = (("images", False), ("clouds", True),
                      ("cloud_valid", True), ("boxes", False),
                      ("det_mask", False)) + ((("cls_ids", False),)
                                              if joint else ())
        for w in range(n_windows):
            t0 = time.perf_counter()
            im, cl, cv, bx, dm, *dcl = (
                torch.as_tensor(np.stack([_window(getattr(a, f), w, W,
                                                  M_g if cloud else None)
                                          for a in arrs_l]), device=dev)
                for f, cloud in per_window)
            out, state = track_sequences_from_frames_batched(
                module, im, cl, bx, dm, proj, crop, P, cloud_valid=cv,
                compact_capacity=capacity, extract_chunk=chunk,
                crop_window=crop_window, state0=state, return_state=True,
                det_cls=dcl[0] if joint else None, dead_sensor=dead_sensor)
            o = {k: out[k].float().cpu().numpy() if fill == 0.0
                 else out[k].cpu().numpy() for k, (fill, _) in fields.items()}
            n_dropped += int(out["n_dropped"].sum())
            dt = time.perf_counter() - t0
            window_s.append(dt)
            if len(window_s) > 1:       # the run's first window warms up
                frames_ctd += sum(min(W, max(0, a.det_mask.shape[0] - w * W))
                                  for a in arrs_l)
                secs_ctd += dt
            for j, a in enumerate(arrs_l):
                n = min(W, max(0, a.det_mask.shape[0] - w * W))
                for k in fields:
                    res[j][k][w * W:w * W + n] = o[k][j][:n]
        if log:
            log.info("group %s: %d windows in %.2fs", ",".join(members),
                     n_windows, secs_ctd)
        return list(zip(members, arrs_l, res)), frames_ctd, secs_ctd

    # Joint classes: one tracking pass, scored once per class from the
    # same result files (the devkit evaluates one class at a time).
    eval_classes = (("car", "pedestrian", "cyclist") if joint
                    else (data_cfg.track_class.lower(),))
    evs = {c: TrackingEvaluation(cls=c) for c in eval_classes}
    hevs = {c: HotaEvaluation(cls=c) for c in eval_classes}
    sweep = tuple(score_sweep or ())
    sweep_evs = {thr: {c: TrackingEvaluation(cls=c) for c in eval_classes}
                 for thr in sweep}
    per_seq, outputs = {}, {}
    total_frames, t_total = 0, 0.0
    S_b = max(1, batch_sequences)
    groups = [seqs[i:i + S_b] for i in range(0, len(seqs), S_b)]
    load_s, frames_loaded = [0.0], [0]

    def load_group(members):
        t0 = time.perf_counter()
        arrs_l = [ds.load_sequence(s, max_frames=max_frames)
                  for s in members]
        load_s[0] += time.perf_counter() - t0
        frames_loaded[0] += sum(a.det_mask.shape[0] for a in arrs_l)
        return arrs_l

    # Host loading (PNG decode + cloud read) runs one group ahead of the
    # device in a loader thread.
    loader = ThreadPoolExecutor(max_workers=1)
    try:
        fut = loader.submit(load_group, groups[0]) if groups else None
        for gi, members in enumerate(groups):
            arrs_l = fut.result()
            fut = (loader.submit(load_group, groups[gi + 1])
                   if gi + 1 < len(groups) else None)
            results, frames_ctd, secs_ctd = run_group(members, arrs_l)
            total_frames += frames_ctd
            t_total += secs_ctd
            for seq, arrs, res in results:
                T = arrs.det_mask.shape[0]
                res = {k: v[:T] for k, v in res.items()}
                outputs[seq] = dict(res, det_mask=arrs.det_mask)
                ids, det_score = res["ids"], res["det_score"]
                keep = arrs.det_mask
                if score_threshold > 0:
                    keep = keep & (det_score >= score_threshold)
                type_kw = (dict(obj_types=arrs.cls_ids, type_names=list(
                    KittiTrackingDataset.CLASS_GROUPS)) if joint else {})
                objs = tracker_output_to_objects(
                    ids, keep, arrs.boxes, scores=arrs.scores,
                    boxes3d=arrs.boxes3d, obj_type=data_cfg.track_class,
                    frame_ids=arrs.frame_ids, has_3d=arrs.has_3d,
                    **type_kw)
                ghost_objs = []
                if "ghost_ids" in res:
                    # Coverage rows: a track missing for at most
                    # coverage_max_miss frames keeps its extrapolated box
                    # under its own id, scored by its last det-head
                    # confidence.
                    gi = res["ghost_ids"]
                    ghost_objs = tracker_output_to_objects(
                        gi, gi >= 0, res["ghost_boxes"],
                        scores=res["ghost_scores"],
                        obj_type=data_cfg.track_class,
                        frame_ids=arrs.frame_ids)
                    if joint:
                        # A coverage row takes its track's class (under
                        # the class gate a track is of one class).
                        id2type = {o.track_id: o.obj_type for o in objs}
                        for g in ghost_objs:
                            g.obj_type = id2type.get(g.track_id,
                                                     g.obj_type)
                path = os.path.join(res_dir, f"{seq}.txt")
                write_kitti_result(objs + ghost_objs, path)
                if log:
                    log.info("sequence %s: %d frames -> %s", seq, T, path)
                gt_path = os.path.join(data_cfg.root, "label_02",
                                       f"{seq}.txt")
                gt = (read_kitti_tracking_labels(gt_path)
                      if evaluate and os.path.exists(gt_path) else None)
                # Score exactly the tracked range, by true frame numbers.
                n_frames = (int(arrs.frame_ids[-1]) + 1
                            if len(arrs.frame_ids) else T)
                for thr in sweep:
                    tdir = os.path.join(res_dir, f"thr_{thr:g}")
                    os.makedirs(tdir, exist_ok=True)
                    tpath = os.path.join(tdir, f"{seq}.txt")
                    write_kitti_result(tracker_output_to_objects(
                        ids, keep & (det_score >= thr), arrs.boxes,
                        scores=arrs.scores, boxes3d=arrs.boxes3d,
                        obj_type=data_cfg.track_class,
                        frame_ids=arrs.frame_ids, has_3d=arrs.has_3d)
                        # As in the reference, the detections' rows here
                        # carry data.track_class, also for "All" (their
                        # classes are not passed): the sweep's files stay
                        # byte-equal to the reference's.
                        + [g for g in ghost_objs if g.score >= thr], tpath)
                    if gt is not None:
                        tt = read_kitti_tracking_labels(tpath)
                        for c in eval_classes:
                            sweep_evs[thr][c].add_sequence(
                                gt, tt, num_frames=n_frames)
                if gt is not None:
                    trk = read_kitti_tracking_labels(path)
                    for c in eval_classes:
                        evs[c].add_sequence(gt, trk, num_frames=n_frames)
                        hevs[c].add_sequence(gt, trk, num_frames=n_frames)
                    one = TrackingEvaluation(cls=eval_classes[0])
                    one.add_sequence(gt, trk, num_frames=n_frames)
                    per_seq[seq] = one.compute()
    finally:
        loader.shutdown(wait=True, cancel_futures=True)

    stats = {"n_programs": len(shapes), "n_dropped": n_dropped,
             "total_frames": total_frames,
             "fps": total_frames / max(t_total, 1e-9),
             "n_windows": len(window_s), "window_s": window_s,
             "load_s": load_s[0], "decode_s": ds.decode_s,
             "frames_loaded": frames_loaded[0], "outputs": outputs}
    if n_dropped and log:
        log.warning("%d detections dropped by compaction capacity — "
                    "results are incomplete", n_dropped)
    if evaluate:
        by_cls = {c: evs[c].compute() for c in eval_classes}
        hota_by_cls = {c: hevs[c].compute() for c in eval_classes}
        stats["per_sequence"] = per_seq
        if joint:
            stats.update(metrics_by_class=by_cls, hota_by_class=hota_by_cls)
            if sweep:
                stats["sweep"] = {thr: {c: e.compute() for c, e in d.items()}
                                  for thr, d in sweep_evs.items()}
        else:
            c = eval_classes[0]
            stats.update(metrics=by_cls[c], hota=hota_by_cls[c])
            if sweep:
                stats["sweep"] = {thr: d[c].compute()
                                  for thr, d in sweep_evs.items()}
        for c in eval_classes:
            with open(os.path.join(res_dir, f"summary_{c}.txt"), "w") as fh:
                fh.write(by_cls[c].summary_text())
            with open(os.path.join(res_dir, f"hota_{c}.txt"), "w") as fh:
                fh.write(hota_by_cls[c].summary_text())
            if log:
                log.info("[%s] metrics: %s", c, by_cls[c].summary())
                log.info("[%s] hota: %s", c, hota_by_cls[c].summary())
    return stats
