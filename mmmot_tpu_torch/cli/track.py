"""Tracking CLI of the port: ``mmmot_tpu/cli/track.py``.

    python -m mmmot_tpu_torch.cli.track --config full_mmmot \\
        --data-root data/kitti_tracking --batch-sequences 2
    python -m mmmot_tpu_torch.cli.track --config full_mmmot_noisy \\
        --data-root data/kitti_tracking --batch-sequences 2
    python -m mmmot_tpu_torch.cli.track --config full_mmmot_lookalike \\
        --data-root data/kitti_tracking --batch-sequences 2
    python -m mmmot_tpu_torch.cli.track --config full_mmmot_int8 \\
        --data-root data/kitti_tracking --batch-sequences 2
    python -m mmmot_tpu_torch.cli.track --config batched_val \\
        --data-root data/kitti_tracking --batch-sequences 2
    python -m mmmot_tpu_torch.cli.track --config full_mmmot \\
        --data-root data/kitti_tracking --dead-sensor camera
    python -m mmmot_tpu_torch.cli.track --config full_mmmot \\
        --data-root data/kitti_tracking --packed-cache
    python -m mmmot_tpu_torch.cli.track --config tiny_debug --cpu \\
        --data-root /nonexistent --sequences 2 --frames 20

Tracks the sequences of a KITTI tracking tree in windows
(``tracker/kitti_runner.py``), writes one KITTI result txt per sequence
under ``<result-path>/<config>/<result-sha>/`` and, unless ``--no-eval``,
scores them with the devkit and HOTA (``summary_<cls>.txt``,
``hota_<cls>.txt``).  ``--config`` names a preset of
``mmmot_tpu_torch.config``, its association included
(``full_mmmot_noisy``: the noisy-detector quality stack, reading
``detections/noisy/``; ``full_mmmot_lookalike``: that stack with GNN
refine and the learned motion term, at 112² crops; ``full_mmmot_int8``:
the flagship with its appearance trunk in int8; ``batched_val``: the
flagship with the Sinkhorn association; ``fusion_C``: that scoring the
fused branch alone; ``img_only`` / ``lidar_only``: one modality).
``--solver`` overrides the preset's association solver;
``--dead-sensor camera|lidar`` simulates a failed sensor (its input work
is skipped and the affinity scores the branches left).  ``--int8``, or a
preset's ``model.int8_appearance``, quantises the trunk after the weights
load, calibrated on real crops of the tree (``models/quantize.py``).
``--packed-cache`` packs each sequence into ``<root>/.packed/`` on its
first load and memory-maps it on later runs (``data/packed_cache.py``).
``--trace-dir DIR`` profiles the run (``utils/profiling.py::trace``):
the Chrome trace, the tracer's spans and counts under DIR.

Without a data root (``--data-root`` names no directory) the CLI tracks
synthetic sequences instead (``data/synthetic.py``, seeds 2000 +
sequence): ``--sequences`` is then a count (default 3) and ``--frames``
defaults to 30; each sequence runs the crops-given ``track_sequence``
over every slot, its result txt is written as ``<seq:04d>.txt`` and
scored against the world's ground truth.  ``--int8``,
``--batch-sequences`` and ``--submission-zip`` do not apply there and
are ignored with a warning; ``--dead-sensor`` drops that modality's
input.

Weights come from ``--load-path`` (a checkpoint directory of the port's
trainer, ``cli/train.py``: its latest step), ``--weights`` (a flat
``params/...``, ``batch_stats/...`` numpy archive, see
``compat/from_jax.py::save_npz``) or are random from ``--seed``.
The GPU is used unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

PRESETS = ("full_mmmot", "full_mmmot_ydet", "full_mmmot_noisy",
           "full_mmmot_lookalike", "full_mmmot_int8", "batched_val",
           "fusion_C", "img_only", "lidar_only", "tiny_debug", "tiny_kitti",
           "tiny_long", "tiny_long30")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="mmmot_tpu_torch KITTI sequence tracking")
    p.add_argument("--config", required=True, choices=PRESETS,
                   help="config preset")
    p.add_argument("--data-root", default=None,
                   help="KITTI tracking tree (default: the preset's "
                        "data.root)")
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--load-path", default=None, metavar="DIR",
                         help="checkpoint dir of the port's trainer (its "
                              "latest step)")
    weights.add_argument("--weights", default=None, metavar="NPZ",
                         help="flax variables as a flat numpy archive; "
                              "default: random weights from --seed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--result-path", default="results")
    p.add_argument("--result-sha", default="latest",
                   help="result subdirectory tag")
    p.add_argument("--sequences", default=None,
                   help="real KITTI data: comma-separated sequence names "
                        "(default all); synthetic data: sequence count "
                        "(default 3)")
    p.add_argument("--frames", type=int, default=None,
                   help="max frames per sequence (real data: default all; "
                        "synthetic: default 30)")
    p.add_argument("--no-eval", action="store_true",
                   help="skip devkit and HOTA scoring")
    p.add_argument("--score-threshold", type=float, default=0.0,
                   help="drop output detections whose learned confidence "
                        "(det head) is below this")
    p.add_argument("--solver", default=None,
                   help="override the association solver "
                        "(auction|sinkhorn|greedy|ilp|lap|native)")
    p.add_argument("--window", type=int, default=64,
                   help="frames per streaming window")
    p.add_argument("--batch-sequences", type=int, default=1,
                   help="sequences tracked together per window call")
    p.add_argument("--dead-sensor", choices=["camera", "lidar"],
                   default=None,
                   help="simulate a failed sensor on the real pipeline "
                        "(the net runs on the modality left)")
    p.add_argument("--packed-cache", action="store_true",
                   help="persist packed sequences to <root>/.packed/ and "
                        "memory-map them on later runs (no PNG or "
                        "velodyne decode)")
    p.add_argument("--submission-zip", default=None, metavar="ZIP",
                   help="package the result txts as a KITTI tracking "
                        "submission zip")
    p.add_argument("--int8", action="store_true",
                   help="quantize the appearance trunk to int8 before "
                        "tracking (also enabled by the config's "
                        "model.int8_appearance), calibrated on real crops "
                        "from the data root")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="profile the run: DIR/trace.json (torch.profiler's "
                        "Chrome trace), DIR/spans.jsonl (the tracer's "
                        "spans) and DIR/counters.json")
    return p.parse_args(argv)


def build_module(cfg, weights, seed: int, device, load_path=None):
    """The port's TrackingModule with the weights of the checkpoint dir
    ``load_path``, of ``weights`` (npz path), or seeded random ones."""
    from mmmot_tpu_torch.compat.from_jax import (load_flax_variables,
                                                 load_npz)
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
    from mmmot_tpu_torch.tracker.tracker import TrackingModule
    from mmmot_tpu_torch.train.checkpoint import load_weights

    net = TrackingNet(cfg.model, device=device)
    if load_path:
        load_weights(load_path, net)
    elif weights:
        net.load_state_dict(load_flax_variables(load_npz(weights), net))
    else:
        init_random_(net, seed)
    return TrackingModule(net, cfg.assoc)


def main(argv=None):
    args = parse_args(argv)
    if not args.trace_dir:
        return run(args)
    from mmmot_tpu_torch.utils.profiling import trace

    with trace(args.trace_dir):
        return run(args)


def run(args):
    from mmmot_tpu_torch import config as presets

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("mmmot_torch.track")
    cfg = getattr(presets, args.config)()
    if args.solver:
        cfg = dataclasses.replace(cfg, assoc=dataclasses.replace(
            cfg.assoc, solver=args.solver))
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, root=args.data_root))
    if args.packed_cache:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, packed_cache=True))
    real_data = os.path.isdir(cfg.data.root)
    if real_data and not os.path.isdir(os.path.join(cfg.data.root,
                                                    "image_02")):
        raise SystemExit(
            f"no KITTI tracking tree at {cfg.data.root!r} (image_02/ "
            "missing); pass --data-root, or a path that is no directory "
            "to track synthetic sequences")
    module = build_module(cfg, args.weights, args.seed,
                          "cpu" if args.cpu else "cuda", args.load_path)
    res_dir = os.path.join(args.result_path, cfg.name, args.result_sha)
    if not real_data:
        return track_synthetic(args, cfg, module, res_dir, log)
    if args.int8 or cfg.model.int8_appearance:
        from mmmot_tpu_torch.models.quantize import quantize_for_inference

        quantize_for_inference(
            module.net, cfg.data,
            sequences=args.sequences.split(",") if args.sequences else None)
        log.info("int8 appearance trunk enabled "
                 "(calibrated on real crops from %s)", cfg.data.root)

    from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences

    stats = track_kitti_sequences(
        module, cfg.data, res_dir,
        sequences=args.sequences.split(",") if args.sequences else None,
        window=args.window, score_threshold=args.score_threshold,
        evaluate=not args.no_eval, max_frames=args.frames,
        batch_sequences=args.batch_sequences, dead_sensor=args.dead_sensor,
        log=log)
    if stats["total_frames"]:
        log.info("throughput: %.1f FPS (after the first window)",
                 stats["fps"])
    if args.submission_zip:
        from mmmot_tpu_torch.data.kitti_io import package_submission

        names = package_submission(res_dir, args.submission_zip)
        log.info("submission: packaged %d sequence files -> %s",
                 len(names), args.submission_zip)
    return stats


def track_synthetic(args, cfg, module, res_dir: str, log):
    """The synthetic mode (no data root): ``--sequences`` worlds of
    ``--frames`` frames (default 3 of 30) from
    ``make_synthetic_sequence`` seeded 2000 + s, each tracked over every
    slot (``track_sequence``), written as ``<res_dir>/<s:04d>.txt`` and,
    unless ``--no-eval``, scored by the devkit against the world's ground
    truth.  Returns {"n_sequences", "total_frames", "fps" (frames a
    second after the first sequence, which warms up), "files",
    "metrics" (unless ``--no-eval``)}."""
    import time

    import numpy as np

    from mmmot_tpu_torch.data.kitti_io import (tracker_output_to_objects,
                                               write_kitti_result)
    from mmmot_tpu_torch.data.synthetic import make_synthetic_sequence
    from mmmot_tpu_torch.eval import TrackingEvaluation
    from mmmot_tpu_torch.tracker.sequence import track_sequence

    if args.int8 or cfg.model.int8_appearance:
        log.warning("--int8 ignored with synthetic data (no real crops "
                    "to calibrate on)")
    try:
        n_seqs = int(args.sequences) if args.sequences is not None else 3
    except ValueError:
        raise SystemExit(
            f"--sequences {args.sequences!r}: synthetic data (no KITTI "
            f"tree at {cfg.data.root}) expects a sequence COUNT; "
            "sequence names apply only with real data")
    if args.batch_sequences > 1:
        log.warning("--batch-sequences is ignored with synthetic data "
                    "(sequences run serially here)")
    if args.submission_zip:
        log.warning("--submission-zip is ignored with synthetic data "
                    "(nothing KITTI-submittable here)")
    frames = args.frames if args.frames is not None else 30
    N, P, crop = cfg.data.max_dets, cfg.data.point_len, cfg.data.crop_size
    dead = args.dead_sensor
    ev = TrackingEvaluation(cls="car")
    total_frames, t_total, files = 0, 0.0, []
    for s in range(n_seqs):
        world = make_synthetic_sequence(
            np.random.default_rng(2000 + s), num_frames=frames,
            num_slots=N, crop_size=crop, points_per_det=P,
            drop_prob=0.05, fp_prob=0.1)
        t0 = time.perf_counter()
        out = track_sequence(
            module, None if dead == "camera" else world.crops,
            None if dead == "lidar" else world.points,
            None if dead == "lidar" else world.point_mask, world.det_mask)
        ids = out["ids"].cpu().numpy()            # waits for the device
        dt = time.perf_counter() - t0
        if s > 0:                  # the first sequence warms up
            t_total += dt
            total_frames += frames
        det_mask = world.det_mask
        if args.score_threshold > 0:
            det_mask = det_mask & (out["det_score"].float().cpu().numpy()
                                   >= args.score_threshold)
        res = tracker_output_to_objects(ids, det_mask, world.boxes2d,
                                        world.scores)
        path = os.path.join(res_dir, f"{s:04d}.txt")
        write_kitti_result(res, path)
        files.append(path)
        log.info("sequence %04d: %d frames in %.3fs -> %s", s, frames, dt,
                 path)
        if not args.no_eval:
            gt = tracker_output_to_objects(
                world.gt_ids, world.det_mask & (world.gt_ids >= 0),
                world.boxes2d)
            gtf, resf = {}, {}
            for o in gt:
                gtf.setdefault(o.frame, []).append(o)
            for o in res:
                resf.setdefault(o.frame, []).append(o)
            ev.add_sequence(gtf, resf, num_frames=frames)
    stats = {"n_sequences": n_seqs, "total_frames": total_frames,
             "fps": total_frames / max(t_total, 1e-9), "files": files}
    if total_frames:
        log.info("throughput: %.1f FPS (steady-state)", stats["fps"])
    if not args.no_eval:
        stats["metrics"] = ev.compute()
        log.info("metrics: %s", stats["metrics"].summary())
    return stats


if __name__ == "__main__":
    main()
