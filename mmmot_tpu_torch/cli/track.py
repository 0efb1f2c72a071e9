"""KITTI tracking CLI of the port: the real-data path of
``mmmot_tpu/cli/track.py``.

    python -m mmmot_tpu_torch.cli.track --config full_mmmot \\
        --data-root data/kitti_tracking --batch-sequences 2
    python -m mmmot_tpu_torch.cli.track --config full_mmmot_noisy \\
        --data-root data/kitti_tracking --batch-sequences 2
    python -m mmmot_tpu_torch.cli.track --config full_mmmot_lookalike \\
        --data-root data/kitti_tracking --batch-sequences 2

Tracks the sequences of a KITTI tracking tree in windows
(``tracker/kitti_runner.py``), writes one KITTI result txt per sequence
under ``<result-path>/<config>/<result-sha>/`` and, unless ``--no-eval``,
scores them with the devkit and HOTA (``summary_<cls>.txt``,
``hota_<cls>.txt``).  ``--config`` names a preset of
``mmmot_tpu_torch.config``, its association included
(``full_mmmot_noisy``: the noisy-detector quality stack, reading
``detections/noisy/``; ``full_mmmot_lookalike``: that stack with GNN
refine and the learned motion term, at 112² crops).  Weights come from
``--load-path`` (a checkpoint directory of the port's trainer,
``cli/train.py``: its latest step), ``--weights`` (a flat
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
           "full_mmmot_lookalike", "tiny_debug")


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
                   help="comma-separated sequence names (default all)")
    p.add_argument("--frames", type=int, default=None,
                   help="max frames per sequence (default all)")
    p.add_argument("--no-eval", action="store_true",
                   help="skip devkit and HOTA scoring")
    p.add_argument("--score-threshold", type=float, default=0.0,
                   help="drop output detections whose learned confidence "
                        "(det head) is below this")
    p.add_argument("--window", type=int, default=64,
                   help="frames per streaming window")
    p.add_argument("--batch-sequences", type=int, default=1,
                   help="sequences tracked together per window call")
    p.add_argument("--submission-zip", default=None, metavar="ZIP",
                   help="package the result txts as a KITTI tracking "
                        "submission zip")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
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
    from mmmot_tpu_torch import config as presets

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("mmmot_torch.track")
    cfg = getattr(presets, args.config)()
    if args.data_root:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, root=args.data_root))
    if not os.path.isdir(os.path.join(cfg.data.root, "image_02")):
        raise SystemExit(
            f"no KITTI tracking tree at {cfg.data.root!r} (image_02/ "
            "missing); pass --data-root.  Tracking synthetic crops without "
            "a tree is not ported yet")
    module = build_module(cfg, args.weights, args.seed,
                          "cpu" if args.cpu else "cuda", args.load_path)

    from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences

    res_dir = os.path.join(args.result_path, cfg.name, args.result_sha)
    stats = track_kitti_sequences(
        module, cfg.data, res_dir,
        sequences=args.sequences.split(",") if args.sequences else None,
        window=args.window, score_threshold=args.score_threshold,
        evaluate=not args.no_eval, max_frames=args.frames,
        batch_sequences=args.batch_sequences, log=log)
    if stats["total_frames"]:
        log.info("throughput: %.1f FPS (after the first window)",
                 stats["fps"])
    if args.submission_zip:
        from mmmot_tpu_torch.data.kitti_io import package_submission

        names = package_submission(res_dir, args.submission_zip)
        log.info("submission: packaged %d sequence files -> %s",
                 len(names), args.submission_zip)
    return stats


if __name__ == "__main__":
    main()
