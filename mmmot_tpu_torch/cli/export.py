"""Export a serving step of the port as a deployment artifact:
``mmmot_tpu/cli/export.py``'s flags, except ``--platforms``.

    python -m mmmot_tpu_torch.cli.export --config full_mmmot \\
        --load-path checkpoints/full_mmmot_best --out artifacts/full_mmmot \\
        --shape 384x1248x16384

One directory holds the weights (flax layout), the zero tracker state and
a manifest (``deploy.py``).  ``cli/serve.py --exported DIR`` serves a
per-frame or a multi-stream artifact (``DeployedTracker.load``,
``load_multistream_step``); ``load_window_step`` drives a window one.
The port lowers nothing: the artifact's program is the port's own step
code, which its manifest names, so it has no compiled program beside the
weights.  Weights come from
``--load-path`` (a checkpoint dir of the port's trainer), ``--weights``
(flax variables as a flat numpy archive) or are random from ``--seed``.
The model is built on the GPU unless ``--cpu`` is given.  ``--int8`` (or
a preset with ``model.int8_appearance``, ``full_mmmot_int8``) quantises
the appearance trunk to int8, calibrated on real crops of the KITTI tree
at ``--calib-root`` (default: the preset's ``data.root``), and writes it
into the artifact (``"int8": true``).

    python -m mmmot_tpu_torch.cli.export --config full_mmmot_int8 \\
        --load-path checkpoints/full_mmmot_best --out artifacts/int8 \\
        --calib-root data/kitti_tracking
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None):
    from mmmot_tpu_torch.cli.track import PRESETS

    p = argparse.ArgumentParser(
        description="export a tracking step of mmmot_tpu_torch as an "
                    "artifact")
    p.add_argument("--config", required=True, choices=PRESETS,
                   help="config preset")
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--load-path", default=None, metavar="DIR",
                         help="checkpoint dir of the port's trainer (its "
                              "latest step); random weights from --seed "
                              "if neither it nor --weights is given "
                              "(useful only for pipeline tests)")
    weights.add_argument("--weights", default=None, metavar="NPZ",
                         help="flax variables as a flat numpy archive")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True, help="artifact directory")
    p.add_argument("--shape", default="384x1248x16384",
                   help="HxWxM image and cloud shape the artifact is "
                        "served at (KITTI default; clouds with fewer "
                        "points are padded)")
    p.add_argument("--window", type=int, default=None, metavar="W",
                   help="export the WINDOW program instead of the "
                        "per-frame serve step: one call tracks W frames "
                        "of raw inputs through the compact-first "
                        "streaming pipeline and returns the carried "
                        "state (chain calls for any sequence length)")
    p.add_argument("--capacity", type=int, default=None,
                   help="compact-first extraction capacity: for --window "
                        "(default W * max_dets, every slot) and for "
                        "--streams (default None: extract all S * "
                        "max_dets padded slots; overflow detections "
                        "drop)")
    p.add_argument("--streams", type=int, default=None, metavar="S",
                   help="export the MULTI-STREAM program instead: one call "
                        "advances up to S concurrent streams' frames (a "
                        "per-slot active mask; inactive slots carry their "
                        "state unchanged)")
    p.add_argument("--int8", action="store_true",
                   help="quantize the appearance trunk to int8 (also "
                        "enabled by the config's model.int8_appearance): "
                        "the calibrated int8 trunk is written into the "
                        "artifact.  Calibrates on real crops from "
                        "--calib-root (default: the config's data.root)")
    p.add_argument("--calib-root", default=None,
                   help="KITTI tree for --int8 calibration crops")
    p.add_argument("--cpu", action="store_true",
                   help="build the model on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.window and args.streams:
        raise SystemExit("--window and --streams are mutually exclusive")

    from mmmot_tpu_torch import config as presets
    from mmmot_tpu_torch.cli.track import build_module
    from mmmot_tpu_torch.deploy import (export_multistream_step,
                                        export_serve_step,
                                        export_window_step)

    cfg = getattr(presets, args.config)()
    h, w, m = (int(x) for x in args.shape.split("x"))
    module = build_module(cfg, args.weights, args.seed,
                          "cpu" if args.cpu else "cuda", args.load_path)
    if args.int8 or cfg.model.int8_appearance:
        from mmmot_tpu_torch.models.quantize import quantize_for_inference

        data_cfg = cfg.data
        if args.calib_root:
            data_cfg = dataclasses.replace(data_cfg, root=args.calib_root)
        if not os.path.isdir(data_cfg.root):
            raise SystemExit(
                f"--int8 needs real calibration crops: no KITTI tree at "
                f"{data_cfg.root!r} (point --calib-root at one)")
        quantize_for_inference(module.net, data_cfg)
        print(f"int8 appearance trunk calibrated on {data_cfg.root}")
    if args.streams:
        export_multistream_step(args.out, cfg, module, (h, w), m,
                                args.streams, args.capacity)
        what = f"multistream({args.streams}) step"
    elif args.window:
        export_window_step(args.out, cfg, module, (h, w), m, args.window,
                           args.capacity)
        what = f"window({args.window}) step"
    else:
        export_serve_step(args.out, cfg, module, (h, w), m)
        what = "serve step"
    print(f"exported {cfg.name} {what} (image {h}x{w}, cloud {m}, "
          f"N={cfg.data.max_dets}) -> {args.out}")


if __name__ == "__main__":
    main()
