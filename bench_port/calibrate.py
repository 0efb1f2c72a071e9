#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, the
cell's set-up and one window, then the compared numbers of the program
and, with ``--control``, of the control (the reference computed in the
next precision below the configuration's, put in the program's place).
One JSON line a seed and side on standard output.

    python3 bench_port/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control 1,2,3] [--fault half_batch --fault-seeds 1,2,3]

The benchmark's own runs never run this; ``PERF.md`` keeps its
readings beside each limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port.harness import common  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control", type=seeds, default=[])
    ap.add_argument("--fault", default=None,
                    help="a fault planted in the program (training cells)")
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    args = ap.parse_args(argv)
    common.cache_dirs()
    cell = common.load_cell(args.workload)
    common.require_cuda(cell["chips"])
    import importlib
    entry = importlib.import_module(
        f"bench_port.harness.entry_{cell['mix']['entry']}")
    runs = [(s, None) for s in sorted(set(args.seeds) | set(args.control))]
    runs += [(s, args.fault) for s in args.fault_seeds]
    for seed, fault in runs:
        t = time.perf_counter()
        kw = {"fault": fault} if fault else {}
        sides = entry.calibration_readings(
            cell, seed, "cuda", program=fault is not None or seed in args.seeds,
            control=fault is None and seed in args.control, **kw)
        for side, r in sides.items():
            print(json.dumps({"seed": seed, "side": side, **r,
                              "seconds": time.perf_counter() - t}),
                  flush=True)


if __name__ == "__main__":
    main()
