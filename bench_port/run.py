#!/usr/bin/env python3
"""The benchmark of ``mmmot_tpu_torch`` on NVIDIA GPUs: one run of one
cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's configuration, traffic mix,
limits and per-layer metric readers are found by name under
``bench_port/``; the traffic mix's ``entry`` names the module that runs it
(``harness/entry_<entry>.py``).  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, the
numbers compared with their limits.  Without the CUDA devices the cell
asks for, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port.harness import common  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    common.cache_dirs()
    cell = common.load_cell(args.workload)
    common.require_cuda(cell["chips"])
    entry = importlib.import_module(
        f"bench_port.harness.entry_{cell['mix']['entry']}")
    entry.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
              T_START)


if __name__ == "__main__":
    main()
