#!/usr/bin/env python3
"""Bidding rounds and time of the auction on ``chip_smoke.py``'s main
path, for this checkout and another one (for example the parent commit's
``chip_smoke.py`` and ``mmmot_tpu_torch/``, unpacked with ``git
archive``), on one GPU:

    python3 auction_rounds.py --other DIR

Each run is a process of its own that imports the checkout's
``chip_smoke`` and ``mmmot_tpu_torch``: the main path (phase 5:
``full_mmmot``, weights from seed 0, T=16 synthetic frames from seed 42)
with every ``auction_lap`` call recorded (its cost matrix, its
assignment, and its time with the device synchronised before and after).
The runs go other, this, this, other.  Then this checkout's
``auction_lap``, which counts its bidding rounds, solves every recorded
cost matrix again; ``same_assignment`` says whether it returned the
recorded assignment (the same algorithm on the same instance).  One JSON
line per run: the checkout, and per auction call its rounds, ms and ms
per round.  The ``nvidia-smi`` name and power limit come last.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def capture(checkout: str, out: str) -> None:
    """One main-path run of ``checkout``, its auction calls saved to
    ``out``."""
    sys.path[0] = os.path.abspath(checkout)
    import torch

    import chip_smoke
    from mmmot_tpu_torch.assoc import auction
    from mmmot_tpu_torch.config import full_mmmot
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

    if not auction.__file__.startswith(sys.path[0] + os.sep):
        raise SystemExit(f"{auction.__file__} is not under {sys.path[0]}")
    calls = []
    lap = auction.auction_lap

    def recorded(cost, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = lap(cost, *args, **kw)
        torch.cuda.synchronize()
        calls.append({"cost": cost.cpu(), "assign": r[0].cpu(),
                      "ms": (time.perf_counter() - t) * 1e3})
        return r

    # A counting auction_lap adds its rounds to the module global's
    # attribute, which is now this wrapper.
    recorded.rounds = 0
    auction.auction_lap = recorded
    dev = torch.device("cuda", 0)
    net = init_random_(TrackingNet(full_mmmot().model, device=dev), 0)
    run = chip_smoke.main_path(net, dev, chip_smoke.nvidia_smi(), False)
    torch.save({"calls": calls, "warm_ms": run["warm_ms"],
                "stages_ms": run["stages_ms"]}, out)


def count(path: str, label: str) -> dict:
    """Rounds of this checkout's auction on a run's recorded costs."""
    import torch

    from mmmot_tpu_torch.assoc.auction import auction_lap

    rec = torch.load(path)
    rows = []
    for c in rec["calls"]:
        auction_lap.rounds = 0
        assign, _ = auction_lap(c["cost"].cuda())
        rounds = auction_lap.rounds
        rows.append({"rounds": rounds, "ms": c["ms"],
                     "ms_per_round": c["ms"] / max(1, rounds),
                     "instances": int(c["cost"].shape[0]),
                     "same_assignment": bool(torch.equal(assign.cpu(),
                                                         c["assign"]))})
    return {"checkout": label, "warm_ms": rec["warm_ms"],
            "stages_ms": rec["stages_ms"], "auction_calls": rows}


def main(argv) -> int:
    if argv[:1] == ["--capture"]:
        capture(argv[1], argv[2])
        return 0
    if argv[:1] != ["--other"] or len(argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("auction_rounds: no CUDA device")
    other = os.path.abspath(argv[1])
    runs = [(other, "other"), (HERE, "this"), (HERE, "this"),
            (other, "other")]
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, (checkout, label) in enumerate(runs):
            path = os.path.join(tmp, f"run{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--capture", checkout, path], check=True,
                           stdout=sys.stderr)
            paths.append((path, f"{label} ({checkout})"))
        for path, label in paths:
            print(json.dumps(count(path, label)), flush=True)
    import chip_smoke

    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
