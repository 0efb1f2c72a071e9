#!/usr/bin/env python3
"""The fused affinity kernel's times in this checkout and in another one
(for example the parent commit, unpacked with ``git archive``), on one
GPU, in one run:

    python3 affinity_ab.py --other DIR

Each checkout runs in a process of its own, twice, in the order other,
this, this, other, so that a drift of the card over the run falls on
both.  A process imports its own ``chip_smoke`` and ``mmmot_tpu_torch``,
builds its kernel from its own sources, and times ``fused_affinity``
with ``chip_smoke.cuda_ms`` (device time, 50 calls after a warm-up, the
host's work hidden behind a spin kernel), and each of its two launches
alone (``affinity_launches``), on the same seeded inputs:
``full_mmmot``'s instance (K=3, D=H=512, seed-0 weights) at B=16 and
B=512 frame pairs of N=32 (``chip_smoke.affinity_inputs``) and at the
entry band of ``max_dets`` 64 (B=10, N=128,
``chip_smoke.entry_band_inputs``), in bfloat16 and float32.  One JSON
line a process; then nvidia-smi's name and power limit, and last
``{"ratio": {shape: {"ms" | "products" | "finish": this / other}}}`` of
the mean times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 50


def run(checkout: str) -> dict:
    """``{shape: {"ms", "products", "finish": device ms}}`` of
    ``checkout``'s kernel."""
    sys.path[0] = os.path.abspath(checkout)
    import torch

    import chip_smoke as cs
    from mmmot_tpu_torch.config import full_mmmot
    from mmmot_tpu_torch.kernels.affinity import (affinity_launches,
                                                  build_affinity_params,
                                                  fused_affinity)
    from mmmot_tpu_torch.models.tracking_net import (TrackingNet,
                                                     init_random_)

    if not cs.__file__.startswith(sys.path[0] + os.sep):
        raise SystemExit(f"{cs.__file__} is not under {sys.path[0]}")
    dev = torch.device("cuda", 0)
    net = init_random_(TrackingNet(full_mmmot().model, device=dev), 0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        params = build_affinity_params(net, dtype)
        gen = torch.Generator(device=dev).manual_seed(15)
        for label, inputs in (
                ("B=16 N=32", cs.affinity_inputs(dtype, gen, dev, 16)),
                ("B=512 N=32", cs.affinity_inputs(dtype, gen, dev, 512)),
                ("B=10 N=128", cs.entry_band_inputs(dtype, gen, dev, 10,
                                                    n=128))):
            with cs.f32_parity(dtype == torch.float32):
                ms, _ = cs.cuda_ms(lambda: fused_affinity(*inputs, params),
                                   REPS)
                products, finish, _ = affinity_launches(*inputs, params)
                out[f"{label} {str(dtype)[6:]}"] = {
                    "ms": ms, "products": cs.cuda_ms(products, REPS)[0],
                    "finish": cs.cuda_ms(finish, REPS)[0]}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--run"]:
        print(json.dumps(run(argv[1])), flush=True)
        return 0
    if len(argv) != 2 or argv[0] != "--other":
        raise SystemExit("usage: affinity_ab.py --other DIR")
    other = os.path.abspath(argv[1])
    times = {"this": [], "other": []}
    for who in ("other", "this", "this", "other"):
        checkout = HERE if who == "this" else other
        got = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--run", checkout], cwd=checkout, check=True,
                             stdout=subprocess.PIPE, text=True)
        line = json.loads(got.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": who, "ms": line}), flush=True)
        times[who].append(line)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(smi)

    def mean(runs, k, part):
        return sum(r[k][part] for r in runs) / len(runs)

    print(json.dumps({"ratio": {
        k: {part: mean(times["this"], k, part) / mean(times["other"], k, part)
            for part in v}
        for k, v in times["this"][0].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
