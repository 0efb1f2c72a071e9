#!/usr/bin/env python3
"""The int8 path's outputs from this checkout and from another one (for
example the parent commit's ``chip_smoke.py`` and ``mmmot_tpu_torch/``,
unpacked with ``git archive``), on one GPU:

    python3 int8_ids.py --other DIR

Both checkouts get the same inputs: this checkout writes
``chip_smoke.py``'s KITTI tree (its noisy detections included) and the
seed-0 ``full_mmmot`` weights with the heads calibrated as phase 11 does
(``chip_smoke.calibrate_heads``).  Each checkout then runs in a process
of its own, importing its own ``chip_smoke`` and ``mmmot_tpu_torch``:
``cli/track --config full_mmmot_int8`` over the tree (S=2, window 64,
the trunk calibrated on the tree), and ``cli/export --int8`` of the same
weights served by ``DeployedTracker`` over 20 frames of sequence 0000.
One JSON line a checkout: the sha256 of each result file, the served
ids, and the int8 conv's launches.  Then nvidia-smi's name and power
limit, and last ``{"equal": ...}``: whether both checkouts wrote the
same files and served the same ids.  Exits 1 when they differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SERVE_FRAMES = 20


def run(checkout: str, root: str, weights: str, out: str) -> None:
    """The int8 runner and served ids of ``checkout``, saved to ``out``."""
    sys.path[0] = os.path.abspath(checkout)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from mmmot_tpu_torch.cli.export import main as export_main
    from mmmot_tpu_torch.cli.track import main as track_main
    from mmmot_tpu_torch.config import full_mmmot
    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
    from mmmot_tpu_torch.deploy import DeployedTracker
    from mmmot_tpu_torch.kernels.int8_conv import int8_conv3x3_requant

    if not cs.__file__.startswith(sys.path[0] + os.sep):
        raise SystemExit(f"{cs.__file__} is not under {sys.path[0]}")
    with tempfile.TemporaryDirectory() as tmp:
        before = int8_conv3x3_requant.launches
        track_main(["--config", "full_mmmot_int8", "--data-root", root,
                    "--weights", weights, "--result-path", f"{tmp}/res",
                    "--batch-sequences", str(cs.RUNNER_S), "--window",
                    str(cs.RUNNER_WINDOW), "--no-eval"])
        runner_launches = int8_conv3x3_requant.launches - before
        files = {k: hashlib.sha256(v).hexdigest()
                 for k, v in sorted(cs.result_files(f"{tmp}/res").items())}
        art = f"{tmp}/art"
        export_main(["--config", "full_mmmot", "--int8", "--weights",
                     weights, "--out", art, "--calib-root", root, "--shape",
                     f"{cs.KITTI_H}x{cs.KITTI_W}x{cs.CLOUD_POINTS}"])
        trk = DeployedTracker.load(art, device=torch.device("cuda", 0))
        data = dataclasses.replace(full_mmmot().data, root=root,
                                   cloud_filter="none")
        a = KittiTrackingDataset(data, max_cloud_points=cs.CLOUD_POINTS
                                 ).load_sequence("0000",
                                                 max_frames=SERVE_FRAMES)
        ids = []
        for image, cloud, boxes, dm, proj in cs.tree_frames(a):
            got, _ = trk.step(image, cloud, boxes[dm], proj)
            ids.append(np.asarray(got).tolist())
    json.dump({"checkout": checkout, "result_files": files,
               "served_ids": ids, "runner_int8_launches": runner_launches},
              open(out, "w"))


def prepare(root: str, weights: str) -> None:
    """The tree and the weights, from this checkout's ``chip_smoke``."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from mmmot_tpu_torch.compat.from_jax import save_npz, to_flax_variables
    from mmmot_tpu_torch.config import full_mmmot_int8, full_mmmot_noisy
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

    cs.write_kitti_tree(root)
    cs.write_noisy_detections(root)
    dev = torch.device("cuda", 0)
    net = init_random_(TrackingNet(full_mmmot_int8().model, device=dev), 0)
    cs.calibrate_heads(net, dataclasses.replace(full_mmmot_noisy().data,
                                                root=root), dev)
    save_npz(weights, to_flax_variables(net))


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        run(*argv[1:5])
        return 0
    if argv[:1] != ["--other"] or len(argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_ids: no CUDA device")
    other = os.path.abspath(argv[1])
    with tempfile.TemporaryDirectory() as tmp:
        root, weights = f"{tmp}/kitti", f"{tmp}/weights.npz"
        prepare(root, weights)
        runs = []
        for i, checkout in enumerate((other, HERE)):
            out = f"{tmp}/run{i}.json"
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", checkout, root, weights, out],
                           check=True, stdout=sys.stderr)
            runs.append(json.load(open(out)))
    for r in runs:
        print(json.dumps(r), flush=True)
    import chip_smoke

    equal = all(runs[0][k] == runs[1][k]
                for k in ("result_files", "served_ids"))
    print(chip_smoke.nvidia_smi(), flush=True)
    print(json.dumps({"equal": equal, "result_files": len(runs[0][
        "result_files"]), "served_frames": len(runs[0]["served_ids"])}),
          flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
