"""The port's train CLI on a small KITTI tree, the twin of
``tests/test_cli_train_real.py``: held-out validation through the KITTI
runner, the best-MOTA checkpoint and the JSONL scalars; then the track
CLI's ``--load-path`` tracks the tree with that checkpoint and writes
the validation's result file again, byte for byte."""

import dataclasses
import filecmp
import os

from mmmot_tpu_torch.cli import track as track_cli
from mmmot_tpu_torch.cli import train as train_cli
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.train.checkpoint import latest_step
from mmmot_tpu_torch.utils.scalars import read_scalars

from tests.torch_port_fixtures import (build_kitti_tree,
                                       torch_one_thread)  # noqa: F401


def test_train_cli_real_tree_then_track_with_checkpoint(tmp_path):
    root = build_kitti_tree(tmp_path)
    base = tiny_debug()
    cfg = dataclasses.replace(
        base, name="tiny_kitti_train",
        data=dataclasses.replace(base.data, root=root, augmentation=False),
        train=dataclasses.replace(base.train, epochs=1, batch_size=2,
                                  log_every=2,
                                  ckpt_dir=str(tmp_path / "ckpt")))
    log_dir = str(tmp_path / "runs")
    args = train_cli.parse_args([
        "--config", "tiny_debug", "--cpu", "--steps-per-epoch", "4",
        "--val-every", "1", "--val-window", "2", "--val-frames", "0",
        "--result-path", str(tmp_path / "results"), "--log-dir", log_dir])
    result = train_cli.run(cfg, args)
    assert result["state"].step == 4 and len(result["losses"]) == 4

    # Held-out validation on the tree: the last sequence (0001) only.
    val_dir = tmp_path / "results" / "tiny_kitti_train" / "epoch0"
    assert (val_dir / "0001.txt").exists()
    assert (val_dir / "summary_car.txt").exists()
    assert not (val_dir / "0000.txt").exists()

    ckpt = tmp_path / "ckpt"
    assert latest_step(str(ckpt / "tiny_kitti_train")) == 4
    best = str(ckpt / "tiny_kitti_train_best")
    assert latest_step(best) == 4

    tags = {r["tag"] for r in read_scalars(log_dir)}
    assert {"loss/total", "lr", "val/mota"} <= tags
    motas = read_scalars(log_dir, "val/mota")
    assert len(motas) == 1 and 0.0 <= abs(motas[0]["value"]) <= 1.0
    assert motas[0]["value"] == result["val"]["epoch0"].mota

    track_cli.main(["--config", "tiny_debug", "--data-root", root,
                    "--load-path", best, "--cpu", "--window", "2",
                    "--sequences", "0001",
                    "--result-path", str(tmp_path / "tracked"),
                    "--result-sha", "best"])
    tracked = tmp_path / "tracked" / "tiny_debug" / "best" / "0001.txt"
    assert os.path.getsize(tracked) > 0
    assert filecmp.cmp(tracked, val_dir / "0001.txt", shallow=False)
