"""The port's standalone devkit CLI (``python -m
mmmot_tpu_torch.cli.evaluate``) against the JAX package's
(``mmmot_tpu.cli.evaluate``): on the same result and label txts both
print the same text and write the same summary files, and the port
refuses what the reference refuses."""

import os

import numpy as np
import pytest

from mmmot_tpu.cli.evaluate import main as j_main
from mmmot_tpu.eval import read_seqmap as j_read_seqmap
from mmmot_tpu_torch.cli.evaluate import main
from mmmot_tpu_torch.eval import read_seqmap


def _write(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("".join(r + "\n" for r in rows))


def _rows(rng, frames, objs, cls="Car", score=False):
    """KITTI tracking rows of ``objs`` tracks over ``frames`` frames,
    jittered boxes; with ``score`` the result column of a tracker."""
    out = []
    for f in range(frames):
        for i in range(objs):
            if rng.random() < 0.15:
                continue
            l, t = 60 * i + rng.normal(0, 4), 100 + rng.normal(0, 4)
            row = (f"{f} {i} {cls} 0 0 0.0 {l:.2f} {t:.2f} {l + 50:.2f} "
                   f"{t + 40:.2f} 1.5 1.6 4.0 0.0 1.0 {15 + i}.0 0.0")
            out.append(row + (f" {rng.uniform(0.3, 1):.4f}" if score else ""))
    return out


@pytest.fixture()
def tree(tmp_path):
    """Two sequences of cars and pedestrians: labels, and tracker results
    with jittered boxes, dropped rows and a swapped id."""
    rng = np.random.default_rng(0)
    gt_dir, res_dir = str(tmp_path / "label_02"), str(tmp_path / "results")
    for seq in ("0000", "0001"):
        gt = _rows(rng, 12, 5) + _rows(rng, 12, 2, "Pedestrian")
        res = _rows(rng, 12, 5, score=True) + _rows(rng, 12, 2, "Pedestrian",
                                                    score=True)
        res = [r.replace(" 3 Car", " 9 Car", 1) if r.startswith("7 ") else r
               for r in res]
        _write(os.path.join(gt_dir, f"{seq}.txt"), gt)
        _write(os.path.join(res_dir, f"{seq}.txt"), res)
    seqmap = tmp_path / "seqmap"
    seqmap.write_text("0000 empty 000000 000015\n0001 empty 000000 000012\n")
    return gt_dir, res_dir, str(seqmap)


def _files(d):
    return {n: open(os.path.join(d, n)).read() for n in sorted(os.listdir(d))
            if n.startswith(("summary_", "hota_"))}


@pytest.mark.parametrize("extra", [
    ["--per-sequence"],
    ["--classes", "car,pedestrian", "--summary", "--hota"],
    ["--seqmap", None, "--per-sequence", "--hota"],
    ["--sequences", "0001", "--classes", "pedestrian"]])
def test_prints_what_reference_prints(tree, capsys, extra):
    gt_dir, res_dir, seqmap = tree
    args = ["--gt", gt_dir, "--results", res_dir] + [
        seqmap if a is None else a for a in extra]
    assert j_main(args) == 0
    ref_out, ref_files = capsys.readouterr().out, _files(res_dir)
    for name in ref_files:
        os.remove(os.path.join(res_dir, name))
    assert main(args) == 0
    out = capsys.readouterr().out
    assert out == ref_out
    assert "MOTA" in out
    assert _files(res_dir) == ref_files
    if "--summary" in extra:
        assert {"summary_car.txt", "hota_pedestrian.txt"} <= set(ref_files)


@pytest.mark.parametrize("case", ["missing", "empty", "malformed_seqmap",
                                  "not_a_dir"])
def test_refuses_what_reference_refuses(tree, tmp_path, case):
    gt_dir, res_dir, _ = tree
    if case == "missing":
        args = ["--gt", gt_dir, "--results", res_dir,
                "--sequences", "0000,0099"]
    elif case == "empty":
        os.makedirs(tmp_path / "a")
        os.makedirs(tmp_path / "b")
        args = ["--gt", str(tmp_path / "a"), "--results", str(tmp_path / "b")]
    elif case == "malformed_seqmap":
        bad = tmp_path / "bad"
        bad.write_text("0000 empty 000000\n")
        args = ["--gt", gt_dir, "--results", res_dir, "--seqmap", str(bad)]
    else:
        args = ["--gt", str(tmp_path / "nowhere"), "--results", res_dir]
    with pytest.raises(SystemExit) as ref:
        j_main(args)
    with pytest.raises(SystemExit) as got:
        main(args)
    assert str(got.value) == str(ref.value).replace("mmmot_tpu.", "")


def test_read_seqmap_matches_reference(tree):
    _, _, seqmap = tree
    assert read_seqmap(seqmap) == j_read_seqmap(seqmap) == {"0000": 15,
                                                            "0001": 12}
