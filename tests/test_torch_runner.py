"""The port's KITTI runner and track CLI against the JAX package's.

On the same KITTI-layout tree with the same float32 ``tiny_debug``
weights (crossing ``compat.from_jax``), both runners stream the sequences
in windows of 2 frames, so a window boundary falls inside each sequence
and the tracker state is carried across it.  The result txt files and the
devkit and HOTA summaries must be byte-equal, and the counts and metrics
equal.  The S axis (``track_sequences_from_frames_batched``) must give
the ids of the reference's ``jax.vmap`` and of S serial calls.

With the noisy-detector quality stack (``full_mmmot_noisy``'s
association on a noisy-detection tree) the files must be equal too, with
one allowance: a coverage row's score is the track's last det-head
confidence, float32 sums taken in other orders by each package, so its
printed value may differ within the float32 tolerance of the fixtures
(plus half a unit of its sixth decimal).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
import mmmot_tpu.tracker.kitti_runner as j_kitti_runner
from mmmot_tpu.tracker.kitti_runner import \
    track_kitti_sequences as j_track_kitti
from mmmot_tpu.tracker.sequence import \
    track_sequence_from_frames as j_track_one
from mmmot_tpu.tracker.sequence import \
    track_sequences_from_frames_batched as j_track_batched
from mmmot_tpu_torch.compat.from_jax import save_npz
from mmmot_tpu_torch.config import AssocConfig, tiny_debug
from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences
from mmmot_tpu_torch.tracker.sequence import (
    track_sequence_from_frames, track_sequences_from_frames_batched)
from mmmot_tpu_torch.tracker.tracker import TrackingModule, stack_states

from tests.test_torch_quality import quality_models  # noqa: F401
from tests.test_torch_tracking import (CROP_WINDOW, P,  # noqa: F401
                                       models, raw_sequence)
from tests.torch_port_fixtures import (  # noqa: F401
    ATOL, RTOL, assert_close, build_kitti_tree, tiny_cfg_jax, to_numpy,
    torch_one_thread)

MAX_DETS = 4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return build_kitti_tree(tmp_path_factory.mktemp("tree"))


def data_cfgs(root):
    jd = dataclasses.replace(tiny_cfg_jax().data, root=root,
                             max_dets=MAX_DETS)
    td = dataclasses.replace(tiny_debug().data, root=root, max_dets=MAX_DETS)
    return jd, td


def files_of(d):
    out = {}
    for base, _, names in os.walk(d):
        for n in names:
            p = os.path.join(base, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("batch_sequences,sweep", [(1, ()), (2, (0.5,))])
def test_runner_files_equal_reference(models, tree, tmp_path,
                                      batch_sequences, sweep):
    jnet, variables, net = models
    jd, td = data_cfgs(tree)
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction"))
    kw = dict(window=2, batch_sequences=batch_sequences, score_sweep=sweep)
    # The reference leaves its first window out of the FPS only when that
    # window compiles the program, as the port always does: start from an
    # empty program cache, whatever ran before in this process.
    j_kitti_runner._WINDOW_FNS.clear()
    ref = j_track_kitti(jmod, jd, str(tmp_path / "ref"), **kw)
    out = track_kitti_sequences(TrackingModule(net), td,
                                str(tmp_path / "port"), **kw)
    ref_files, port_files = (files_of(tmp_path / d) for d in ("ref", "port"))
    assert set(port_files) == set(ref_files)
    assert {"0000.txt", "0001.txt", "summary_car.txt",
            "hota_car.txt"} <= set(port_files)
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    assert out["n_dropped"] == ref["n_dropped"] == 0
    assert out["total_frames"] == ref["total_frames"]
    assert out["metrics"].mota == ref["metrics"].mota
    assert out["hota"].hota == ref["hota"].hota
    assert out["n_windows"] == (3 if batch_sequences == 2 else 5)
    # Ids continue across the window boundaries: each car keeps one id
    # through the 5 frames of sequence 0000 in the reference, and so here.
    rows = [l.split() for l in port_files["0000.txt"].decode().splitlines()]
    assert len({r[1] for r in rows}) < len(rows)


def test_batched_equals_vmap_and_serial(models):
    """S=3 sequences with their own cameras and cloud paddings; state
    carried from a first window into a second."""
    jnet, variables, net = models
    seqs = [raw_sequence(s) for s in (11, 14, 28)]
    images, clouds, boxes, det_mask, _ = (np.stack(x) for x in zip(*seqs))
    proj = np.stack([s[4] for s in seqs])
    proj[1, 0, 0] *= 1.1                       # a camera of its own
    cloud_valid = np.ones(clouds.shape[:3], bool)
    cloud_valid[0, :, 400:] = False            # padded cloud entries
    cloud_valid[2, ::2, ::3] = False
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction"))
    kw = dict(compact_capacity=40, extract_chunk=16, crop_window=CROP_WINDOW)

    def ref_one(im, cl, cv, bx, dm, pr):
        return j_track_one(jmod, im, cl, bx, dm, pr, (32, 32), P,
                           cloud_valid=cv, return_state=True, **kw)

    ref, ref_state = jax.jit(jax.vmap(ref_one))(
        *map(jnp.asarray, (images, clouds, cloud_valid, boxes, det_mask,
                           proj)))
    mod = TrackingModule(net)
    out, state = track_sequences_from_frames_batched(
        mod, images, clouds, boxes, det_mask, proj, (32, 32), P,
        cloud_valid=cloud_valid, return_state=True, **kw)
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    np.testing.assert_array_equal(out["n_dropped"].numpy(),
                                  np.asarray(ref["n_dropped"]))
    assert_close(out["det_score"], ref["det_score"])
    for k in ("ids", "ages", "next_id", "mask"):
        np.testing.assert_array_equal(getattr(state, k).numpy(),
                                      np.asarray(getattr(ref_state, k)))
    for s in range(3):
        one = track_sequence_from_frames(
            mod, images[s], clouds[s], boxes[s], det_mask[s], proj[s],
            (32, 32), P, cloud_valid=cloud_valid[s], **kw)
        assert torch.equal(one["ids"], out["ids"][s])
    # The next window continues from the carried state, as the
    # reference's does (same frames again: every track can link).
    out2 = track_sequences_from_frames_batched(
        mod, images, clouds, boxes, det_mask, proj, (32, 32), P,
        cloud_valid=cloud_valid, state0=state, **kw)
    ref2 = jax.jit(jax.vmap(
        lambda im, cl, cv, bx, dm, pr, st: j_track_one(
            jmod, im, cl, bx, dm, pr, (32, 32), P, cloud_valid=cv,
            state0=st, **kw)))(
        *map(jnp.asarray, (images, clouds, cloud_valid, boxes, det_mask,
                           proj)), ref_state)
    np.testing.assert_array_equal(out2["ids"].numpy(),
                                  np.asarray(ref2["ids"]))
    first = out2["ids"][:, 0]
    carried = (first >= 0) & (first <= out["ids"].amax((1, 2))[:, None])
    assert carried.any()


def test_batched_shared_camera_equals_reference(models):
    """One [3, 4] camera for all sequences: the reference's own
    ``track_sequences_from_frames_batched``."""
    jnet, variables, net = models
    seqs = [raw_sequence(s) for s in (12, 20)]
    images, clouds, boxes, det_mask, _ = (np.stack(x) for x in zip(*seqs))
    proj = seqs[0][4]
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction"))
    kw = dict(compact_capacity=24, extract_chunk=8, crop_window=CROP_WINDOW)
    ref = jax.jit(lambda im, cl, bx, dm: j_track_batched(
        jmod, im, cl, bx, dm, proj, (32, 32), P, **kw))(
        *map(jnp.asarray, (images, clouds, boxes, det_mask)))
    out = track_sequences_from_frames_batched(
        TrackingModule(net), images, clouds, boxes, det_mask, proj,
        (32, 32), P, **kw)
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    np.testing.assert_array_equal(out["n_dropped"].numpy(),
                                  np.asarray(ref["n_dropped"]))


def test_stack_states_round_trip(models):
    _, _, net = models
    mod = TrackingModule(net)
    st = stack_states([mod.init_state(MAX_DETS) for _ in range(3)])
    assert st.ids.shape == (3, MAX_DETS) and st.next_id.shape == (3,)
    assert (st.ids == -1).all() and not st.mask.any()
    assert st.feats["fused"].shape == (3, MAX_DETS,
                                       net.cfg.fusion.out_dim)


@pytest.mark.parametrize("field,value,arg", [
    ("point_source", "box3d", None), ("track_class", "All", None),
    ("packed_cache", True, None), (None, None, "radar")])
def test_runner_unported_options_raise(models, tree, tmp_path, field, value,
                                       arg):
    """``track_class="All"`` raises ``ValueError`` without the class gate
    it needs, as in the reference (tests/test_torch_lookalike.py runs
    it), and so does a ``dead_sensor`` other than camera or lidar (the
    dead-sensor runner is held to the reference in
    tests/test_torch_branches.py).  ``point_source="box3d"`` and
    ``packed_cache``, which raised before they were ported, now run
    (their files are held to the reference's in
    tests/test_torch_raw_options.py)."""
    _, _, net = models
    if field == "packed_cache":          # the cache writes into its tree
        tree = shutil.copytree(tree, tmp_path / "tree")
    _, td = data_cfgs(str(tree))
    if field:
        td = dataclasses.replace(td, **{field: value})
    if value in ("box3d", True):
        stats = track_kitti_sequences(TrackingModule(net), td,
                                      str(tmp_path / "res"), window=2,
                                      max_frames=2, evaluate=False)
        assert stats["n_dropped"] == 0 and stats["n_windows"] == 2
        if value is True:
            assert os.path.isdir(os.path.join(tree, ".packed", "frames"))
        return
    err, match = ((ValueError, "class_gate") if value == "All"
                  else (ValueError, "dead_sensor"))
    with pytest.raises(err, match=match):
        track_kitti_sequences(TrackingModule(net), td, str(tmp_path),
                              dead_sensor=arg)


def test_cli_end_to_end_with_npz_weights(models, tree, tmp_path):
    """``python -m mmmot_tpu_torch.cli.track --cpu`` with the reference's
    weights as an npz: the same files as the runner called directly, and
    a submission zip of the sequence files."""
    import zipfile

    from mmmot_tpu_torch.cli.track import main

    _, variables, net = models
    npz = str(tmp_path / "w.npz")
    save_npz(npz, to_numpy(variables))
    argv = ["--config", "tiny_debug", "--data-root", tree, "--cpu",
            "--weights", npz, "--window", "2", "--result-path",
            str(tmp_path / "res"), "--result-sha", "t",
            "--submission-zip", str(tmp_path / "sub.zip")]
    stats = main(argv)
    assert stats["n_dropped"] == 0 and stats["total_frames"] > 0
    _, td = data_cfgs(tree)
    td = dataclasses.replace(td, max_dets=tiny_debug().data.max_dets)
    track_kitti_sequences(TrackingModule(net), td, str(tmp_path / "direct"),
                          window=2)
    cli_files = files_of(tmp_path / "res" / "tiny_debug" / "t")
    assert cli_files == files_of(tmp_path / "direct")
    assert sorted(zipfile.ZipFile(tmp_path / "sub.zip").namelist()) == [
        "0000.txt", "0001.txt"]
    # A directory without image_02/ is no tree (a path that is no
    # directory runs the synthetic mode: tests/test_torch_raw_options.py).
    os.makedirs(tmp_path / "no_tree")
    with pytest.raises(SystemExit, match="no KITTI tracking tree"):
        main(["--config", "tiny_debug", "--cpu", "--data-root",
              str(tmp_path / "no_tree")])


def assert_results_equal(port_files, ref_files):
    """Result trees equal byte for byte, except that the last field of a
    result row (its score) may differ within the fixtures' float32
    tolerance plus half a unit of its sixth printed decimal.  Returns the
    number of rows that used the allowance."""
    assert set(port_files) == set(ref_files)
    loose = 0
    for name, want in ref_files.items():
        got = port_files[name]
        if got == want:
            continue
        assert name.endswith(".txt") and not name.startswith(
            ("summary", "hota")), name
        got_l, want_l = got.decode().splitlines(), want.decode().splitlines()
        assert len(got_l) == len(want_l), name
        for g, w in zip(got_l, want_l):
            if g == w:
                continue
            g, w = g.split(), w.split()
            assert g[:-1] == w[:-1], (name, g, w)
            assert abs(float(g[-1]) - float(w[-1])) <= (
                ATOL + 5e-7 + RTOL * abs(float(w[-1]))), (name, g, w)
            loose += 1
    return loose


@pytest.fixture(scope="module")
def noisy_tree(tmp_path_factory):
    """Two sequences of 20 frames at 384 x 1248 with six cars each and
    noisy detections (``scripts/make_bench_tree.py``: jitter, dropout
    bursts, i.i.d. misses, false positives)."""
    from scripts.make_bench_tree import build_tree

    root = str(tmp_path_factory.mktemp("noisy") / "kitti")
    build_tree(root, n_seqs=2, T=20, n_cars=6)
    return root


@pytest.mark.parametrize("batch_sequences", [1, 2])
def test_noisy_runner_files_equal_reference(quality_models, noisy_tree,
                                            tmp_path, batch_sequences):
    """The tiny model with ``full_mmmot_noisy``'s association, window 8
    (three windows per sequence, ghosts carried across both boundaries),
    with a ``thr_0.5/`` sweep."""
    from tests.test_torch_quality import NOISY

    jnet, variables, net = quality_models
    jd = dataclasses.replace(tiny_cfg_jax().data, root=noisy_tree,
                             det_source="noisy")
    td = dataclasses.replace(tiny_debug().data, root=noisy_tree,
                             det_source="noisy")
    kw = dict(window=8, batch_sequences=batch_sequences, score_sweep=(0.5,))
    ref = j_track_kitti(JTrackingModule(jnet, variables, JAssocConfig(
        solver="auction", **NOISY)), jd, str(tmp_path / "ref"), **kw)
    out = track_kitti_sequences(TrackingModule(net, AssocConfig(**NOISY)),
                                td, str(tmp_path / "port"), **kw)
    port_files = files_of(tmp_path / "port")
    loose = assert_results_equal(port_files,
                                 files_of(tmp_path / "ref"))
    assert {"0000.txt", "0001.txt", "summary_car.txt", "hota_car.txt",
            "thr_0.5/0000.txt"} <= set(port_files)
    assert out["n_dropped"] == ref["n_dropped"] == 0
    assert out["metrics"].mota == ref["metrics"].mota
    assert out["hota"].hota == ref["hota"].hota
    assert out["sweep"][0.5].mota == ref["sweep"][0.5].mota
    ghost_rows = sum(int((o["ghost_ids"] >= 0).sum())
                     for o in out["outputs"].values())
    assert ghost_rows > 0 and loose <= ghost_rows
    rej = sum(int(((o["ids"] < 0) & o["det_mask"]).sum())
              for o in out["outputs"].values())
    assert rej > 0
