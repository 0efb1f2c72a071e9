"""The raw path's options against the JAX package: 3D boxes
(``data/box3d.py``, ``box3d_sample_batched``, the runner with
``point_source="box3d"``), the packed cache (``data/packed_cache.py``
and the dataset's frame and sequence caches, read across the two
packages), the per-slot branch (``compact_capacity=None``) and the
synthetic mode of ``cli/track``.

Box cases mirror ``tests/test_box3d_meters.py`` and
``tests/test_preprocess.py``; the cache cases ``tests/test_packed_cache.py``.
Sampled indices must equal the reference's exactly (each sample carries
a unique tag), xyz within float32 rounding; ids and result files equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.config import DataConfig as JDataConfig
from mmmot_tpu.data import box3d as jbox3d
from mmmot_tpu.data import kitti_dataset as j_kitti_dataset
from mmmot_tpu.ops.frustum import box3d_sample_batched as j_box3d_batched
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
import mmmot_tpu.tracker.kitti_runner as j_kitti_runner
from mmmot_tpu.tracker.kitti_runner import \
    track_kitti_sequences as j_track_kitti
from mmmot_tpu_torch.compat.from_jax import save_npz
from mmmot_tpu_torch.config import DataConfig
from mmmot_tpu_torch.data import box3d
from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset
from mmmot_tpu_torch.ops.frustum import box3d_sample, box3d_sample_batched
from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_runner import data_cfgs, files_of, tree  # noqa: F401
from tests.test_torch_tracking import P, models, raw_sequence  # noqa: F401
from tests.torch_port_fixtures import (build_kitti_tree,  # noqa: F401
                                       tiny_cfg_jax, to_numpy,
                                       torch_one_thread)

FIELDS = ("images", "clouds", "cloud_valid", "boxes", "det_mask", "scores",
          "gt_ids", "proj", "frame_ids", "boxes3d", "has_3d",
          "velo_to_rect", "cls_ids")
# velodyne (x forward, y left, z up) -> rect (x right, y down, z forward)
VELO_TO_RECT = np.array([[0.0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]],
                        np.float32)


def box(h, w, l, x, y, z, ry):
    return np.array([h, w, l, x, y, z, ry], float)


# ---------------------------------------------------------------- boxes

def test_corners_axis_aligned():
    c = box3d.box3d_corners(box(2.0, 1.0, 4.0, 10.0, 1.0, 20.0, 0.0))
    assert c.shape == (8, 3)
    np.testing.assert_allclose(c[:, 0].min(), 8.0)    # x: 10 +- l/2
    np.testing.assert_allclose(c[:, 0].max(), 12.0)
    np.testing.assert_allclose(c[:, 2].min(), 19.5)   # z: 20 +- w/2
    np.testing.assert_allclose(c[:, 2].max(), 20.5)
    np.testing.assert_allclose(c[:, 1].min(), -1.0)   # y: bottom 1, top -1
    np.testing.assert_allclose(c[:, 1].max(), 1.0)


def test_corners_and_membership_equal_reference_numpy_and_torch():
    """Random boxes and points: corners equal to the reference's (numpy
    exactly; torch float32 within rounding), membership equal."""
    r = np.random.default_rng(4)
    boxes = np.concatenate([r.uniform(0.5, 4, (6, 3)),
                            r.uniform(-10, 10, (6, 3)),
                            r.uniform(-3, 3, (6, 1))], 1)
    np.testing.assert_array_equal(box3d.box3d_corners(boxes),
                                  jbox3d.box3d_corners(boxes))
    got = box3d.box3d_corners(torch.tensor(boxes, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), jbox3d.box3d_corners(boxes),
                               atol=1e-5)
    pts = r.uniform(-12, 12, (400, 3))
    for b in boxes:
        want = np.asarray(jbox3d.points_in_box3d(pts, b))
        np.testing.assert_array_equal(box3d.points_in_box3d(pts, b), want)
        np.testing.assert_array_equal(
            box3d.points_in_box3d(torch.tensor(pts), torch.tensor(b))
            .numpy(), want)


def test_points_in_box_rotation():
    b = box(2.0, 2.0, 4.0, 0.0, 0.0, 0.0, np.pi / 2)  # yaw 90deg: l<->w
    pts = np.array([[0.5, -1.0, 1.5], [1.5, -1.0, 0.5], [0.0, -3.0, 0.0]])
    assert box3d.points_in_box3d(pts, b).tolist() == [True, False, False]


@pytest.mark.parametrize("a,b,want", [
    (box(1.5, 1.6, 3.9, 0, 1, 10, 0.3), box(1.5, 1.6, 3.9, 0, 1, 10, 0.3),
     (1.0, 1.0)),
    (box(1.5, 1.6, 3.9, 0, 1, 10, 0.3), box(1.5, 1.6, 3.9, 50, 1, 10, 0.3),
     (0.0, 0.0)),
    (box(2, 2, 2, 0, 0, 0, 0.0), box(2, 2, 2, 1.0, 0, 0, 0.0),
     (1 / 3, 1 / 3)),                      # half a length apart in x
    (box(2, 2, 2, 0, 0, 0, 0.0), box(2, 2, 2, 0, -1.0, 0, 0.0),
     (1 / 3, 1.0)),                        # half a height apart
])
def test_iou3d_cases(a, b, want):
    got = box3d.iou3d(a, b)
    assert got == pytest.approx(want, abs=1e-6)
    assert got == jbox3d.iou3d(a, b)


def test_iou3d_rotated_equals_reference():
    r = np.random.default_rng(8)
    for _ in range(20):
        a = box(*r.uniform(1, 3, 3), *r.uniform(-2, 2, 3), r.uniform(-3, 3))
        b = a + np.concatenate([r.uniform(-0.5, 0.5, 3), r.uniform(-2, 2, 3),
                                r.uniform(-1, 1, 1)])
        assert box3d.iou3d(a, b) == jbox3d.iou3d(a, b)


# ------------------------------------------------------------- sampling

def tagged_clouds(r, lead, M, velodyne):
    """Clouds [*lead, M, 4] whose last channel tags each point uniquely;
    rect coordinates, or velodyne ones that VELO_TO_RECT takes there."""
    x = r.uniform(-10, 10, lead + (M,))
    y = r.uniform(-3, 2, lead + (M,))
    z = r.uniform(0, 30, lead + (M,))
    tag = np.broadcast_to(np.arange(M) / M, lead + (M,))
    xyz = (z, -x, -y) if velodyne else (x, y, z)
    return np.stack(xyz + (tag,), -1).astype(np.float32)


def random_boxes3d(r, lead, N):
    return np.concatenate([r.uniform(1.0, 2.5, lead + (N, 1)),
                           r.uniform(1.0, 3.0, lead + (N, 2)),
                           r.uniform(-6, 6, lead + (N, 1)),
                           r.uniform(0.5, 2.0, lead + (N, 1)),
                           r.uniform(4, 26, lead + (N, 1)),
                           r.uniform(-3, 3, lead + (N, 1))],
                          -1).astype(np.float32)


@pytest.mark.parametrize("velodyne", [False, True])
def test_box3d_sample_batched_equals_reference(velodyne):
    """[S, T] frames of clouds with padded entries, boxes with masked
    slots: the sampled points' tags (their cloud indices) equal the
    reference's exactly, xyz within float32 rounding, masks equal."""
    r = np.random.default_rng(21 + velodyne)
    lead, M, N, Pn = (2, 3), 700, 5, 16
    pts = tagged_clouds(r, lead, M, velodyne)
    b3 = random_boxes3d(r, lead, N)
    dm = r.random(lead + (N,)) < 0.8
    pv = r.random(lead + (M,)) < 0.9
    v2r = VELO_TO_RECT if velodyne else None
    ref_s, ref_m = jax.jit(lambda p, b, d, q: j_box3d_batched(
        p, b, Pn, velo_to_rect=None if v2r is None else jnp.asarray(v2r),
        det_mask=d, point_valid=q))(pts, b3, dm, pv)
    got_s, got_m = box3d_sample_batched(
        *map(torch.from_numpy, (pts, b3)), Pn,
        None if v2r is None else torch.from_numpy(v2r),
        torch.from_numpy(dm), torch.from_numpy(pv))
    ref_s, ref_m = np.asarray(ref_s), np.asarray(ref_m)
    np.testing.assert_array_equal(got_m.numpy(), ref_m)
    assert ref_m.sum() > 20 and (~ref_m).any()
    np.testing.assert_array_equal(got_s[..., 3].numpy(), ref_s[..., 3])
    np.testing.assert_allclose(got_s[..., :3].numpy(), ref_s[..., :3],
                               atol=1e-5)


def test_box3d_sample_matches_host_oracle():
    """The reference's oracle case: the first sample is the first in-box
    point in scan order, centred on the selection's centroid; an empty
    box samples nothing."""
    r = np.random.default_rng(9)
    M, Pn = 500, 32
    pts = np.stack([r.uniform(-10, 10, M), r.uniform(-3, 2, M),
                    r.uniform(0, 40, M), r.uniform(0, 1, M)],
                   -1).astype(np.float32)
    boxes = np.array([[1.5, 1.7, 4.0, 2.0, 1.6, 15.0, 0.3],
                      [1.8, 0.6, 0.9, -4.0, 1.2, 8.0, -1.2],
                      [1.5, 1.7, 4.0, 100.0, 0.0, 100.0, 0.0]], np.float32)
    sampled, mask = box3d_sample(torch.from_numpy(pts)[None],
                                 torch.from_numpy(boxes)[None], Pn)
    sampled, mask = sampled[0].numpy(), mask[0].numpy()
    for k in range(len(boxes)):
        inside = box3d.points_in_box3d(pts[:, :3], boxes[k])
        assert mask[k].sum() == min(inside.sum(), Pn), k
        if inside.sum():
            sel = pts[inside][:Pn]
            np.testing.assert_allclose(sampled[k, 0, :3],
                                       pts[inside][0, :3]
                                       - sel[:, :3].mean(0), atol=1e-4)
    assert mask[2].sum() == 0


def test_box3d_runner_files_equal_reference(models, tree, tmp_path):
    """``point_source="box3d"`` through both runners on the tree, whose
    labels carry 3D boxes: result files byte-equal, every box sampled."""
    jnet, variables, net = models
    jd, td = data_cfgs(tree)
    jd = dataclasses.replace(jd, point_source="box3d")
    td = dataclasses.replace(td, point_source="box3d")
    j_kitti_runner._WINDOW_FNS.clear()
    ref = j_track_kitti(JTrackingModule(jnet, variables,
                                        JAssocConfig(solver="auction")),
                        jd, str(tmp_path / "ref"), window=2)
    out = track_kitti_sequences(TrackingModule(net), td,
                                str(tmp_path / "port"), window=2)
    ref_files, port_files = (files_of(tmp_path / d) for d in ("ref", "port"))
    assert set(port_files) == set(ref_files) >= {"0000.txt", "0001.txt"}
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    assert out["n_dropped"] == ref["n_dropped"] == 0
    # The tree's boxes hold points of the scan: the box3d samples differ
    # from the frustum's (the runner reads them).
    arrs = KittiTrackingDataset(td, max_cloud_points=32768).load_sequence(
        "0000")
    v2r = torch.from_numpy(arrs.velo_to_rect)
    _, m3 = box3d_sample(torch.from_numpy(arrs.clouds),
                         torch.from_numpy(arrs.boxes3d), P, v2r,
                         torch.from_numpy(arrs.det_mask),
                         torch.from_numpy(arrs.cloud_valid))
    assert m3.any(-1)[torch.from_numpy(arrs.det_mask)].sum() > 0


# ------------------------------------------------------------ per slot

@pytest.mark.parametrize("point_source", ["frustum", "box3d"])
def test_per_slot_ids_equal_reference(models, point_source):
    """``compact_capacity=None``: whole-frame crops of every slot, no crop
    window, nothing dropped; ids equal to the reference's per-slot
    branch, with frustum and with 3D-box points."""
    jnet, variables, net = models
    images, clouds, boxes, det_mask, proj = raw_sequence(11)
    r = np.random.default_rng(2)
    b3 = random_boxes3d(r, (det_mask.shape[0],), det_mask.shape[1])
    kw3 = {}
    if point_source == "box3d":
        kw3 = dict(boxes3d=b3, velo_to_rect=VELO_TO_RECT,
                   point_source="box3d")
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction"))
    ref = jax.jit(lambda im, cl, bx, dm: j_track(
        jmod, im, cl, bx, dm, jnp.asarray(proj), (32, 32), P,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw3.items()}))(
        *map(jnp.asarray, (images, clouds, boxes, det_mask)))
    out = track_sequence_from_frames(TrackingModule(net), images, clouds,
                                     boxes, det_mask, proj, (32, 32), P,
                                     **kw3)
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    assert int(out["n_dropped"]) == int(ref["n_dropped"]) == 0
    assert (out["ids"].numpy()[det_mask] >= 0).all()


# --------------------------------------------------------- packed cache

def _cfg(cls, root, **kw):
    return cls(root=root, max_dets=4, crop_size=(32, 32), point_len=16,
               packed_cache=True, **kw)


def entries(root):
    return sorted(e for e in os.listdir(os.path.join(root, ".packed"))
                  if e != "frames")


def test_pack_roundtrip_and_memmap(tmp_path):
    root = build_kitti_tree(tmp_path)
    fresh = KittiTrackingDataset(_cfg(DataConfig, root),
                                 max_cloud_points=256).load_sequence("0000")
    first = entries(root)
    assert len(first) == 1 and first[0].startswith("0000-")
    cached = KittiTrackingDataset(_cfg(DataConfig, root),
                                  max_cloud_points=256).load_sequence("0000")
    assert isinstance(cached.images, np.memmap)
    assert isinstance(cached.clouds, np.memmap)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(fresh, f)),
                                      np.asarray(getattr(cached, f)), f)
    assert entries(root) == first          # a hit writes nothing


def test_regenerated_detections_invalidate(tmp_path):
    root = build_kitti_tree(tmp_path)
    before = KittiTrackingDataset(_cfg(DataConfig, root),
                                  max_cloud_points=256).load_sequence("0000")
    lbl = os.path.join(root, "label_02", "0000.txt")
    lines = open(lbl).read().splitlines()
    with open(lbl, "w") as fh:
        fh.write("\n".join(lines[::2]) + "\n")
    os.utime(lbl, ns=(1, 1))
    after = KittiTrackingDataset(_cfg(DataConfig, root),
                                 max_cloud_points=256).load_sequence("0000")
    assert not np.array_equal(before.det_mask, after.det_mask)
    assert len(entries(root)) == 2


def test_training_pairs_never_sequence_cached(tmp_path):
    root = build_kitti_tree(tmp_path)
    ds = KittiTrackingDataset(_cfg(DataConfig, root), max_cloud_points=256)
    for _ in ds.training_pairs("0000", np.random.default_rng(0), 3):
        pass
    assert os.listdir(os.path.join(root, ".packed")) == ["frames"]


def test_frame_decode_cache_for_training_pairs(tmp_path):
    """Pairs read the frame cache: equal pixels, one .npy a decoded
    frame, and a re-encoded frame gets an entry of its own."""
    from mmmot_tpu_torch.data.png import write_png

    root = build_kitti_tree(tmp_path)
    ds = KittiTrackingDataset(_cfg(DataConfig, root), max_cloud_points=256)
    fresh = [p.images.copy() for p in ds.training_pairs(
        "0000", np.random.default_rng(1), 3)]
    fdir = os.path.join(root, ".packed", "frames", "0000")
    assert len(os.listdir(fdir)) >= 2
    ds2 = KittiTrackingDataset(_cfg(DataConfig, root), max_cloud_points=256)
    hit = [p.images.copy() for p in ds2.training_pairs(
        "0000", np.random.default_rng(1), 3)]
    for a, b in zip(fresh, hit):
        np.testing.assert_array_equal(a, b)
    assert ds2.decode_s == 0.0            # every frame came from the cache
    f0 = os.path.join(root, "image_02", "0000", "000000.png")
    img = np.asarray(ds.load_sequence("0000", max_frames=1).images[0,
                                                                   :48, :96])
    img = img.copy()
    img[:8] = 255
    write_png(f0, img)
    os.utime(f0, ns=(2, 2))
    arr = KittiTrackingDataset(_cfg(DataConfig, root), max_cloud_points=256
                               ).load_sequence("0000", max_frames=1)
    assert (np.asarray(arr.images[0, :8, :96]) == 255).all()


def test_cli_packed_cache_identical_results(tmp_path):
    """``cli/track --packed-cache``: cold (packs) and warm (memmaps) runs
    write the files of a run without the cache."""
    from mmmot_tpu_torch.cli.track import main

    root = build_kitti_tree(tmp_path)

    def run(tag, *extra):
        main(["--config", "tiny_debug", "--cpu", "--data-root", root,
              "--window", "2", "--no-eval", "--result-path",
              str(tmp_path / tag), *extra])
        return files_of(tmp_path / tag)

    plain = run("plain")
    assert run("cold", "--packed-cache") == plain
    assert run("warm", "--packed-cache") == plain
    assert len(entries(root)) == 2         # both sequences packed once


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cache_written_by_one_package_reads_in_the_other(tmp_path, writer):
    """The key, layout and manifest are the reference's: a tree packed by
    either package is a hit for the other, field for field."""
    root = build_kitti_tree(tmp_path)
    port = KittiTrackingDataset(_cfg(DataConfig, root), max_cloud_points=256)
    ref = j_kitti_dataset.KittiTrackingDataset(_cfg(JDataConfig, root),
                                               max_cloud_points=256)
    first, second = (port, ref) if writer == "port" else (ref, port)
    packed = first.load_sequence("0001")
    frames = sorted(os.listdir(os.path.join(root, ".packed", "frames",
                                            "0001")))
    got = second.load_sequence("0001")
    assert isinstance(got.images, np.memmap)      # a hit, not a re-pack
    assert len(entries(root)) == 1
    assert sorted(os.listdir(os.path.join(root, ".packed", "frames",
                                          "0001"))) == frames
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(packed, f)),
                                      np.asarray(getattr(got, f)), f)


# ------------------------------------------------------- synthetic CLI

def reference_cli_weights(path: str) -> str:
    """The weights the reference's ``cli/track`` starts from without
    ``--load-path`` (its train state from ``PRNGKey(0)`` on its dummy
    batch), as an npz for the port's ``--weights``."""
    from mmmot_tpu.models import model_entry
    from mmmot_tpu.train import create_train_state

    cfg = tiny_cfg_jax()
    N, P_, crop = cfg.data.max_dets, cfg.data.point_len, cfg.data.crop_size
    dummy = {"crops": jnp.zeros((1, 2, N) + tuple(crop) + (3,)),
             "points": jnp.zeros((1, 2, N, P_, 4)),
             "point_mask": jnp.ones((1, 2, N, P_), bool),
             "det_mask": jnp.ones((1, 2, N), bool)}
    state = create_train_state(model_entry(cfg.model), cfg.train,
                               jax.random.PRNGKey(0), dummy)
    save_npz(path, to_numpy({"params": state.params,
                             "batch_stats": state.batch_stats}))
    return path


def test_synthetic_cli_files_equal_reference(tmp_path):
    """No data root: both CLIs track the same synthetic worlds (seeds
    2000 + s) with the same weights (the reference's own initial state,
    carried to the port as an npz) and write the same result files."""
    from mmmot_tpu.cli.track import main as j_main
    from mmmot_tpu_torch.cli.track import main

    argv = ["--cpu", "--sequences", "2", "--frames", "8"]
    j_main(["--config", "experiments/tiny_debug/config.yaml",
            "--result-path", str(tmp_path / "ref"), *argv])
    npz = reference_cli_weights(str(tmp_path / "w.npz"))
    stats = main(["--config", "tiny_debug", "--data-root",
                  str(tmp_path / "nowhere"), "--weights", npz,
                  "--result-path", str(tmp_path / "port"), *argv])
    ref_files = files_of(tmp_path / "ref")
    port_files = files_of(tmp_path / "port")
    assert sorted(port_files) == sorted(ref_files) == [
        "tiny_debug/latest/0000.txt", "tiny_debug/latest/0001.txt"]
    assert port_files == ref_files
    assert stats["n_sequences"] == 2 and stats["total_frames"] == 8
    assert 0 <= stats["metrics"].mota <= 1
    with pytest.raises(SystemExit, match="sequence COUNT"):
        main(["--config", "tiny_debug", "--cpu", "--data-root",
              str(tmp_path / "nowhere"), "--sequences", "0000,0001"])
