"""Port parity of the training data path and its helpers: the synthetic
generator (exactly equal), augmentation applied to the reference's own
``jax.random`` draws, the per-slot crop resize and the batched frustum
sampler, the KITTI pair loader on a small tree, the crops-given
``track_sequence`` (ids exactly equal) and the torch checkpoints.

Float tolerance: the fixtures' ``RTOL, ATOL = 1e-4, 1e-5`` (float32
means and sums in other orders); masks, labels, boxes, synthetic arrays
and track ids exactly.
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
from mmmot_tpu.data import synthetic as jsyn
from mmmot_tpu.data.augment import augment_batch as j_augment_batch
from mmmot_tpu.data.kitti_loader import KittiPairLoader as JKittiPairLoader
from mmmot_tpu.ops.crop_resize import crop_and_resize_batched as j_crop
from mmmot_tpu.ops.frustum import frustum_sample_batched as j_frustum
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker.sequence import track_sequence as j_track_sequence
from mmmot_tpu_torch.config import DataConfig, tiny_debug
from mmmot_tpu_torch.data import synthetic
from mmmot_tpu_torch.data.augment import (apply_augment, augment_batch,
                                          draw_augment)
from mmmot_tpu_torch.data.kitti_loader import KittiPairLoader
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
from mmmot_tpu_torch.ops.crop_resize import crop_and_resize_batched
from mmmot_tpu_torch.ops.frustum import frustum_sample_batched
from mmmot_tpu_torch.tracker.sequence import track_sequence
from mmmot_tpu_torch.tracker.tracker import TrackingModule
from mmmot_tpu_torch.train.checkpoint import (latest_step, load_weights,
                                              restore_checkpoint,
                                              save_checkpoint)
from mmmot_tpu_torch.train.trainer import create_train_state, train_step

from tests.torch_port_fixtures import (assert_close, build_kitti_tree,
                                       init_flax, port_net, tiny_cfg_jax,
                                       torch_one_thread)  # noqa: F401

SYN_KW = [dict(), dict(drop_prob=0.2, fp_prob=0.3),
          dict(jitter_px=2.0, degrade_prob=0.3, fp_prob=0.2)]


@pytest.mark.parametrize("kw", SYN_KW)
def test_synthetic_generator_equal(kw):
    a = jsyn.make_synthetic_sequence(np.random.default_rng(5),
                                     num_frames=7, **kw)
    b = synthetic.make_synthetic_sequence(np.random.default_rng(5),
                                          num_frames=7, **kw)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(b, f.name),
                                      getattr(a, f.name), err_msg=f.name)
    ta = jsyn.make_training_batch(np.random.default_rng(6), batch_size=3,
                                  **kw)
    tb = synthetic.make_training_batch(np.random.default_rng(6),
                                       batch_size=3, **kw)
    assert list(ta) == list(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(tb[k], ta[k], err_msg=k)


def small_batch(seed=2):
    return synthetic.make_training_batch(
        np.random.default_rng(seed), batch_size=3, num_slots=6,
        crop_size=(12, 10), points_per_det=8, fp_prob=0.2)


def test_augment_applies_reference_draws():
    """The reference's ``augment_batch`` against the port's apply step
    fed the draws the reference makes from the same key (its split:
    flip, brightness, contrast, saturation, then noise and keep)."""
    b = small_batch()
    key = jax.random.PRNGKey(4)
    ref = j_augment_batch(key, {k: jnp.asarray(v) for k, v in b.items()})
    B, _, N = b["crops"].shape[:3]
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    slot = (B, 1, N, 1, 1, 1)
    kp1, kp2 = jax.random.split(k5)
    draws = {
        "flip": jax.random.bernoulli(k1, 0.5, (B, 1, N)),
        "brightness": jax.random.uniform(k2, slot, minval=0.8, maxval=1.2),
        "contrast": jax.random.uniform(k3, slot, minval=0.8, maxval=1.2),
        "saturation": jax.random.uniform(k4, slot, minval=0.8, maxval=1.2),
        "noise": 0.01 * jax.random.normal(kp1, b["points"].shape),
        "keep": jax.random.bernoulli(kp2, 0.9, b["point_mask"].shape)}
    got = apply_augment({k: torch.tensor(v) for k, v in b.items()},
                        {k: torch.tensor(np.asarray(v))
                         for k, v in draws.items()})
    assert_close(got["crops"], np.asarray(ref["crops"]))
    assert_close(got["points"], np.asarray(ref["points"]))
    np.testing.assert_array_equal(got["point_mask"].numpy(),
                                  np.asarray(ref["point_mask"]))
    for k in ("det_mask", "gt_link", "gt_ids", "boxes"):
        np.testing.assert_array_equal(got[k].numpy(), b[k])
    # Dropout happened, and a detection that had points keeps some.
    pm0 = b["point_mask"]
    pm = got["point_mask"].numpy()
    assert pm.sum() < pm0.sum()
    assert (pm.any(-1) == pm0.any(-1)).all()


def test_augment_draws_shared_across_frames():
    """The port's own draws: a detection transforms the same way in both
    frames of a sample, and no valid detection loses every point."""
    b = {k: torch.tensor(v) for k, v in small_batch(3).items()}
    b["crops"][:, 1] = b["crops"][:, 0]
    gen = torch.Generator().manual_seed(0)
    draws = draw_augment(gen, b)
    assert draws["flip"].shape == (3, 1, 6)
    assert draws["brightness"].min() >= 0.8 and draws["brightness"].max() <= 1.2
    out = augment_batch(torch.Generator().manual_seed(0), b)
    assert torch.equal(out["crops"][:, 0], out["crops"][:, 1])
    assert not torch.equal(out["crops"], b["crops"])
    assert torch.equal(out["point_mask"].any(-1), b["point_mask"].any(-1))
    assert augment_batch(torch.Generator().manual_seed(0), b)["crops"].equal(
        out["crops"])


def test_crop_resize_and_frustum_batched_match_reference():
    """``crop_and_resize_batched`` (the reference's ``method="mxu"``) and
    ``frustum_sample_batched`` over [2, 3] frames: sampled masks (which
    points) exactly, values within the tolerance."""
    r = np.random.default_rng(9)
    L, H, W, Nd, M, P = (2, 3), 40, 90, 5, 300, 12
    images = r.integers(0, 256, L + (H, W, 3)).astype(np.float32)
    l = r.uniform(-10, W - 20, L + (Nd,))
    t = r.uniform(-5, H - 10, L + (Nd,))
    boxes = np.stack([l, t, l + r.uniform(5, 40, L + (Nd,)),
                      t + r.uniform(5, 30, L + (Nd,))], -1).astype(np.float32)
    det_mask = r.random(L + (Nd,)) < 0.8
    # Under jit, as the reference's loader runs it (XLA's rounding of the
    # sample positions, which the port follows).
    ref = jax.jit(lambda im, bx, dm: j_crop(im, bx, (16, 12), dm,
                                            method="mxu"))(
        jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(det_mask))
    got = crop_and_resize_batched(torch.tensor(images), torch.tensor(boxes),
                                  (16, 12), torch.tensor(det_mask))
    assert got.shape == ref.shape
    assert_close(got, np.asarray(ref))
    clouds = np.stack([r.uniform(-10, 10, L + (M,)),
                       r.uniform(-2, 2, L + (M,)),
                       r.uniform(1, 30, L + (M,)),
                       r.uniform(0, 1, L + (M,))], -1).astype(np.float32)
    valid = r.random(L + (M,)) < 0.9
    proj = np.asarray([[40.0, 0, W / 2, 0], [0, 40.0, H / 2, 0],
                       [0, 0, 1, 0]], np.float32)
    ref_pts, ref_m = jax.jit(lambda c, bx, pr, dm, pv: j_frustum(
        c, bx, pr, P, det_mask=dm, point_valid=pv))(
        *map(jnp.asarray, (clouds, boxes, proj, det_mask, valid)))
    pts, m = frustum_sample_batched(torch.tensor(clouds),
                                    torch.tensor(boxes), torch.tensor(proj),
                                    P, det_mask=torch.tensor(det_mask),
                                    point_valid=torch.tensor(valid))
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref_m))
    assert m.any() and (~m).any()
    assert_close(pts, np.asarray(ref_pts))


def test_kitti_pair_loader_matches_reference(tmp_path):
    """Two batches of three pairs from the reference's loader and the
    port's on the same tree and seed."""
    root = build_kitti_tree(tmp_path)
    kw = dict(root=root, max_dets=4, crop_size=(32, 32), point_len=16)
    ref = JKittiPairLoader(JDataConfig(**kw), seed=3).batches(3)
    port = KittiPairLoader(DataConfig(**kw), seed=3, device="cpu").batches(3)
    exact = ("boxes", "det_mask", "gt_ids", "gt_link", "gt_new", "gt_end",
             "point_mask")
    for _ in range(2):
        rb, pb = next(ref), next(port)
        assert list(rb) == list(pb)
        for k in exact:
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]),
                                          err_msg=k)
        for k in ("crops", "points"):
            assert pb[k].shape == rb[k].shape
            assert_close(pb[k], np.asarray(rb[k]), err_msg=k)
        assert pb["det_mask"].sum() > 0 and pb["gt_link"].sum() > 0


@pytest.mark.parametrize("capacity", [None, 30, 9])
def test_track_sequence_ids_equal_reference(capacity):
    """The crops-given ``track_sequence`` on a synthetic sequence: every
    slot, a capacity that holds every valid slot and one that drops
    some (counted in ``n_dropped``).  The reference extracts in chunks
    of 8 and the port at once: eval-mode BatchNorm is per element."""
    jcfg = tiny_cfg_jax().model
    jnet, variables = init_flax(jcfg, seed=3)
    params = jax.tree.map(lambda x: x, variables["params"])
    for head in ("new_mlp", "end_mlp"):
        params["new_end"][head]["dense_1"]["bias"] = jnp.full((1,), -3.0)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    world = jsyn.make_synthetic_sequence(np.random.default_rng(12),
                                         num_frames=6, fp_prob=0.2)
    args = (world.crops, world.points, world.point_mask, world.det_mask)
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction"))
    ref = jax.jit(lambda c, p, pm, dm: j_track_sequence(
        jmod, c, p, pm, dm, compact_capacity=capacity, extract_chunk=8))(
        *map(jnp.asarray, args))
    out = track_sequence(TrackingModule(port_net(variables,
                                                 tiny_debug().model)),
                         *args, compact_capacity=capacity)
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    assert int(out["n_dropped"]) == int(ref["n_dropped"])
    assert_close(out["det_score"], np.asarray(ref["det_score"]))
    if capacity == 9:
        assert int(out["n_dropped"]) > 0
    else:
        assert int(out["n_dropped"]) == 0
        ids = out["ids"].numpy()
        assert len(np.unique(ids[ids >= 0])) < world.det_mask.sum()


def test_checkpoint_round_trip_keep_and_missing(tmp_path):
    cfg = tiny_debug()
    b = synthetic.make_training_batch(np.random.default_rng(0), batch_size=2)
    batch = {k: torch.tensor(v) for k, v in b.items()}

    def fresh():
        net = init_random_(TrackingNet(cfg.model, device="cpu"), 0)
        return create_train_state(net, cfg.train, 5)

    state, _ = train_step(fresh(), batch)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, state, state.step, metrics={"mota": 0.5})
    assert latest_step(d) == 1
    restored = restore_checkpoint(d, fresh())
    assert restored.step == 1
    for k, v in state.net.state_dict().items():
        assert torch.equal(restored.net.state_dict()[k], v), k
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(sb["state"][i][k], v), (i, k)
    # The restored state trains on exactly as the saved one does.
    _, m1 = train_step(state, batch)
    _, m2 = train_step(restored, batch)
    assert float(m1["total"]) == float(m2["total"])
    for k, v in state.net.state_dict().items():
        assert torch.equal(restored.net.state_dict()[k], v), k
    net = TrackingNet(cfg.model, device="cpu")
    assert load_weights(d, net) == {"mota": 0.5}

    d2 = str(tmp_path / "ckpt2")
    for s in range(4):
        state.step = s
        save_checkpoint(d2, state, s, keep=2)
    assert latest_step(d2) == 3
    assert sorted(os.listdir(d2)) == ["2", "3"]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), fresh())
    with pytest.raises(FileNotFoundError):
        load_weights(str(tmp_path / "nope"), net)
