"""The port's slice end to end: ``track_sequence_from_frames``
(compact-first extraction, batched affinity, batched auction, ID
propagation) against the JAX package on a synthetic sequence with shared
float32 weights.  Track ids must be equal exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.data.synthetic import IMG_H, IMG_W, make_synthetic_sequence
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.tracker.sequence import (extract_frames, pair_inputs,
                                              propagate_ids,
                                              track_sequence_from_frames)
from mmmot_tpu_torch.tracker.tracker import TrackingModule, init_state

from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax)

T, N, P, H, W, M = 6, 8, 16, 96, 320, 512
CROP_WINDOW = 128


def raw_sequence(seed):
    """A synthetic sequence drawn into frames: each object keeps its own
    colour (plus pixel noise) inside its box, and the clouds are uniform
    in front of the camera."""
    r = np.random.default_rng(seed)
    world = make_synthetic_sequence(r, num_frames=T, num_slots=N,
                                    num_objects=6, fp_prob=0.2)
    sx, sy = W / IMG_W, H / IMG_H
    boxes = (world.boxes2d * np.asarray([sx, sy, sx, sy])).astype(np.float32)
    images = r.integers(0, 60, (T, H, W, 3))
    colours = r.integers(60, 256, (16, 3))
    for t in range(T):
        for s in np.flatnonzero(world.det_mask[t]):
            l, tp, rt, b = np.clip(boxes[t, s], 0, [W, H, W, H]).astype(int)
            images[t, tp:b, l:rt] = colours[world.gt_ids[t, s] % 16]
    images = np.clip(images + r.integers(-8, 9, images.shape), 0,
                     255).astype(np.uint8)
    clouds = np.stack([r.uniform(-12, 12, (T, M)), r.uniform(-2, 2, (T, M)),
                       r.uniform(2, 30, (T, M)), r.uniform(0, 1, (T, M))],
                      -1).astype(np.float32)
    proj = np.asarray([[100.0, 0, W / 2, 0], [0, 100.0, H / 2, 0],
                       [0, 0, 1, 0]], np.float32)
    return images, clouds, boxes, world.det_mask, proj


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_cfg_jax().model
    jnet, variables = init_flax(jcfg, seed=3)
    # Birth/death logits pushed down so that links win the LP and the ID
    # propagation is exercised (at init every detection would start a
    # track).
    params = jax.tree.map(lambda x: x, variables["params"])
    for head in ("new_mlp", "end_mlp"):
        params["new_end"][head]["dense_1"]["bias"] = jnp.full((1,), -3.0)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    return jnet, variables, port_net(variables, tiny_debug().model)


@pytest.mark.parametrize("capacity,chunk,pallas", [(40, 16, True),
                                                   (12, 8, False)])
def test_raw_frames_ids_equal_reference(models, capacity, chunk, pallas):
    """The reference runs its fused Pallas kernel (interpret mode) or its
    XLA modules; the port runs the kernel's plain version."""
    jnet, variables, net = models
    images, clouds, boxes, det_mask, proj = raw_sequence(11)
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction"),
                           use_pallas_affinity=pallas,
                           pallas_interpret=pallas)
    ref = jax.jit(lambda im, cl, bx, dm: j_track(
        jmod, im, cl, bx, dm, proj, (32, 32), P, compact_capacity=capacity,
        extract_chunk=chunk, crop_window=CROP_WINDOW))(
        *map(jnp.asarray, (images, clouds, boxes, det_mask)))
    out = track_sequence_from_frames(
        TrackingModule(net), images, clouds, boxes, det_mask,
        proj, (32, 32), P, compact_capacity=capacity, extract_chunk=chunk,
        crop_window=CROP_WINDOW)
    ids = out["ids"].numpy()
    np.testing.assert_array_equal(ids, np.asarray(ref["ids"]))
    assert int(out["n_dropped"]) == int(ref["n_dropped"])
    assert_close(out["det_score"], ref["det_score"])
    if capacity >= det_mask.sum():
        assert int(out["n_dropped"]) == 0
        assert ((ids >= 0) == det_mask).all()
        # Some tracks continue across frames.
        assert len(np.unique(ids[ids >= 0])) < det_mask.sum()


def test_fused_affinity_equals_module_path(models):
    """On the tracker's own features, the fused affinity (its plain
    version on the CPU) equals the unfused module path."""
    _, _, net = models
    images, clouds, boxes, det_mask, proj = (
        torch.as_tensor(x) for x in raw_sequence(12))
    mod = TrackingModule(net)
    feats, kept = extract_frames(mod, images, clouds, boxes, det_mask, proj,
                                 (32, 32), P, crop_window=CROP_WINDOW)
    state0 = init_state({k: v.shape[-1] for k, v in feats.items()}, N,
                        torch.float32, "cpu")
    prev, mask_prev = pair_inputs(feats, kept, state0)
    fused = mod.affinity(prev, feats, mask_prev, kept)
    with torch.inference_mode():
        plain = net.affinity(prev, feats, mask_prev, kept)
    for k in ("link", "link_norm", "new", "end"):
        assert_close(getattr(fused, k), getattr(plain, k), err_msg=k)


def test_propagate_ids():
    """Linked detections inherit, new ones take fresh ids in slot order,
    empty slots are -1 (the reference's elementwise ID scan)."""
    state0 = init_state({"fused": 2}, 4, torch.float32, "cpu")
    match = torch.tensor([[-1, -1, -1, -1], [2, -1, 0, -1], [-1, 0, -1, 2]],
                         dtype=torch.int32)
    new = torch.tensor([[1, 1, 1, 0], [0, 1, 0, 1], [1, 0, 0, 0]]).bool()
    dm = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 1]]).bool()
    ids = propagate_ids(match, new, dm, state0)
    assert ids.tolist() == [[0, 1, 2, -1], [2, 3, 0, 4], [5, 2, -1, 0]]
