"""Port parity of the noisy-detector quality stack: y_det rejection in
the LP, the spatial IoU gate and prior, the revival ghost pool with its
coverage rows and ``gate_predict``.

The same seeded numpy inputs and the same float32 tiny weights (crossing
``compat.from_jax``) go through the JAX package and the port.  Integer
outputs (ids, coverage ids) and the coverage boxes must be equal
exactly; scores (``det_score``, ``ghost_scores``) are det-head outputs,
float32 sums in other orders, and are held within the fixtures'
tolerance.  Each pre-solve must also equal the port's own sequential
``step_from_feats`` scan, and a window chain with carried state must
equal one long window.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.models import model_entry
from mmmot_tpu.ops.boxes import pairwise_iou as j_pairwise_iou
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
from mmmot_tpu.tracker.sequence import _scan_track as j_scan_track
from mmmot_tpu.tracker.tracker import apply_spatial_gate as j_spatial_gate
from mmmot_tpu_torch.config import AssocConfig, tiny_debug
from mmmot_tpu_torch.ops.boxes import pairwise_iou
from mmmot_tpu_torch.tracker.sequence import (_scan_track,
                                              track_sequence_from_frames)
from mmmot_tpu_torch.tracker.tracker import (TrackingModule,
                                             apply_spatial_gate)

from tests.test_torch_tracking import CROP_WINDOW, P, raw_sequence
from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax, torch_one_thread)  # noqa: F401

# The association sections under test.  "ydet" is full_mmmot_ydet's and
# "noisy" full_mmmot_noisy's; the others vary the window, gate_predict
# and the coverage knobs.
NOISY = dict(use_det_scores=True, raw_new_end=True, revival_window=4,
             iou_gate=0.1, iou_weight=1.0, ghost_coverage=True,
             coverage_max_miss=1)
ASSOC = {
    "ydet": dict(use_det_scores=True, raw_new_end=True),
    "noisy": NOISY,
    "noisy_k2_predict": dict(NOISY, revival_window=2, gate_predict=True),
    "noisy_k4_predict_min_score": dict(NOISY, gate_predict=True,
                                       coverage_max_miss=0,
                                       coverage_min_score=0.75),
    "revival_sigmoid": dict(revival_window=2),
}


@pytest.fixture(scope="module")
def quality_models():
    """Tiny weights with the new/end logits lowered and the det-head
    logits raised, so that links, births, LP rejections and ghosts all
    occur (at init every detection would start a track)."""
    jnet, variables = init_flax(tiny_cfg_jax().model, seed=3)
    params = jax.tree.map(lambda x: x, variables["params"])
    for head in ("new_mlp", "end_mlp"):
        params["new_end"][head]["dense_1"]["bias"] = jnp.full((1,), -1.0)
    params["det_head"]["dense_1"]["bias"] = jnp.full((1,), 1.0)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    return jnet, variables, port_net(variables, tiny_debug().model)


def window_feats(seed, S=2, T=12, N=6, D=64):
    """Per-track embeddings (a signature per slot plus noise, so a
    detection that comes back matches its ghost), drifting boxes, and
    valid masks with i.i.d. misses and dropout bursts of 1-3 frames."""
    r = np.random.default_rng(seed)
    feats = {}
    for k in ("fused", "image", "lidar"):
        sig = r.normal(0, 1, (S, 1, N, D))
        feats[k] = (sig + r.normal(0, 0.3, (S, T, N, D))).astype(np.float32)
    dm = r.random((S, T, N)) < 0.75
    for s in range(S):
        for i in range(N):
            if r.random() < 0.5:
                t0 = r.integers(1, T - 2)
                dm[s, t0:t0 + r.integers(1, 4), i] = False
    xy = (r.uniform(0, 300, (S, 1, N, 2))
          + np.arange(T)[None, :, None, None] * r.normal(0, 4, (S, 1, N, 2)))
    wh = r.uniform(20, 60, (S, 1, N, 2))
    feats["box"] = (np.concatenate([xy, xy + wh], -1)
                    + r.normal(0, 1.5, (S, T, N, 4))).astype(np.float32)
    return feats, dm


def reference_scan(jnet, variables, kw, feats, dm, hybrid=None):
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction",
                                                         **kw),
                           use_pallas_affinity=False,
                           hybrid_presolve=hybrid)
    out = jax.jit(jax.vmap(lambda f, d: j_scan_track(jmod, f, d)[0]))(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(dm))
    return {k: np.asarray(v) for k, v in out.items()}


def port_scan(net, kw, feats, dm, hybrid=None, state0=None):
    mod = TrackingModule(net, AssocConfig(**kw), hybrid_presolve=hybrid)
    out, final = _scan_track(mod, {k: torch.from_numpy(v)
                                   for k, v in feats.items()},
                             torch.from_numpy(dm), state0)
    return {k: v.numpy() for k, v in out.items()}, final


def check_outputs(got, want, what):
    """Ids and coverage ids and boxes exactly; scores within tolerance."""
    assert set(got) == set(want), what
    for k in want:
        if k in ("det_score", "ghost_scores"):
            assert_close(got[k], want[k], err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{what}: {k}")


def revived(ids):
    """Count of ids [S, T, N] that are absent from a frame after being
    present, then present again."""
    n = 0
    for seq in ids:
        seen = [set(row[row >= 0].tolist()) for row in seq]
        for t in range(1, len(seen) - 1):
            gone = (seen[t - 1] - seen[t])
            n += len(gone & set().union(*seen[t + 1:]))
    return n


@pytest.mark.parametrize("name", sorted(ASSOC))
def test_strategies_equal_reference(quality_models, name):
    """The port's pre-solve (``_hybrid_track`` or ``_revival_track``) and
    its sequential scan against the reference's auto strategy, and
    against each other, on two sequences of 12 frames."""
    jnet, variables, net = quality_models
    kw = ASSOC[name]
    feats, dm = window_feats(1)
    ref = reference_scan(jnet, variables, kw, feats, dm)
    hybrid, _ = port_scan(net, kw, feats, dm)
    sequential, _ = port_scan(net, kw, feats, dm, hybrid=False)
    check_outputs(hybrid, ref, f"{name} pre-solve vs reference")
    check_outputs(sequential, ref, f"{name} sequential vs reference")
    check_outputs(hybrid, sequential, f"{name} pre-solve vs sequential")
    ids = ref["ids"]
    # Every mechanism the config turns on acts on these inputs.
    if kw.get("use_det_scores"):
        assert ((ids < 0) & dm).sum() > 0, "no LP rejection"
    if kw.get("revival_window"):
        assert revived(ids) > 0, "no revived id"
    if kw.get("ghost_coverage"):
        assert (ref["ghost_ids"] >= 0).sum() > 0, "no coverage row"
    assert len(np.unique(ids[ids >= 0])) < (ids >= 0).sum(), "no links"


@pytest.mark.parametrize("name,hybrid", [("noisy", None), ("noisy", False),
                                         ("ydet", None),
                                         ("noisy_k2_predict", None)])
def test_windows_with_carried_state_equal_one_window(quality_models, name,
                                                     hybrid):
    """Two windows (5 + 7 frames) with the state carried, ghosts and
    velocities included, give the outputs of one 12-frame window."""
    _, _, net = quality_models
    kw = ASSOC[name]
    feats, dm = window_feats(2)
    whole, _ = port_scan(net, kw, feats, dm, hybrid)
    first, state = port_scan(net, kw, {k: v[:, :5] for k, v in feats.items()},
                             dm[:, :5], hybrid)
    second, _ = port_scan(net, kw, {k: v[:, 5:] for k, v in feats.items()},
                          dm[:, 5:], hybrid, state0=state)
    for k in whole:
        got = np.concatenate([first[k], second[k]], 1)
        if k in ("det_score", "ghost_scores"):
            assert_close(got, whole[k], err_msg=k)
        else:
            np.testing.assert_array_equal(got, whole[k], err_msg=k)


def test_pairwise_iou_equals_reference():
    r = np.random.default_rng(0)
    lt = r.uniform(0, 400, (3, 40, 2))
    a = np.concatenate([lt, lt + r.uniform(1, 200, (3, 40, 2))], -1)
    b = a + r.normal(0, 25, a.shape)
    a[:, :4] = 0.0                             # empty slots: zero boxes
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = np.asarray(jax.jit(j_pairwise_iou)(a, b))
    got = pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).mean() > 0.05 and (want[:, :4] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight,gate", [(1.0, 0.1), (0.5, 0.0),
                                         (0.0, 0.05), (0.7, 0.0),
                                         (0.37, 0.2)])
def test_spatial_gate_equals_reference(dtype, weight, gate):
    """Exactly equal, except in float32 for weights whose product with
    the IoU rounds (0.7, 0.37): XLA rounds the reference's multiply-add
    once or twice depending on its fusion (twice at (0.7, 0), once at
    (0.37, 0.2)), so there the port is held within one float32 rounding
    of the result.  The repo's configs use 1.0 (and its tests 0.5)."""
    r = np.random.default_rng(1)
    lt = r.uniform(0, 300, (2, 16, 2))
    box_p = np.concatenate([lt, lt + r.uniform(10, 120, (2, 16, 2))],
                           -1).astype(np.float32)
    box_c = (box_p + r.normal(0, 15, box_p.shape)).astype(np.float32)
    link = r.uniform(0, 1, (2, 16, 16)).astype(np.float32)
    jcfg = JAssocConfig(iou_weight=weight, iou_gate=gate)
    want = jax.jit(lambda l, p, c: j_spatial_gate(l, p, c, jcfg))(
        jnp.asarray(link, dtype), box_p, box_c)
    got = apply_spatial_gate(
        torch.from_numpy(link).to(getattr(torch, dtype)),
        torch.from_numpy(box_p), torch.from_numpy(box_c),
        AssocConfig(iou_weight=weight, iou_gate=gate))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32" and weight not in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -23,
                                   atol=2.0 ** -24)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)
    if gate:
        assert (want < -9e4).any() and (want > -9e4).any()


@pytest.mark.parametrize("kw", [
    dict(coverage_max_miss=-1),
    dict(revival_window=2, ghost_coverage=True, coverage_max_miss=3),
    dict(gate_predict=True, iou_gate=0.1),
    dict(revival_window=2, ghost_coverage=True, gate_predict=True)])
def test_assoc_config_rejects_what_reference_rejects(kw):
    with pytest.raises(ValueError):
        JAssocConfig(**kw)
    with pytest.raises(ValueError):
        AssocConfig(**kw)


def test_assoc_config_unported_parts_raise(quality_models):
    """Solvers other than the auction and the class gate are not ported:
    they raise rather than run something else."""
    _, _, net = quality_models
    for solver in ("sinkhorn", "greedy", "ilp"):
        with pytest.raises(NotImplementedError, match="Queue 1"):
            AssocConfig(solver=solver)
    with pytest.raises(NotImplementedError, match="class_gate"):
        TrackingModule(net, AssocConfig(class_gate=True))
    with pytest.raises(ValueError, match="unsound"):
        TrackingModule(net, AssocConfig(**NOISY), parallel_assoc=True)
    with pytest.raises(ValueError, match="needs revival_window"):
        TrackingModule(net, AssocConfig(ghost_coverage=True))


def test_noisy_init_state_layout(quality_models):
    """With revival the registry has 2N slots and the missed counters,
    and carries boxes, velocities, det logits and coverage scores."""
    _, _, net = quality_models
    st = TrackingModule(net, AssocConfig(**NOISY)).init_state(6)
    assert st.mask.shape == (12,) and st.missed.shape == (12,)
    assert {k: v.shape[-1] for k, v in st.feats.items()} == {
        "fused": 64, "image": 64, "lidar": 64, "box": 4, "boxvel": 4,
        "detlogit": 1, "detsc": 1}
    assert st.feats["box"].dtype == torch.float32
    flag = TrackingModule(net).init_state(6)
    assert flag.missed is None and set(flag.feats) == {"fused", "image",
                                                       "lidar"}


@pytest.mark.parametrize("name", ["noisy", "ydet"])
def test_raw_frames_equal_reference(quality_models, name):
    """From raw frames (the boxes ride the features): float32 ids and
    coverage equal the reference's XLA path."""
    jnet, variables, net = quality_models
    kw = ASSOC[name]
    images, clouds, boxes, det_mask, proj = raw_sequence(11)
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction",
                                                         **kw))
    kwargs = dict(compact_capacity=40, extract_chunk=16,
                  crop_window=CROP_WINDOW)
    ref = jax.jit(lambda im, cl, bx, dm: j_track(
        jmod, im, cl, bx, dm, proj, (32, 32), P, **kwargs))(
        *map(jnp.asarray, (images, clouds, boxes, det_mask)))
    out = track_sequence_from_frames(
        TrackingModule(net, AssocConfig(**kw)), images, clouds, boxes,
        det_mask, proj, (32, 32), P, **kwargs)
    check_outputs({k: v.numpy() for k, v in out.items()},
                  {k: np.asarray(v) for k, v in ref.items()}, name)


@pytest.fixture(scope="module")
def bf16_noisy(quality_models):
    """The quality weights in bfloat16: the reference on its fused Pallas
    kernel (interpret mode), the port on its kernel's plain version."""
    _, variables, _ = quality_models
    jcfg = dataclasses.replace(tiny_cfg_jax().model, compute_dtype="bfloat16")
    jmod = JTrackingModule(model_entry(jcfg), variables,
                           JAssocConfig(solver="auction", **NOISY),
                           use_pallas_affinity=True, pallas_interpret=True)
    net = port_net(variables, dataclasses.replace(tiny_debug().model,
                                                  compute_dtype="bfloat16"))
    run = jax.jit(lambda im, cl, bx, dm, pr: j_track(
        jmod, im, cl, bx, dm, pr, (32, 32), P, compact_capacity=40,
        extract_chunk=16, crop_window=CROP_WINDOW))
    return run, TrackingModule(net, AssocConfig(**NOISY))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_bfloat16_revival_ids_equal_reference_pallas(bf16_noisy, seed):
    run, mod = bf16_noisy
    images, clouds, boxes, det_mask, proj = raw_sequence(seed)
    ref = run(*map(jnp.asarray, (images, clouds, boxes, det_mask, proj)))
    out = track_sequence_from_frames(
        mod, images, clouds, boxes, det_mask, proj, (32, 32), P,
        compact_capacity=40, extract_chunk=16, crop_window=CROP_WINDOW)
    assert out["det_score"].dtype == torch.bfloat16
    for k in ("ids", "ghost_ids", "ghost_boxes"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(out["n_dropped"]) == int(ref["n_dropped"]) == 0
