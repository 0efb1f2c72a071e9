"""Port parity of deployment (``mmmot_tpu_torch/deploy.py`` against
``mmmot_tpu/deploy.py``): the per-frame serving step, the multi-stream
step (padded and compact), compact overflow, window artifacts, the
artifact format both ways and the weight bridge's inverse.

Shared float32 ``tiny_debug`` weights cross ``compat.from_jax``; inputs
are numpy from a seed (the scenes of ``tests/test_deploy.py``).  Ids
must be equal; det scores are det-head outputs, float32 sums in other
orders, and are held within the fixtures' tolerance.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.deploy import _build_multistream_step as j_multistream
from mmmot_tpu.deploy import _build_step as j_build_step
from mmmot_tpu.deploy import _fresh_state as j_fresh_state
from mmmot_tpu.deploy import _state_to_dict as j_state_to_dict
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu_torch.compat.from_jax import (load_flax_variables,
                                             to_flax_variables)
from mmmot_tpu_torch.config import AssocConfig, tiny_debug
from mmmot_tpu_torch.deploy import (WINDOW_CHUNK, WINDOW_CROP,
                                    DeployedTracker, _build_multistream_step,
                                    _build_step, _fill_from_npz,
                                    _flatten_to_npz, _fresh_state,
                                    _skeleton, _stacked_state,
                                    _state_from_dict, _state_to_dict,
                                    export_multistream_step,
                                    export_serve_step, export_window_step,
                                    load_multistream_step, load_window_step)
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_lookalike import lookalike  # noqa: F401
from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax, to_numpy,
                                       torch_one_thread)  # noqa: F401

H, W, M = 64, 96, 300
N, P, CROP = 8, 16, (32, 32)
NOISY = dict(use_det_scores=True, raw_new_end=True, revival_window=4,
             iou_gate=0.1, iou_weight=1.0, ghost_coverage=True,
             coverage_max_miss=1)
ASSOC = {"flagship": {}, "noisy": NOISY}
PROJ = np.array([[50.0, 0, W / 2, 0], [0, 50.0, H / 2, 0], [0, 0, 1, 0]],
                np.float32)


def scene(seed, n_frames=4, n_dets=3, miss=0.0):
    """Detections drifting right by 2 px a frame (tests/test_deploy.py's
    ``_scene``); with ``miss``, each detection is missing from a frame
    with that probability (a later frame brings it back)."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n_frames):
        img = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
        cloud = np.zeros((M, 4), np.float32)
        cloud[:, 0] = rng.uniform(-8, 8, M)
        cloud[:, 1] = rng.uniform(-2, 2, M)
        cloud[:, 2] = rng.uniform(2, 30, M)
        keep = rng.random(n_dets) >= miss
        boxes = np.stack([
            np.array([4 + 2 * t + 20 * i, 8 + 6 * i,
                      20 + 2 * t + 20 * i, 28 + 6 * i], np.float32)
            for i in range(n_dets) if keep[i]] or [np.zeros(4, np.float32)])
        frames.append({"image": img, "cloud": cloud,
                       "boxes": boxes[:int(keep.sum())], "proj": PROJ})
    return frames


def padded(fr):
    n = len(fr["boxes"])
    boxes = np.zeros((N, 4), np.float32)
    boxes[:n] = fr["boxes"]
    mask = np.zeros((N,), bool)
    mask[:n] = True
    return boxes, mask, n


@pytest.fixture(scope="module")
def models():
    """Tiny float32 weights with the new/end logits lowered and the
    det-head logits raised (links, births, LP rejections and ghosts all
    occur), as flax variables and as the port's net."""
    jnet, variables = init_flax(tiny_cfg_jax().model, seed=3)
    params = jax.tree.map(lambda x: x, variables["params"])
    for head in ("new_mlp", "end_mlp"):
        params["new_end"][head]["dense_1"]["bias"] = jnp.full((1,), -1.0)
    params["det_head"]["dense_1"]["bias"] = jnp.full((1,), 1.0)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    return jnet, variables, port_net(variables, tiny_debug().model)


def reference_steps(jnet, variables, kw, frames):
    """(ids, det_score) per frame of the JAX package's per-frame step."""
    jassoc = JAssocConfig(solver="auction", **kw)
    jmod = JTrackingModule(jnet, variables, jassoc)
    step = jax.jit(j_build_step(jnet, jassoc, CROP, P))
    st = j_state_to_dict(j_fresh_state(jmod, N))
    ids, scores = [], []
    for fr in frames:
        boxes, mask, n = padded(fr)
        st, i, s = step(variables, st, fr["image"], fr["cloud"], boxes, mask,
                        fr["proj"])
        ids.append(np.asarray(i)[:n].tolist())
        scores.append(np.asarray(s)[:n])
    return ids, scores


def port_steps(module, frames):
    step = _build_step(module, CROP, P)
    st = _state_to_dict(_fresh_state(module, N))
    ids, scores = [], []
    for fr in frames:
        boxes, mask, n = padded(fr)
        st, i, s = step(st, fr["image"], fr["cloud"], boxes, mask,
                        fr["proj"])
        ids.append(i[:n].tolist())
        scores.append(s[:n].numpy())
    return ids, scores


@pytest.mark.parametrize("assoc", sorted(ASSOC))
def test_serve_step_matches_reference(models, assoc):
    """The per-frame step: ids exactly, det scores within tolerance, over
    a scene whose detections go missing and come back (ghosts, revivals
    and LP rejections with the noisy association)."""
    jnet, variables, net = models
    frames = scene(11, n_frames=8, n_dets=5, miss=0.3)
    want_ids, want_scores = reference_steps(jnet, variables, ASSOC[assoc],
                                            frames)
    got_ids, got_scores = port_steps(
        TrackingModule(net, AssocConfig(**ASSOC[assoc])), frames)
    assert got_ids == want_ids
    for g, w in zip(got_scores, want_scores):
        assert_close(g, w)


def test_serve_step_ids_equal_window_pipeline(models):
    """In float32 on the CPU the per-frame step's ids equal the window
    pipeline's over the same frames."""
    _, _, net = models
    module = TrackingModule(net)
    frames = scene(5, n_frames=6, n_dets=3)
    ids, _ = port_steps(module, frames)
    images, clouds, boxes, mask = stack_window(frames)
    out = track_sequence_from_frames(
        module, images, clouds, boxes, mask, PROJ, CROP, P,
        compact_capacity=len(frames) * N, extract_chunk=WINDOW_CHUNK,
        crop_window=WINDOW_CROP)
    assert ids == [out["ids"][t, :3].tolist() for t in range(len(frames))]


def stack_window(frames):
    boxes = np.zeros((len(frames), N, 4), np.float32)
    mask = np.zeros((len(frames), N), bool)
    for t, f in enumerate(frames):
        boxes[t], mask[t], _ = padded(f)
    return (np.stack([f["image"] for f in frames]),
            np.stack([f["cloud"] for f in frames]), boxes, mask)


# Flushes of the multi-stream schedule: all streams, then {0, 2}, then
# stream 1 alone, ... (tests/test_deploy.py's).
SCHEDULE = ([0, 1, 2], [0, 2], [1], [0, 2], [1])
S = 3


def stream_scenes(n_frames=3):
    return [scene(100 + s, n_frames=n_frames, n_dets=1 + s)
            for s in range(S)]


def flush_inputs(scenes, frame_of, slots):
    ins = {"images": np.zeros((S, H, W, 3), np.uint8),
           "clouds": np.zeros((S, M, 4), np.float32),
           "boxes": np.zeros((S, N, 4), np.float32),
           "det_mask": np.zeros((S, N), bool),
           "projs": np.zeros((S, 3, 4), np.float32)}
    active = np.zeros((S,), bool)
    for s in slots:
        fr = scenes[s][frame_of[s]]
        ins["images"][s], ins["clouds"][s] = fr["image"], fr["cloud"]
        ins["boxes"][s], ins["det_mask"][s], _ = padded(fr)
        ins["projs"][s] = fr["proj"]
        active[s] = True
    return active, ins


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def lane(tree, s):
    if isinstance(tree, dict):
        return {k: lane(v, s) for k, v in tree.items()}
    return tree[s]


@pytest.mark.parametrize("assoc", sorted(ASSOC))
@pytest.mark.parametrize("compact", [None, 8])
def test_multistream_step_matches_reference(models, compact, assoc):
    """The multi-stream step under tests/test_deploy.py's flush schedule:
    ids equal the JAX multi-stream step's and the port's own per-stream
    steps; inactive lanes keep their state bit for bit and answer -1."""
    jnet, variables, net = models
    jassoc = JAssocConfig(solver="auction", **ASSOC[assoc])
    jmod = JTrackingModule(jnet, variables, jassoc)
    jmulti = jax.jit(j_multistream(jnet, jassoc, CROP, P,
                                   compact_capacity=compact))
    jstates = jax.tree.map(lambda x: jnp.stack([x] * S),
                           j_state_to_dict(j_fresh_state(jmod, N)))
    module = TrackingModule(net, AssocConfig(**ASSOC[assoc]))
    multi = _build_multistream_step(module, CROP, P, compact)
    states = _stacked_state(module, N, S)
    scenes = stream_scenes()
    frame_of = [0] * S
    got = [[] for _ in range(S)]
    for slots in SCHEDULE:
        active, ins = flush_inputs(scenes, frame_of, slots)
        before = states
        states, ids, scores = multi(states, active, *ins.values())
        jstates, jids, jscores = jmulti(variables, jstates, active,
                                        *ins.values())
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert_close(scores, np.asarray(jscores))
        for s in range(S):
            if s in slots:
                n = len(scenes[s][frame_of[s]]["boxes"])
                got[s].append(ids[s, :n].tolist())
                frame_of[s] += 1
            else:
                assert (ids[s] == -1).all() and (scores[s] == 0).all()
                assert tree_equal(lane(states, s), lane(before, s))
    per_stream = [port_steps(module, scenes[s])[0] for s in range(S)]
    assert got == per_stream


def test_multistream_compact_overflow_drops_valid_first(models):
    """Capacity 4 under 1 + 2 + 3 valid detections: stream 2's last two
    are dropped (ids -1, as the reference pins), the others tracked as
    the uncompacted per-stream step, and the ids equal the JAX
    step's."""
    jnet, variables, net = models
    jassoc = JAssocConfig(solver="auction")
    jmod = JTrackingModule(jnet, variables, jassoc)
    module = TrackingModule(net)
    scenes = stream_scenes(n_frames=1)
    active, ins = flush_inputs(scenes, [0] * S, range(S))
    _, ids, _ = _build_multistream_step(module, CROP, P, 4)(
        _stacked_state(module, N, S), active, *ins.values())
    jstates = jax.tree.map(lambda x: jnp.stack([x] * S),
                           j_state_to_dict(j_fresh_state(jmod, N)))
    _, jids, _ = jax.jit(j_multistream(jnet, jassoc, CROP, P,
                                       compact_capacity=4))(
        variables, jstates, active, *ins.values())
    ids = ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(jids))
    assert (ids[2, 1:] == -1).all()
    assert (ids[0, :1] >= 0).all() and (ids[1, :2] >= 0).all()
    assert ids[2, 0] >= 0
    for s in (0, 1):
        n = 1 + s
        assert ids[s, :n].tolist() == port_steps(module, scenes[s])[0][0]


@pytest.fixture(scope="module")
def port_artifact(models, tmp_path_factory):
    """The port's serve_step artifact of the shared weights."""
    _, _, net = models
    cfg = tiny_debug()
    out = str(tmp_path_factory.mktemp("port_artifact"))
    export_serve_step(out, cfg, TrackingModule(net), (H, W), M)
    return out


def test_port_artifact_layout_and_serving(models, port_artifact):
    """Three files, the manifest names the port's program and platform,
    and ``DeployedTracker`` tracks as the live step does."""
    _, _, net = models
    assert sorted(os.listdir(port_artifact)) == [
        "manifest.json", "state0.npz", "weights.npz"]
    man = json.load(open(os.path.join(port_artifact, "manifest.json")))
    assert man["kind"] == "serve_step" and man["platforms"] == ["cuda"]
    assert man["program"] == "mmmot_tpu_torch.deploy:_build_step"
    assert man["config"] == "tiny_debug" and man["image_hw"] == [H, W]
    frames = scene(21, n_frames=4)
    trk = DeployedTracker.load(port_artifact, device="cpu")
    got = [trk.step(f["image"], f["cloud"], f["boxes"], f["proj"])[0]
           for f in frames]
    assert got == port_steps(TrackingModule(net), frames)[0]
    trk.reset()
    assert trk.frame_idx == 0
    again = trk.step(frames[0]["image"], frames[0]["cloud"][:M // 2],
                     frames[0]["boxes"], frames[0]["proj"])[0]
    assert len(again) == 3
    with pytest.raises(ValueError):
        trk.step(frames[0]["image"], frames[0]["cloud"],
                 np.zeros((N + 1, 4), np.float32), frames[0]["proj"])


def test_int8_artifact_is_refused(port_artifact, tmp_path):
    """An artifact with an int8 trunk (the JAX package's ``--int8``)
    raises instead of serving the float model."""
    import shutil

    out = str(tmp_path / "int8")
    shutil.copytree(port_artifact, out)
    path = os.path.join(out, "manifest.json")
    man = json.load(open(path))
    json.dump(dict(man, int8=True), open(path, "w"))
    with pytest.raises(NotImplementedError, match="item 12"):
        DeployedTracker.load(out, device="cpu")


def test_state0_of_another_dtype_is_refused(port_artifact, tmp_path):
    """An artifact whose zero state has the preset's fields and shapes but
    another compute dtype (a config edited under the preset's name) is
    refused, not served with the preset's settings."""
    import shutil

    out = str(tmp_path / "bf16_state")
    shutil.copytree(port_artifact, out)
    path = os.path.join(out, "manifest.json")
    man = json.load(open(path))
    with np.load(os.path.join(out, "state0.npz")) as z:
        state = _fill_from_npz(man["state0_structure"], z)
    state["feats"] = {k: v if k == "box" else torch.as_tensor(v).bfloat16()
                      for k, v in state["feats"].items()}
    np.savez(os.path.join(out, "state0.npz"), **_flatten_to_npz(state))
    json.dump(dict(man, state0_structure=_skeleton(state)), open(path, "w"))
    with pytest.raises(ValueError, match="bfloat16"):
        DeployedTracker.load(out, device="cpu")


@pytest.mark.parametrize("compact", [None, 4])
def test_multistream_artifact_matches_live_step(models, tmp_path, compact):
    """A multi-stream artifact, loaded, answers the live multi-stream step's
    ids and states under the flush schedule, with its own weights and with
    other weights handed to the call; ``DeployedTracker`` refuses it."""
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

    _, _, net = models
    cfg = tiny_debug()
    out = str(tmp_path / "multistream_artifact")
    export_multistream_step(out, cfg, TrackingModule(net), (H, W), M, S,
                            compact)
    prog = load_multistream_step(out, device="cpu")
    assert prog.manifest["streams"] == S
    assert prog.manifest["compact_capacity"] == compact
    other = init_random_(TrackingNet(cfg.model, device="cpu"), 5)
    scenes = stream_scenes()
    for live_net, weights in ((net, prog.weights),
                              (other, to_flax_variables(other))):
        live_mod = TrackingModule(live_net)
        live = _build_multistream_step(live_mod, CROP, P, compact)
        states, st = _stacked_state(live_mod, N, S), prog.state0
        frame_of = [0] * S
        for slots in SCHEDULE:
            active, ins = flush_inputs(scenes, frame_of, slots)
            states, want, _ = live(states, active, *ins.values())
            st, got, _ = prog(weights, st, active, *ins.values())
            assert torch.equal(got, want)
            assert tree_equal(st, states)
            for s in slots:
                frame_of[s] += 1
    with pytest.raises(ValueError, match="multistream_step"):
        DeployedTracker.load(out, device="cpu")


def test_port_weights_read_by_reference_reader(models, port_artifact):
    """A port-written weights.npz, read with the reference's
    ``_fill_from_npz`` and the port's manifest skeleton, equals the flax
    variables leaf for leaf."""
    from mmmot_tpu.deploy import _fill_from_npz as j_fill

    _, variables, _ = models
    man = json.load(open(os.path.join(port_artifact, "manifest.json")))
    with np.load(os.path.join(port_artifact, "weights.npz")) as z:
        got = j_fill(man["weights_structure"], z)
    want = to_numpy(variables)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype
        np.testing.assert_array_equal(flat_got[k], v, err_msg=str(k))


def test_jax_artifact_served_by_port(models, tmp_path):
    """A serve_step artifact that the JAX package exported (CPU platform)
    tracks, through the port's ``DeployedTracker``, to the JAX
    ``DeployedTracker``'s ids frame by frame."""
    from mmmot_tpu.deploy import DeployedTracker as JDeployedTracker
    from mmmot_tpu.deploy import export_serve_step as j_export
    from mmmot_tpu.deploy import save_artifact as j_save

    jnet, variables, _ = models
    cfg = tiny_cfg_jax()
    exported, state0 = j_export(cfg, variables, (H, W), M,
                                platforms=("cpu",))
    out = str(tmp_path / "jax_artifact")
    j_save(out, exported, variables, state0, cfg, (H, W), M)
    jtrk = JDeployedTracker.load(out)
    trk = DeployedTracker.load(out, device="cpu")
    for f in scene(31, n_frames=5, n_dets=4, miss=0.2):
        want = jtrk.step(f["image"], f["cloud"], f["boxes"], f["proj"])
        got = trk.step(f["image"], f["cloud"], f["boxes"], f["proj"])
        assert got[0] == want[0]
        assert_close(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("weights", ["artifact", "other"])
def test_window_artifact_chains_like_one_live_pass(models, tmp_path,
                                                   weights):
    """A window artifact chained over two windows equals one live pass
    over the whole sequence, with the artifact's weights or with other
    weights handed to the call; ``DeployedTracker`` refuses it."""
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

    _, _, net = models
    cfg = tiny_debug()
    Wn = 3
    out = str(tmp_path / "window_artifact")
    export_window_step(out, cfg, TrackingModule(net), (H, W), M, Wn)
    assert json.load(open(os.path.join(out, "manifest.json")))[
        "capacity"] == Wn * N
    step = load_window_step(out, device="cpu")
    if weights == "other":
        net = init_random_(TrackingNet(cfg.model, device="cpu"), 5)
        variables = to_flax_variables(net)
    else:
        variables = step.weights
    frames = scene(41, n_frames=2 * Wn)
    images, clouds, boxes, mask = stack_window(frames)
    valid = np.ones((2 * Wn, M), bool)
    live = track_sequence_from_frames(
        TrackingModule(net), images, clouds, boxes, mask, PROJ, CROP, P,
        cloud_valid=valid, compact_capacity=Wn * N,
        extract_chunk=WINDOW_CHUNK, crop_window=WINDOW_CROP)
    st, got = step.state0, []
    for w0 in (0, Wn):
        sl = slice(w0, w0 + Wn)
        st, ids, _ = step(variables, st, images[sl], clouds[sl], valid[sl],
                          boxes[sl], mask[sl], PROJ)
        got.append(ids)
    np.testing.assert_array_equal(torch.cat(got).numpy(), live["ids"].numpy())
    with pytest.raises(ValueError, match="window"):
        DeployedTracker.load(out, device="cpu")


@pytest.mark.parametrize("which", ["tiny", "lookalike"])
def test_to_flax_variables_inverts_the_bridge(models, which, request):
    """``to_flax_variables(load_flax_variables(v)) == v`` bit for bit
    (the look-alike tree adds the GNN rounds and the motion MLP)."""
    if which == "tiny":
        _, variables, net = models
    else:
        _, variables, net = request.getfixturevalue("lookalike")
    want = to_numpy(variables)
    net.load_state_dict(load_flax_variables(want, net))
    got = to_flax_variables(net)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want)
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype and flat_got[k].shape == v.shape
        np.testing.assert_array_equal(flat_got[k], v, err_msg=str(k))


def test_bfloat16_leaves_cross_the_npz(tmp_path):
    """A bfloat16 state written by the port reads back bit for bit, and
    the reference's reader (with ml_dtypes) reads the same values."""
    from mmmot_tpu.deploy import _fill_from_npz as j_fill

    net_cfg = dataclasses.replace(tiny_debug().model,
                                  compute_dtype="bfloat16")
    from mmmot_tpu_torch.models.tracking_net import TrackingNet

    module = TrackingModule(TrackingNet(net_cfg, device="cpu"),
                            AssocConfig(**NOISY))
    state = _state_to_dict(_fresh_state(module, N))
    state["feats"]["fused"] = torch.randn(state["feats"]["fused"].shape
                                          ).bfloat16()
    path = str(tmp_path / "state.npz")
    np.savez(path, **_flatten_to_npz(state))
    skel = _skeleton(state)
    assert skel["feats"]["fused"] == "bfloat16"
    assert skel["feats"]["box"] == "float32"
    with np.load(path) as z:
        back = _fill_from_npz(skel, z)
        ref = j_fill(skel, z)
    assert back["feats"]["fused"].dtype == torch.bfloat16
    assert torch.equal(back["feats"]["fused"], state["feats"]["fused"])
    np.testing.assert_array_equal(
        np.asarray(ref["feats"]["fused"], np.float32),
        state["feats"]["fused"].float().numpy())
    assert _state_from_dict(back).missed.shape == (2 * N,)
