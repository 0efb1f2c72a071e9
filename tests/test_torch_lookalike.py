"""Port parity of the look-alike stack: the learned motion term (the fused
kernel's ``link_bias``), GNN refine, the class gate and the runner's
``track_class="All"``.

The same seeded numpy inputs and the same tiny weights (crossing
``compat.from_jax``) go through the JAX package and the port.  The flax
motion MLP's output layer starts at zero, which would make every motion
check vacuous, so its weights are drawn nonzero and carried across; each
test that relies on the term also checks that it moves the link.  Ids,
coverage ids and boxes must be equal exactly, float outputs within the
tolerance each test states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.config import load_config
from mmmot_tpu.models import model_entry
from mmmot_tpu.models.affinity import GNNRefine as JGNNRefine
from mmmot_tpu.ops.boxes import pair_motion_features as j_motion_features
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
import mmmot_tpu.tracker.kitti_runner as j_kitti_runner
from mmmot_tpu.tracker.kitti_runner import \
    track_kitti_sequences as j_track_kitti
from mmmot_tpu.tracker.sequence import _scan_track as j_scan_track
from mmmot_tpu.tracker.tracker import apply_class_gate as j_class_gate
from mmmot_tpu_torch.compat.from_jax import load_flax_variables
from mmmot_tpu_torch.config import (AffinityConfig, AssocConfig,
                                    full_mmmot_lookalike, tiny_debug)
from mmmot_tpu_torch.models.tracking_net import TrackingNet
from mmmot_tpu_torch.ops.boxes import pair_motion_features
from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences
from mmmot_tpu_torch.tracker.sequence import (_scan_track,
                                              track_sequence_from_frames)
from mmmot_tpu_torch.tracker.tracker import TrackingModule, apply_class_gate

from tests.test_torch_quality import (ASSOC, NOISY, check_outputs,
                                      quality_models, reference_scan,
                                      window_feats)  # noqa: F401
from tests.test_torch_runner import MAX_DETS, files_of
from tests.test_torch_tracking import CROP_WINDOW, P, raw_sequence
from tests.torch_port_fixtures import (assert_close, build_kitti_tree,
                                       port_net, randomize_stats,
                                       tiny_cfg_jax,
                                       torch_one_thread)  # noqa: F401

# full_mmmot_lookalike's association: the noisy stack, coverage uncapped.
LOOKALIKE = dict(NOISY, coverage_max_miss=0)
TOL = dict(rtol=1e-5, atol=1e-5)


def lookalike_cfgs(gnn_rounds=2, motion_dim=8, dtype="float32"):
    """tiny_debug widths with the look-alike affinity: (JAX, port)."""
    j = tiny_cfg_jax().model
    j = dataclasses.replace(
        j, compute_dtype=dtype, affinity=dataclasses.replace(
            j.affinity, gnn_rounds=gnn_rounds, motion_dim=motion_dim))
    p = dataclasses.replace(tiny_debug().model, compute_dtype=dtype,
                            affinity=AffinityConfig(hidden_dim=32,
                                                    gnn_rounds=gnn_rounds,
                                                    motion_dim=motion_dim))
    return j, p


def strip(variables, gnn_rounds, motion):
    """``variables`` without the GNN rounds past ``gnn_rounds`` and, unless
    ``motion``, without the motion MLP (a model with fewer of them)."""
    params = {}
    for k, v in variables["params"].items():
        if k == "motion" and not motion:
            continue
        if k.startswith("affinity_"):
            v = {n: x for n, x in v.items()
                 if not n.startswith("gnn_") or int(n[4:]) < gnn_rounds}
        params[k] = v
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def lookalike():
    """Tiny look-alike weights: GNN rounds 2, a nonzero motion MLP, the
    new/end logits lowered and the det-head logits raised (as the
    quality tests' weights), so links, births, rejections and ghosts
    all occur.  Returns (JAX cfg, variables, port net)."""
    jcfg, pcfg = lookalike_cfgs()
    jnet = model_entry(jcfg)
    N = 8
    dummy = {"crops": jnp.zeros((1, 2, N, 32, 32, 3)),
             "points": jnp.zeros((1, 2, N, P, 4)),
             "point_mask": jnp.ones((1, 2, N, P), bool),
             "det_mask": jnp.ones((1, 2, N), bool),
             "boxes": jnp.zeros((1, 2, N, 4))}
    variables = randomize_stats(jax.jit(lambda r, b: jnet.init(
        {"params": r}, b, train=False))(jax.random.PRNGKey(3), dummy), 3)
    params = jax.tree.map(lambda x: x, variables["params"])
    rng = np.random.default_rng(7)
    params["motion"] = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 0.5, x.shape), jnp.float32),
        params["motion"])
    for head in ("new_mlp", "end_mlp"):
        params["new_end"][head]["dense_1"]["bias"] = jnp.full((1,), -1.0)
    params["det_head"]["dense_1"]["bias"] = jnp.full((1,), 1.0)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    return jcfg, variables, port_net(variables, pcfg)


def pair_feats(seed, B=3, N=8, D=64, empty=True):
    """Per-branch embeddings and boxes for B frame pairs, masks with
    holes; with ``empty`` pair 1 has no previous and pair 2 no current
    detection."""
    r = np.random.default_rng(seed)
    side = []
    for _ in range(2):
        f = {k: r.normal(0, 1, (B, N, D)).astype(np.float32)
             for k in ("fused", "image", "lidar")}
        lt = r.uniform(0, 300, (B, N, 2))
        f["box"] = np.concatenate([lt, lt + r.uniform(10, 80, (B, N, 2))],
                                  -1).astype(np.float32)
        side.append(f)
    side[1]["box"] = (side[0]["box"]
                      + r.normal(0, 8, side[0]["box"].shape)).astype(
        np.float32)
    mp, mc = r.random((B, N)) < 0.7, r.random((B, N)) < 0.7
    mp[0, :2] = mc[0, :2] = True
    if empty:
        mp[1], mc[2] = False, False
    return side[0], side[1], mp, mc


def to_j(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def to_t(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


def test_pair_motion_features_equal_reference():
    """Degenerate boxes included (zero, one point, huge, a jump clamped
    at 20 scales): finite and within 1e-6 (XLA's ``log`` and its fusion
    of the IoU differ by an ulp)."""
    r = np.random.default_rng(0)
    lt = r.uniform(0, 1200, (3, 40, 2))
    a = np.concatenate([lt, lt + r.uniform(1, 300, (3, 40, 2))], -1)
    b = a + r.normal(0, 30, a.shape)
    a[:, :4] = 0.0
    a[:, 4] = (5, 5, 5, 5)
    b[:, 5] = (0, 0, 1e6, 1e6)
    b[:, 6] = (1e9, 1e9, 1e9 + 10, 1e9 + 10)
    b[:, -3:] = 0.0
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = np.asarray(jax.jit(j_motion_features)(a, b))
    got = pair_motion_features(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (3, 40, 40, 6)
    got = got.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    assert (np.abs(got[..., :2]) == 20.0).any()


@pytest.mark.parametrize("rounds", [1, 2])
def test_gnn_refine_equals_reference(lookalike, rounds):
    """One round (the flax ``GNNRefine`` module alone) and the model's two
    rounds of every branch (``gnn_refine``), with a pair whose previous
    side is empty and one whose current side is: float32 within 1e-5,
    and exactly 0 at invalid slots."""
    jcfg, variables, net = lookalike
    fp, fc, mp, mc = pair_feats(1)
    if rounds == 1:
        p = variables["params"]["affinity_image"]["gnn_0"]
        want = JGNNRefine().apply({"params": p}, jnp.asarray(fp["image"]),
                                  jnp.asarray(fc["image"]), jnp.asarray(mp),
                                  jnp.asarray(mc))
        with torch.inference_mode():
            got = net.affinity_image.gnn_0(
                torch.from_numpy(fp["image"]), torch.from_numpy(fc["image"]),
                torch.from_numpy(mp), torch.from_numpy(mc))
        pairs = [(got[0], want[0], mp), (got[1], want[1], mc)]
    else:
        jnet = model_entry(jcfg)
        want = jnet.apply(variables, to_j(fp), to_j(fc), jnp.asarray(mp),
                          jnp.asarray(mc), method=jnet.gnn_refine)
        with torch.inference_mode():
            got = net.gnn_refine(to_t(fp), to_t(fc), torch.from_numpy(mp),
                                 torch.from_numpy(mc))
        pairs = [(g[k], w[k], m) for g, w, m in zip(got, want, (mp, mc))
                 for k in ("fused", "image", "lidar")]
        np.testing.assert_array_equal(got[0]["box"].numpy(), fp["box"])
    for g, w, m in pairs:
        assert torch.isfinite(g).all()
        assert_close(g, np.asarray(w), **TOL)
        assert (g.numpy()[~m] == 0).all()
    # The rounds move the embeddings.
    assert np.abs(pairs[0][0].numpy() - fp["fused" if rounds == 2
                                           else "image"]).max() > 1e-2


def test_affinity_with_gnn_and_motion_equals_reference(lookalike):
    """The port's ``TrackingModule.affinity`` (GNN rounds, the motion
    term into the kernel's plain version as ``link_bias``, new/end from
    the raw fused rows) against the reference's Pallas path (interpret
    mode) and its module path: link, norm, new and end within 1e-5.  The
    bias bites: zeroing the current boxes moves the link."""
    jcfg, variables, net = lookalike
    jnet = model_entry(jcfg)
    fp, fc, mp, mc = pair_feats(2)
    jmod = JTrackingModule(jnet, variables, JAssocConfig(),
                           use_pallas_affinity=True, pallas_interpret=True)
    pallas = jmod.affinity(to_j(fp), to_j(fc), jnp.asarray(mp),
                           jnp.asarray(mc))
    xla = jnet.apply(variables, to_j(fp), to_j(fc), jnp.asarray(mp),
                     jnp.asarray(mc), method=jnet.affinity)
    mod = TrackingModule(net)
    got = mod.affinity(to_t(fp), to_t(fc), torch.from_numpy(mp),
                       torch.from_numpy(mc))
    for k in ("link", "link_norm", "new", "end"):
        assert_close(getattr(got, k), np.asarray(getattr(pallas, k)), **TOL,
                     err_msg=f"{k} vs pallas")
        assert_close(getattr(got, k), np.asarray(getattr(xla, k)), **TOL,
                     err_msg=f"{k} vs module path")
    pm = mp[:, :, None] & mc[:, None, :]
    assert (got.link.numpy()[~pm] == 0).all()
    zero = dict(to_t(fc), box=torch.zeros(fc["box"].shape))
    moved = mod.affinity_link(to_t(fp), zero, torch.from_numpy(mp),
                              torch.from_numpy(mc))
    assert (got.link - moved).abs().max() > 1e-4


def test_lookalike_ids_equal_reference_over_two_windows(lookalike):
    """full_mmmot_lookalike's association on tiny float32 weights: the
    port's strategy is the sequential scan (GNN rounds rule out the
    pre-solves), and its ids, coverage ids and boxes over two windows
    (5 + 7 frames, state carried, ghosts included) equal the
    reference's, which runs its sequential scan too."""
    jcfg, variables, net = lookalike
    jmod = JTrackingModule(model_entry(jcfg), variables,
                           JAssocConfig(solver="auction", **LOOKALIKE),
                           use_pallas_affinity=False)
    assert not jmod.hybrid_presolve
    mod = TrackingModule(net, AssocConfig(**LOOKALIKE))
    assert not mod.hybrid_presolve and not mod.parallel_assoc
    feats, dm = window_feats(1)
    run = jax.jit(jax.vmap(lambda f, d, s: j_scan_track(jmod, f, d, s)))
    ref_state, state, ref_all, got_all = None, None, [], []
    for lo, hi in ((0, 5), (5, 12)):
        f = {k: v[:, lo:hi] for k, v in feats.items()}
        if ref_state is None:
            ref, ref_state = jax.jit(jax.vmap(
                lambda f, d: j_scan_track(jmod, f, d)))(
                to_j(f), jnp.asarray(dm[:, lo:hi]))
        else:
            ref, ref_state = run(to_j(f), jnp.asarray(dm[:, lo:hi]),
                                 ref_state)
        out, state = _scan_track(mod, to_t(f), torch.from_numpy(dm[:, lo:hi]),
                                 state)
        ref_all.append({k: np.asarray(v) for k, v in ref.items()})
        got_all.append({k: v.numpy() for k, v in out.items()})
    for r, g in zip(ref_all, got_all):
        check_outputs(g, r, "lookalike window")
    ids = np.concatenate([r["ids"] for r in ref_all], 1)
    assert ((ids < 0) & dm).sum() > 0, "no LP rejection"
    assert (np.concatenate([r["ghost_ids"] for r in ref_all], 1)
            >= 0).sum() > 0, "no coverage row"
    first = got_all[1]["ids"][:, 0]
    assert ((first >= 0) & (first <= got_all[0]["ids"].max())).any(), \
        "no id carried across the window boundary"


@pytest.mark.parametrize("name", ["flagship", "ydet", "revival_sigmoid",
                                  "noisy"])
def test_motion_only_presolves_equal_sequential(lookalike, name):
    """``gnn_rounds=0, motion_dim=8``: the motion term is mask-free, so
    the parallel, y_det and revival pre-solves stay sound; each equals
    the port's sequential scan and the reference."""
    jcfg, variables, _ = lookalike
    variables = strip(variables, 0, motion=True)
    jcfg0, pcfg0 = lookalike_cfgs(gnn_rounds=0)
    net = port_net(variables, pcfg0)
    kw = {} if name == "flagship" else ASSOC[name]
    feats, dm = window_feats(3)
    fast = TrackingModule(net, AssocConfig(**kw))
    assert fast.parallel_assoc or fast.hybrid_presolve
    seq = TrackingModule(net, AssocConfig(**kw), parallel_assoc=False,
                         hybrid_presolve=False)
    got = {k: v.numpy() for k, v in _scan_track(
        fast, to_t(feats), torch.from_numpy(dm))[0].items()}
    want = {k: v.numpy() for k, v in _scan_track(
        seq, to_t(feats), torch.from_numpy(dm))[0].items()}
    check_outputs(got, want, f"{name} pre-solve vs sequential")
    ref = reference_scan(model_entry(jcfg0), variables, kw, feats, dm)
    check_outputs(got, ref, f"{name} vs reference")
    # Without the motion MLP the ids move: the term acts on these inputs.
    plain = port_net(strip(variables, 0, motion=False),
                     lookalike_cfgs(gnn_rounds=0, motion_dim=0)[1])
    ids0 = _scan_track(TrackingModule(plain, AssocConfig(**kw)),
                       to_t(feats), torch.from_numpy(dm))[0]["ids"].numpy()
    assert (ids0 != got["ids"]).any()


def test_hybrid_presolve_with_gnn_raises(lookalike):
    _, _, net = lookalike
    with pytest.raises(ValueError, match="unsound with gnn_rounds"):
        TrackingModule(net, AssocConfig(**LOOKALIKE), hybrid_presolve=True)
    assert not TrackingModule(net, AssocConfig(**LOOKALIKE),
                              hybrid_presolve=False).hybrid_presolve


def class_feats(seed):
    """``window_feats`` with a class-group id per slot (fixed over time,
    as a track's is), carried as ``feats["cls"]``."""
    feats, dm = window_feats(seed)
    S, T, N = dm.shape
    cls = np.random.default_rng(seed + 50).integers(0, 3, (S, 1, N))
    feats["cls"] = np.broadcast_to(cls, (S, T, N))[..., None].astype(
        np.float32).copy()
    return feats, dm


def test_class_gate_forbids_cross_class_links():
    r = np.random.default_rng(4)
    link = r.normal(0, 1, (2, 6, 6)).astype(np.float32)
    cp, cc = r.integers(0, 3, (2, 6)), r.integers(0, 3, (2, 6))
    for dt in ("float32", "bfloat16"):
        want = np.asarray(jax.jit(j_class_gate)(
            jnp.asarray(link, dt), jnp.asarray(cp, jnp.float32),
            jnp.asarray(cc, jnp.float32)).astype(jnp.float32))
        got = apply_class_gate(torch.from_numpy(link).to(getattr(torch, dt)),
                               torch.from_numpy(cp).float(),
                               torch.from_numpy(cc).float())
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_array_equal(got.float().numpy(), want)
        cross = cp[:, :, None] != cc[:, None, :]
        assert (want[cross] < -9e4).all() and (want[~cross] > -9e4).all()


@pytest.mark.parametrize("name", ["flagship", "ydet", "noisy"])
def test_class_gate_ids_equal_reference(quality_models, name):
    """The class gate on every strategy (the parallel pre-solve, the y_det
    and revival pre-solves and the sequential scan) against the
    reference's auto strategy; no track spans two classes, and the gate
    changes the ids."""
    jnet, variables, net = quality_models
    kw = dict({} if name == "flagship" else ASSOC[name], class_gate=True)
    feats, dm = class_feats(5)
    ref = reference_scan(jnet, variables, kw, feats, dm)
    fast = TrackingModule(net, AssocConfig(**kw))
    assert fast.class_gating and (fast.parallel_assoc
                                  or fast.hybrid_presolve)
    assert fast.init_state(6).feats["cls"].dtype == torch.float32
    for mod in (fast, TrackingModule(net, AssocConfig(**kw),
                                     parallel_assoc=False,
                                     hybrid_presolve=False)):
        got, _ = _scan_track(mod, to_t(feats), torch.from_numpy(dm))
        check_outputs({k: v.numpy() for k, v in got.items()}, ref, name)
    ids, cls = ref["ids"], feats["cls"][..., 0]
    for ids_s, cls_s in zip(ids, cls):
        for i in np.unique(ids_s[ids_s >= 0]):
            assert len(np.unique(cls_s[ids_s == i])) == 1
    ungated = dict(kw, class_gate=False)
    feats.pop("cls")
    other, _ = _scan_track(TrackingModule(net, AssocConfig(**ungated)),
                           to_t(feats), torch.from_numpy(dm))
    assert (other["ids"].numpy() != ids).any()


def write_dropout_detections(root):
    """``detections/dropout/``: the labels as scored detections, with the
    pedestrian missing from frames 1-2 of sequence 0000 and a car from
    frame 1 of 0001, so the ghost pool emits coverage rows."""
    import os

    from mmmot_tpu.data.kitti_io import (read_kitti_tracking_labels,
                                         write_kitti_result)

    os.makedirs(os.path.join(root, "detections", "dropout"))
    for seq, drop in (("0000", {(1, 3), (2, 3)}), ("0001", {(1, 1)})):
        gt = read_kitti_tracking_labels(os.path.join(root, "label_02",
                                                     f"{seq}.txt"))
        dets = [o for t in sorted(gt) for o in gt[t]
                if (t, o.track_id) not in drop]
        for o in dets:
            o.score = 0.9
        write_kitti_result(dets, os.path.join(root, "detections", "dropout",
                                              f"{seq}.txt"))


@pytest.mark.parametrize("assoc,batch_sequences", [
    (dict(), 1), (dict(NOISY, coverage_max_miss=0), 2)])
def test_joint_classes_runner_files_equal_reference(
        quality_models, tmp_path, assoc, batch_sequences):
    """``track_class="All"`` with the class gate on tests/test_cli_track.py's
    tree (cars and a pedestrian; with the noisy stack, detections with
    dropouts): one pass, rows under each detection's class and coverage
    rows under their track's, summaries per class; every file byte-equal
    to the JAX runner's (coverage scores within the fixtures' float32
    tolerance, as in tests/test_torch_runner.py), and without the gate
    the port refuses, as the reference does."""
    jnet, variables, net = quality_models
    root = build_kitti_tree(tmp_path)
    source = {}
    if assoc:
        write_dropout_detections(root)
        source = dict(det_source="dropout")
    jd = dataclasses.replace(tiny_cfg_jax().data, root=root,
                             max_dets=MAX_DETS, track_class="All", **source)
    td = dataclasses.replace(tiny_debug().data, root=root, max_dets=MAX_DETS,
                             track_class="All", **source)
    kw = dict(window=2, batch_sequences=batch_sequences, score_sweep=(0.5,))
    j_kitti_runner._WINDOW_FNS.clear()
    jmod = JTrackingModule(jnet, variables,
                           JAssocConfig(solver="auction", class_gate=True,
                                        **assoc))
    ref = j_track_kitti(jmod, jd, str(tmp_path / "ref"), **kw)
    out = track_kitti_sequences(
        TrackingModule(net, AssocConfig(class_gate=True, **assoc)), td,
        str(tmp_path / "port"), **kw)
    ref_files, port_files = (files_of(tmp_path / d) for d in ("ref", "port"))
    assert set(port_files) == set(ref_files)
    assert {f"{s}_{c}.txt" for s in ("summary", "hota")
            for c in ("car", "pedestrian", "cyclist")} <= set(port_files)
    for name, data in ref_files.items():
        if port_files[name] == data:
            continue
        assert assoc and not name.startswith(("summary", "hota")), name
        for x, y in zip(port_files[name].decode().splitlines(),
                        data.decode().splitlines()):
            x, y = x.split(), y.split()
            assert x[:-1] == y[:-1], name
            assert abs(float(x[-1]) - float(y[-1])) <= (
                1e-5 + 5e-7 + 1e-4 * abs(float(y[-1]))), name
    rows = [l.split() for l in port_files["0000.txt"].decode().splitlines()]
    assert {r[2] for r in rows} == {"Car", "Pedestrian"}
    types = {}
    for r in rows:
        types.setdefault(r[1], set()).add(r[2])
    assert all(len(t) == 1 for t in types.values())
    if assoc:     # coverage rows, scored below the detections' 0.9
        assert "Pedestrian" in {r[2] for r in rows if float(r[-1]) < 0.9}
    assert set(out["metrics_by_class"]) == {"car", "pedestrian", "cyclist"}
    for c in ("car", "pedestrian"):
        assert out["metrics_by_class"][c].mota == \
            ref["metrics_by_class"][c].mota
        assert out["hota_by_class"][c].hota == ref["hota_by_class"][c].hota
    assert set(out["sweep"][0.5]) == {"car", "pedestrian", "cyclist"}
    with pytest.raises(ValueError, match="class_gate"):
        track_kitti_sequences(TrackingModule(net), td, str(tmp_path / "x"))


def test_bridge_lookalike_tree_fills_gnn_and_motion():
    """A full-width full_mmmot_lookalike-shaped flax tree (shapes only)
    crosses the bridge with every leaf used, the GNN rounds of each
    branch and the motion MLP included."""
    jcfg = load_config("experiments/full_mmmot_lookalike/config.yaml").model
    jnet = model_entry(jcfg)
    dummy = {"crops": jnp.zeros((1, 2, 1, 112, 112, 3)),
             "points": jnp.zeros((1, 2, 1, 256, 4)),
             "point_mask": jnp.ones((1, 2, 1, 256), bool),
             "det_mask": jnp.ones((1, 2, 1), bool),
             "boxes": jnp.zeros((1, 2, 1, 4))}
    shapes = jax.eval_shape(lambda r: jnet.init({"params": r}, dummy,
                                                train=False),
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = TrackingNet(full_mmmot_lookalike().model, device="cpu")
    sd = load_flax_variables(tree, net)
    assert set(sd) == set(net.state_dict())
    extra = {k for k in sd if ".gnn_" in k or k.startswith("motion.")}
    assert len(extra) == 3 * 2 * 4 * 2 + 4
    assert sd["affinity_lidar.gnn_1.o.weight"].shape == (512, 512)
    assert sd["motion.dense_0.weight"].shape == (8, 6)


@pytest.fixture(scope="module")
def bf16_lookalike(lookalike):
    """The look-alike weights in bfloat16: the reference's sequential scan
    on its fused Pallas kernel (interpret mode, the motion term as its
    link_bias), the port on its kernel's plain version."""
    _, variables, _ = lookalike
    jcfg, pcfg = lookalike_cfgs(dtype="bfloat16")
    jmod = JTrackingModule(model_entry(jcfg), variables,
                           JAssocConfig(solver="auction", **LOOKALIKE),
                           use_pallas_affinity=True, pallas_interpret=True)
    run = jax.jit(lambda im, cl, bx, dm, pr: j_track(
        jmod, im, cl, bx, dm, pr, (32, 32), P, compact_capacity=40,
        extract_chunk=16, crop_window=CROP_WINDOW))
    return run, TrackingModule(port_net(variables, pcfg),
                               AssocConfig(**LOOKALIKE))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_bfloat16_lookalike_ids_equal_reference_pallas(bf16_lookalike, seed):
    run, mod = bf16_lookalike
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
