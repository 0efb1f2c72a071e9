"""The single-branch and dead-sensor forms of the port against the JAX
package: the presets ``fusion_C``, ``img_only``, ``lidar_only`` and
``batched_val`` against their YAML; the nets without a modality or with
one score branch (their flax trees across the weight bridge, their
features and module-path affinity); the fused affinity's K=1, K=2 and
``avg`` instances (the plain version against ``pallas_affinity`` in
interpret mode); a dead camera or LiDAR on the crops-given scan and
through the KITTI runner (result files byte-equal to the reference's)
and the track CLI; ``sensor_dropout``; a JAX ``fusion_C`` artifact
served by ``DeployedTracker``; and one training step of ``img_only`` and
``fusion_C`` against the reference's.  Float32 throughout, at
``tiny_debug``'s widths; tolerances are the fixtures'.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.config import load_config
from mmmot_tpu.kernels import build_affinity_params as j_build_params
from mmmot_tpu.kernels import pallas_affinity
from mmmot_tpu.models import model_entry
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence as j_track_sequence
from mmmot_tpu.tracker.kitti_runner import \
    track_kitti_sequences as j_track_kitti
import mmmot_tpu.tracker.kitti_runner as j_kitti_runner
from mmmot_tpu_torch.compat.from_jax import (load_flax_variables,
                                             to_flax_variables)
from mmmot_tpu_torch.config import AssocConfig, tiny_debug
from mmmot_tpu_torch.data.augment import sensor_dropout
from mmmot_tpu_torch.kernels.affinity import (affinity_plain,
                                              build_affinity_params)
from mmmot_tpu_torch.models.tracking_net import score_branches
from mmmot_tpu_torch.tracker.kitti_runner import track_kitti_sequences
from mmmot_tpu_torch.tracker.sequence import track_sequence
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_presets import PRESETS, pruned
from tests.test_torch_runner import data_cfgs, files_of, tree  # noqa: F401
from tests.test_torch_tracking import models  # noqa: F401
from tests.torch_port_fixtures import (assert_close, port_net, tiny_cfg_jax,
                                       to_numpy,
                                       torch_one_thread)  # noqa: F401

N = 8
D = 64          # tiny_debug's out_dim


def switched(model_cfg, **sw):
    return dataclasses.replace(model_cfg, **sw)


@pytest.mark.parametrize("name", list(PRESETS))
def test_presets_match_yaml(name):
    """Every field the port carries equals the YAML's, the modality
    switches, ``score_fusion`` and the Sinkhorn knobs included."""
    import mmmot_tpu_torch.config as presets
    from mmmot_tpu_torch.cli.train import PRESETS as TRAIN_PRESETS
    from mmmot_tpu_torch.cli.track import PRESETS as TRACK_PRESETS

    port = getattr(presets, name)()
    ref = load_config(f"experiments/{name}/config.yaml")
    assert port.name == ref.name and name in TRACK_PRESETS + TRAIN_PRESETS
    for f in dataclasses.fields(port.assoc):
        assert getattr(port.assoc, f.name) == getattr(ref.assoc, f.name), f
    assert port.assoc.solver == "sinkhorn"
    for f in ("use_image", "use_lidar", "score_fusion", "compute_dtype",
              "remat", "int8_appearance"):
        assert getattr(port.model, f) == getattr(ref.model, f), f
    for sect in ("appearance", "point", "fusion", "affinity", "new_end"):
        p, r = getattr(port.model, sect), getattr(ref.model, sect)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), (sect, f.name)
    assert dataclasses.asdict(port.train) == dataclasses.asdict(ref.train)
    for f in dataclasses.fields(port.data):
        want = getattr(ref.data, f.name)
        assert getattr(port.data, f.name) == (
            tuple(want) if isinstance(want, list) else want), f.name


def test_model_config_refuses_what_reference_refuses():
    from mmmot_tpu.config import ModelConfig as JModelConfig
    from mmmot_tpu_torch.config import ModelConfig, PointConfig

    with pytest.raises(ValueError, match="score_fusion"):
        ModelConfig(score_fusion="max")
    with pytest.raises(ValueError, match="at least one modality"):
        ModelConfig(use_image=False, use_lidar=False)
    with pytest.raises(ValueError):
        ModelConfig(point=PointConfig(out_dim=256))
    # Without the LiDAR its width is not read, as in the reference.
    ModelConfig(point=PointConfig(out_dim=256), use_lidar=False)
    JModelConfig(use_lidar=False).point.out_dim  # noqa: B018


VARIANTS = dict(PRESETS, avg=dict(score_fusion="avg"))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_trees_cross_the_bridge(models, name):
    """The flax tree of each variant (``jax.eval_shape`` of its init) is
    the pruned full tree; it loads strictly into the port's net, which
    owns exactly the modules the config uses, and ``to_flax_variables``
    gives it back leaf for leaf."""
    _, variables, _ = models
    pcfg = switched(tiny_debug().model, **VARIANTS[name])
    jnet = model_entry(switched(tiny_cfg_jax().model, **VARIANTS[name]))
    dummy = {"crops": jnp.zeros((1, 2, N, 32, 32, 3)),
             "points": jnp.zeros((1, 2, N, 16, 4)),
             "point_mask": jnp.ones((1, 2, N, 16), bool),
             "det_mask": jnp.ones((1, 2, N), bool)}
    shapes = jax.eval_shape(lambda r: jnet.init({"params": r}, dummy,
                                                train=False),
                            jax.random.PRNGKey(0))
    v = to_numpy(pruned(variables, pcfg))
    assert (jax.tree.map(lambda s: s.shape, shapes)
            == jax.tree.map(np.shape, v))
    net = port_net(v, pcfg)
    assert hasattr(net, "appear_net") == pcfg.use_image
    assert hasattr(net, "point_net") == pcfg.use_lidar
    assert hasattr(net.fusion, "gate") == (pcfg.use_image and pcfg.use_lidar)
    assert net.score_branches == score_branches(pcfg)
    back = to_flax_variables(net)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    # The load stays strict: a leaf of a module the net lacks is refused.
    extra = {**v, "params": {**v["params"], "point_net_x": {
        "bias": np.zeros(1, np.float32)}}}
    with pytest.raises(KeyError, match="unused leaves"):
        load_flax_variables(extra, net)
    if len(jax.tree.leaves(v)) < len(jax.tree.leaves(variables)):
        with pytest.raises(KeyError, match="unused leaves"):
            load_flax_variables(to_numpy(variables), net)


def frame_inputs(seed, n_frames=2):
    r = np.random.default_rng(seed)
    lead = (n_frames, N)
    crops = r.normal(0, 1, lead + (32, 32, 3)).astype(np.float32)
    points = r.normal(0, 1, lead + (16, 4)).astype(np.float32)
    pmask = r.random(lead + (16,)) < 0.7
    dmask = r.random(lead) < 0.75
    dmask[1, :2] = True
    return crops, points, pmask, dmask


CASES = {name: (sw, None) for name, sw in VARIANTS.items()}
CASES.update(dead_camera=({}, "camera"), dead_lidar=({}, "lidar"),
             avg_dead_camera=(dict(score_fusion="avg"), "camera"))


@pytest.mark.parametrize("case", list(CASES))
def test_module_affinity_matches_reference(models, case):
    """``extract`` (with the dead sensor's input None) and the
    module-path ``affinity`` between the two frames: the branches
    present, summed or averaged."""
    sw, dead = CASES[case]
    _, variables, _ = models
    pcfg = switched(tiny_debug().model, **sw)
    v = pruned(variables, pcfg)
    jnet = model_entry(switched(tiny_cfg_jax().model, **sw))
    net = port_net(v, pcfg)
    crops, points, pmask, dmask = frame_inputs(4)
    if dead == "camera":
        crops = None
    if dead == "lidar":
        points = pmask = None

    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.tensor(np.array(x))

    jf = jax.jit(lambda c, p, pm, dm: jnet.apply(
        v, c, p, pm, dm, train=False, method=jnet.extract))(
        j(crops), j(points), j(pmask), j(dmask))
    with torch.inference_mode():
        feats = net.extract(t(crops), t(points), t(pmask), t(dmask))
    assert set(feats) == set(jf)
    for k in feats:
        assert_close(feats[k], jf[k], err_msg=k)
    fp = {k: x[0] for k, x in jf.items()}
    fc = {k: x[1] for k, x in jf.items()}
    jo = jax.jit(lambda a, b, mp, mc: jnet.apply(
        v, a, b, mp, mc, train=False, method=jnet.affinity))(
        fp, fc, j(dmask[0]), j(dmask[1]))
    with torch.inference_mode():
        out = net.affinity({k: t(np.asarray(x)) for k, x in fp.items()},
                           {k: t(np.asarray(x)) for k, x in fc.items()},
                           t(dmask[0]), t(dmask[1]))
    for k in ("link", "link_norm", "new", "end"):
        assert_close(getattr(out, k), getattr(jo, k), err_msg=k)


INSTANCES = {"K1": (("fused",), False), "K2_dead_camera":
             (("fused", "lidar"), False), "K2_dead_lidar":
             (("fused", "image"), False), "K3_avg":
             (("fused", "image", "lidar"), True), "K1_avg": (("fused",), True),
             "K2_avg": (("fused", "lidar"), True)}


@pytest.mark.parametrize("inst", list(INSTANCES))
def test_plain_instances_match_pallas(models, inst):
    """``affinity_plain`` at K branches (``avg``: their sum divided by K)
    against the reference's ``pallas_affinity`` in interpret mode, on the
    same stacked parameters, with an empty frame and holed masks."""
    branches, avg = INSTANCES[inst]
    _, variables, net = models
    jcfg = tiny_cfg_jax().model
    K = len(branches)
    r = np.random.default_rng(11)
    B = 3
    a = r.normal(0, 1, (B, K, N, D)).astype(np.float32)
    b = r.normal(0, 1, (B, K, N, D)).astype(np.float32)
    mp = np.stack([np.arange(N) < 5, np.zeros(N, bool),
                   np.isin(np.arange(N), (0, 3, 7))])
    mc = np.stack([np.arange(N) < 8, np.arange(N) < 3,
                   np.isin(np.arange(N), (1, 2, 6))])
    ref = pallas_affinity(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(mp), jnp.asarray(mc),
        j_build_params(variables, jcfg, branches, jnp.float32), avg=avg,
        interpret=True)
    params = build_affinity_params(net, torch.float32, branches)
    assert params["w1"].shape[0] == K
    got = affinity_plain(*(torch.as_tensor(x) for x in (a, b, mp, mc)),
                         params, avg=avg)
    for name, x, y in zip(got._fields, got, ref):
        assert_close(x, y, err_msg=name)
    pm = mp[:, :, None] & mc[:, None, :]
    assert (got.link.numpy()[~pm] == 0).all()
    if avg:     # the division moved the link
        summed = affinity_plain(*(torch.as_tensor(x) for x in (a, b, mp,
                                                                mc)),
                                params)
        if K > 1:
            assert (summed.link - got.link).abs().max() > 1e-3


@pytest.mark.parametrize("dead,y_det", [("camera", False), ("lidar", False),
                                        ("camera", True)])
def test_scan_with_dead_sensor(models, dead, y_det):
    """The crops-given ``track_sequence`` with the dead sensor's input
    None: the parallel pre-solve, and with y_det the hybrid scan, whose
    carried state holds no feats of the dead branch; ids as the
    reference's."""
    jnet, variables, net = models
    crops, points, pmask, dmask = frame_inputs(6, n_frames=4)
    if dead == "camera":
        crops = None
    else:
        points = pmask = None
    kw = dict(use_det_scores=True) if y_det else {}
    jmod = JTrackingModule(jnet, variables, JAssocConfig(**kw))
    ref = jax.jit(lambda c, p, pm, dm: j_track_sequence(
        jmod, c, p, pm, dm))(*(None if x is None else jnp.asarray(x)
                              for x in (crops, points, pmask, dmask)))
    out = track_sequence(TrackingModule(net, AssocConfig(**kw)), crops,
                         points, pmask, dmask)
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    if not y_det:       # y_det may reject a detection: its id is -1
        assert (out["ids"].numpy()[dmask] >= 0).all()


@pytest.mark.parametrize("dead", ["camera", "lidar"])
def test_dead_sensor_runner_files_equal_reference(models, tree, tmp_path,
                                                  dead):
    """The KITTI runner with a dead sensor (window 2: the carried state
    crosses window boundaries without the dead branch): result files and
    summaries byte-equal to the reference runner's."""
    jnet, variables, net = models
    jd, td = data_cfgs(tree)
    j_kitti_runner._WINDOW_FNS.clear()
    jmod = JTrackingModule(jnet, variables, JAssocConfig(solver="auction"))
    ref = j_track_kitti(jmod, jd, str(tmp_path / "ref"), window=2,
                        dead_sensor=dead)
    out = track_kitti_sequences(TrackingModule(net), td,
                                str(tmp_path / "port"), window=2,
                                dead_sensor=dead)
    ref_files, port_files = (files_of(tmp_path / d) for d in ("ref", "port"))
    assert set(port_files) == set(ref_files) and "0000.txt" in port_files
    for name, data in ref_files.items():
        assert port_files[name] == data, name
    assert out["n_dropped"] == ref["n_dropped"] == 0
    assert out["metrics"].mota == ref["metrics"].mota


def test_track_cli_solver_and_dead_sensor(models, tree, tmp_path):
    """``cli/track --solver greedy --dead-sensor lidar --cpu`` writes the
    files of the runner called directly with that solver and sensor."""
    from mmmot_tpu_torch.cli.track import main
    from mmmot_tpu_torch.compat.from_jax import save_npz

    _, variables, net = models
    weights = str(tmp_path / "w.npz")
    save_npz(weights, to_numpy(variables))
    stats = main(["--config", "tiny_debug", "--data-root", tree, "--cpu",
                  "--weights", weights, "--window", "2", "--solver",
                  "greedy", "--dead-sensor", "lidar", "--result-path",
                  str(tmp_path / "cli")])
    direct = track_kitti_sequences(
        TrackingModule(net, AssocConfig(solver="greedy")),
        dataclasses.replace(tiny_debug().data, root=tree),
        str(tmp_path / "direct"), window=2, dead_sensor="lidar")
    cli_files = files_of(tmp_path / "cli" / "tiny_debug" / "latest")
    assert cli_files == files_of(tmp_path / "direct")
    assert stats["n_dropped"] == direct["n_dropped"] == 0


def test_sensor_dropout_never_drops_both():
    gen = torch.Generator().manual_seed(0)
    batch = {"det_mask": torch.ones(2, 2, 3, dtype=torch.bool)}
    seen = set()
    for _ in range(400):
        out, use_img, use_lid = sensor_dropout(gen, batch, 0.6, 0.9)
        assert out is batch
        assert bool(use_img) or bool(use_lid)
        seen.add((bool(use_img), bool(use_lid)))
    assert seen == {(True, True), (True, False), (False, True)}
    for _ in range(20):
        assert all(map(bool, sensor_dropout(gen, batch)[1:]))


def test_jax_fusion_c_artifact_served_by_port(models, tmp_path,
                                              monkeypatch):
    """A JAX-exported ``serve_step`` artifact of a tiny-width ``fusion_C``
    (one score branch, Sinkhorn) tracks through the port's
    ``DeployedTracker`` to the JAX ``DeployedTracker``'s ids frame by
    frame.  The port resolves the artifact's config by its preset name,
    here replaced by the tiny-width ``fusion_C``."""
    import mmmot_tpu_torch.config as presets
    from mmmot_tpu.deploy import DeployedTracker as JDeployedTracker
    from mmmot_tpu.deploy import export_serve_step as j_export
    from mmmot_tpu.deploy import save_artifact as j_save
    from mmmot_tpu_torch.deploy import DeployedTracker

    from tests.test_torch_deploy import H, M, W, scene

    _, variables, _ = models
    sw = PRESETS["fusion_C"]
    jcfg = tiny_cfg_jax()
    jcfg = dataclasses.replace(
        jcfg, name="fusion_C", model=switched(jcfg.model, **sw),
        assoc=dataclasses.replace(jcfg.assoc, solver="sinkhorn"))
    tiny = tiny_debug()
    monkeypatch.setattr(presets, "fusion_C", lambda: dataclasses.replace(
        tiny, name="fusion_C", model=switched(tiny.model, **sw),
        assoc=AssocConfig(solver="sinkhorn")))
    v = pruned(variables, switched(tiny.model, **sw))
    exported, state0 = j_export(jcfg, v, (H, W), M, platforms=("cpu",))
    out = str(tmp_path / "jax_fusion_c")
    j_save(out, exported, v, state0, jcfg, (H, W), M)
    jtrk = JDeployedTracker.load(out)
    trk = DeployedTracker.load(out, device="cpu")
    assert trk.module.assoc_cfg.solver == "sinkhorn"
    assert trk.module.net.score_branches == ("fused",)
    for f in scene(31, n_frames=5, n_dets=4, miss=0.2):
        want = jtrk.step(f["image"], f["cloud"], f["boxes"], f["proj"])
        got = trk.step(f["image"], f["cloud"], f["boxes"], f["proj"])
        assert got[0] == want[0]
        assert_close(np.asarray(got[1]), np.asarray(want[1]))


@pytest.mark.parametrize("name", ["img_only", "fusion_C"])
def test_single_branch_train_step_matches_reference(models, name):
    """One tiny training step (sgd, clip active, compact-first at
    capacity 12) of the net without the LiDAR and of the fused-only net
    against the reference's ``train_step``; then the port's own step on
    the CPU twice (``train.parity.step_agreement``, the GPU's check)."""
    from mmmot_tpu.train import train_step as j_train_step
    from mmmot_tpu_torch.train.parity import step_agreement
    from mmmot_tpu_torch.train.trainer import create_train_state, train_step

    from tests.test_torch_train import (GRAD_TOL, assert_state, make_batch,
                                        mapped, ref_state)
    from tests.test_torch_train import to_torch as batch_to_torch

    _, variables, _ = models
    sw = PRESETS[name]
    jcfg = tiny_cfg_jax()
    jnet = model_entry(switched(jcfg.model, **sw))
    pcfg = switched(tiny_debug().model, **sw)
    v = pruned(variables, pcfg)
    jtcfg = dataclasses.replace(jcfg.train, optimizer="sgd", lr=1e-2,
                                warmup_steps=0, grad_clip=1.0)
    b = make_batch(31)
    jstate = ref_state(v, jtcfg, 4)
    jstate, jm = jax.jit(lambda s, x: j_train_step(
        jnet, s, x, jax.random.PRNGKey(1), compact_capacity=12))(
        jstate, {k: jnp.asarray(x) for k, x in b.items()})
    tcfg = dataclasses.replace(tiny_debug().train, optimizer="sgd", lr=1e-2,
                               warmup_steps=0, grad_clip=1.0)
    state = create_train_state(port_net(v, pcfg), tcfg, 4)
    state, m = train_step(state, batch_to_torch(b), compact_capacity=12)
    assert set(m) == set(jm)
    for k in m:
        assert_close(m[k], np.asarray(jm[k]), err_msg=k)
    assert_state(state.net, mapped(jstate.params, jstate.batch_stats,
                                   state.net), GRAD_TOL * tcfg.lr)
    agree = step_agreement("cpu", sw)
    assert agree["loss"] == agree["loss_cpu"]
