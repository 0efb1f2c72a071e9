"""The int8 appearance trunk of the port (``mmmot_tpu_torch/models/
quantize.py``, ``kernels/int8_conv.py``) against the JAX package's
``mmmot_tpu/models/quantize.py`` at ``tiny_debug`` widths (VGG11,
``width_mult`` 0.125, 32x32 crops), on shared weights and numpy inputs
from a seed.

- The int8 conv's plain version against a numpy int64 reference, bit for
  bit.
- On the JAX quant tree carried across (``compat.from_jax.
  quant_from_flax``), every int8 stage map bit for bit (the product is
  exact, the requant rounds once as XLA's jitted multiply-add does), and
  the float tail within the fixtures' float32 tolerance.
- The port's own calibration within 1e-5 relative (conv sums in other
  orders); its own quantisation on JAX's scales within one int8 level on
  at most 0.1 % of the weights (``lax.rsqrt`` in the BN fold is not
  bit-exact against ``torch.rsqrt``), its ``m`` and ``b`` within 1e-6
  relative.
- Tracking ids with the int8 trunk equal the JAX int8 pipeline's, in
  float32 and bfloat16; int8 artifacts both ways.
"""

import dataclasses
import functools
import json
import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.models import model_entry
from mmmot_tpu.models import quantize as jq
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
from mmmot_tpu_torch.compat.from_jax import quant_from_flax
from mmmot_tpu_torch.config import tiny_debug
from mmmot_tpu_torch.kernels.int8_conv import (int8_conv3x3_requant,
                                               int8_conv3x3_requant_plain,
                                               pack_weights)
from mmmot_tpu_torch.models import quantize as pq
from mmmot_tpu_torch.tracker.sequence import (track_sequence,
                                              track_sequence_from_frames)
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_tracking import (CROP_WINDOW, models,  # noqa: F401
                                       raw_sequence)
from tests.torch_port_fixtures import (assert_close, build_kitti_tree,
                                       port_net, tiny_cfg_jax, to_numpy,
                                       torch_one_thread)  # noqa: F401

DEPTH = 11
CROP, P = (32, 32), 16


def rand_crops(seed, n):
    """ImageNet-normalised-looking crops, roughly [-2.6, 2.7]."""
    r = np.random.default_rng(seed)
    return r.normal(0.0, 1.0, (n, *CROP, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def quant_pair(models):  # noqa: F811
    """The JAX package's calibration scales and jitted quant tree on 24
    crops of the shared float32 weights, the tree as numpy, and the port's
    net with those weights."""
    jnet, variables, net = models
    cfg = tiny_cfg_jax().model.appearance
    crops = rand_crops(1, 24)
    scales = jq.calibrate_appearance(variables, cfg, jnp.asarray(crops))
    quant = jax.jit(lambda v: jq.quantize_appearance(v, cfg, scales))(
        variables)
    return scales, to_numpy(quant), variables, net


# -- the int8 conv's plain version --------------------------------------

def f32_round_once(x: Fraction) -> np.float32:
    """The float32 nearest to the exact ``x``, ties to even."""
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c,
             np.nextafter(c, np.float32(np.inf)))
    best = min(abs(Fraction(float(v)) - x) for v in cands)
    near = [v for v in cands if abs(Fraction(float(v)) - x) == best]
    return min(near, key=lambda v: int(np.asarray(v).view(np.int32)) & 1)


def numpy_conv_requant(x, w_hwio, m, b):
    """int64 3x3 SAME conv, the multiply-add rounded once from the exact
    value, round half to even, clip to [0, 127]."""
    n, H, W, _ = x.shape
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((n, H, W, w_hwio.shape[-1]), np.int64)
    for ky in range(3):
        for kx in range(3):
            acc += np.einsum("nhwc,co->nhwo", xp[:, ky:ky + H, kx:kx + W],
                             w_hwio[ky, kx].astype(np.int64))
    out = np.empty(acc.shape, np.int8)
    for idx, a in np.ndenumerate(acc):
        c = idx[-1]
        y = f32_round_once(Fraction(float(np.float32(a))) * Fraction(
            float(m[c])) + Fraction(float(b[c])))
        out[idx] = np.clip(np.round(y), 0, 127)
    return out


def conv_case(name):
    r = np.random.default_rng(7)
    if name == "tie":
        # Centre tap 1, others 0, m = 0.5, b = 0: y = x / 2 = 0.5, 1.5,
        # 2.5, 3.5, exact ties that round to even: 0, 2, 2, 4.
        x = np.array([1, 3, 5, 7], np.int8).reshape(1, 1, 4, 1)
        w = np.zeros((3, 3, 1, 8), np.int8)
        w[1, 1] = 1
        return x, w, np.full(8, 0.5, np.float32), np.zeros(8, np.float32)
    cin = {"cin3": 3, "cin8": 8, "empty": 8}[name]
    x = r.integers(-127, 128, (2, 5, 6, cin)).astype(np.int8)
    if name == "empty":
        x[1] = 0                              # an all-masked crop
    w = r.integers(-127, 128, (3, 3, cin, 16)).astype(np.int8)
    m = (40.0 / (5400.0 * (9 * cin) ** 0.5)
         * r.uniform(0.5, 1.5, 16)).astype(np.float32)
    b = r.uniform(-10, 50, 16).astype(np.float32)
    return x, w, m, b


@pytest.mark.parametrize("name", ["cin3", "cin8", "empty", "tie"])
def test_int8_conv_plain_matches_numpy(name):
    x, w, m, b = conv_case(name)
    got = int8_conv3x3_requant(torch.as_tensor(x),
                               pack_weights(torch.as_tensor(w)),
                               torch.as_tensor(m), torch.as_tensor(b))
    assert got.dtype == torch.int8 and got.is_contiguous()
    want = numpy_conv_requant(x, w, m, b)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "tie":
        assert got[0, 0, :, 0].tolist() == [0, 2, 2, 4]
    elif name == "empty":
        # A zero crop answers each channel's clip(round(b)).
        np.testing.assert_array_equal(
            got[1].numpy(), np.broadcast_to(np.clip(np.round(b), 0, 127),
                                            got[1].shape))
    else:
        assert 0 < (got.numpy() == 0).mean() < 1


# -- the trunk on the JAX quant tree ------------------------------------

def test_trunk_stages_bit_equal_reference(quant_pair):
    """Every int8 stage map, on the JAX tree carried across, equals the
    jitted reference's; an all-zero crop included."""
    _, quant, _, _ = quant_pair
    cfg = tiny_cfg_jax().model.appearance
    x = rand_crops(2, 10)
    x[3] = 0.0
    want = jax.jit(lambda q, x: jq.quantized_trunk_stages(q, cfg, x))(
        quant, jnp.asarray(x))
    got = pq.quantized_trunk_stages(quant_from_flax(quant, DEPTH),
                                    torch.as_tensor(x))
    assert len(got) == len(want) == 5
    for (g, gs), (w, ws) in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert gs.item() == float(ws)
    assert (got[0][0].numpy() > 0).mean() > 0.1


def test_calibration_matches_reference(quant_pair):
    scales, _, _, net = quant_pair
    got = pq.calibrate_appearance(net.appear_net,
                                  torch.as_tensor(rand_crops(1, 24)))
    np.testing.assert_allclose(got, scales, rtol=1e-5)


def test_quantize_matches_reference(quant_pair):
    """The port's quantisation on JAX's scales: ``w_q`` within one int8
    level on at most 0.1 % of the weights, ``m`` and ``b`` within 1e-6
    relative, the input and stage scales equal."""
    scales, quant, _, net = quant_pair
    q = pq.quantize_appearance(net.appear_net, scales).to_flax()
    assert q["in_scale"] == quant["in_scale"]
    assert q["stage_scales"] == quant["stage_scales"]
    n_off = n_all = 0
    for got, want in zip(q["layers"], quant["layers"]):
        d = np.abs(got["w"].astype(np.int32) - want["w"])
        assert d.max() <= 1 and got["w"].dtype == np.int8
        n_off += int((d > 0).sum())
        n_all += d.size
        for k in ("m", "b"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_scale_count_checked(quant_pair):
    _, _, _, net = quant_pair
    with pytest.raises(ValueError, match="calibration scales"):
        pq.quantize_appearance(net.appear_net, (1.0, 2.0))


def test_appearance_apply_matches_reference(quant_pair):
    """The full int8 appearance branch on the JAX tree: within the float32
    tolerance (the tail's matmuls sum in other orders), masked rows
    exactly 0."""
    _, quant, variables, net = quant_pair
    cfg = tiny_cfg_jax().model.appearance
    crops = rand_crops(3, 12).reshape(2, 6, *CROP, 3)
    mask = np.arange(12).reshape(2, 6) % 5 != 4
    want = jax.jit(lambda q, v, c, mk: jq.quantized_appearance_apply(
        q, v, cfg, c, mk))(quant, variables, jnp.asarray(crops),
                           jnp.asarray(mask))
    got = pq.quantized_appearance_apply(
        quant_from_flax(quant, DEPTH), net.appear_net,
        torch.as_tensor(crops), torch.as_tensor(mask))
    assert got.shape == (2, 6, 64)
    assert_close(got, np.asarray(want))
    assert (got[torch.as_tensor(~mask)] == 0).all()


def test_int8_trunk_close_to_float(models):  # noqa: F811
    """The port's own calibration and quantisation: features within the
    reference's bounds of the float trunk's (cosine per valid detection
    above 0.99, relative norm below 0.1)."""
    _, _, net = models
    crops = torch.as_tensor(rand_crops(4, 12))
    mask = torch.arange(12) < 10
    with torch.no_grad():
        ref = net.appear_net(crops, mask).double()
        quant = pq.quantize_appearance(
            net.appear_net, pq.calibrate_appearance(net.appear_net, crops))
        q = pq.quantized_appearance_apply(quant, net.appear_net, crops,
                                          mask).double()
    assert (q[10:] == 0).all()
    cos = (ref[:10] * q[:10]).sum(-1) / (ref[:10].norm(dim=-1)
                                         * q[:10].norm(dim=-1))
    assert cos.min() > 0.99, cos
    rel = (q[:10] - ref[:10]).norm() / ref[:10].norm()
    assert rel < 0.1, rel


# -- tracking ------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_pipelines(quant_pair):
    """Per compute dtype: the JAX int8 pipeline on its Pallas path
    (interpret mode), jitted once, and the port's module with the same
    tree attached."""
    _, quant, variables, _ = quant_pair
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(tiny_cfg_jax().model, compute_dtype=dtype)
        jmod = JTrackingModule(model_entry(jcfg),
                               {**variables, "quant_int8": quant},
                               JAssocConfig(solver="auction"),
                               use_pallas_affinity=True,
                               pallas_interpret=True)
        run = jax.jit(functools.partial(
            j_track, jmod, crop_size=CROP, points_per_det=P, compact_capacity=40,
            extract_chunk=16, crop_window=CROP_WINDOW))
        net = port_net(variables, dataclasses.replace(tiny_debug().model,
                                                      compute_dtype=dtype))
        net.quant_int8 = quant_from_flax(quant, DEPTH)
        out[dtype] = run, TrackingModule(net)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [11, 20, 26, 28, 29])
def test_int8_tracking_ids_equal_reference(int8_pipelines, dtype, seed):
    run, module = int8_pipelines[dtype]
    images, clouds, boxes, det_mask, proj = raw_sequence(seed)
    ref = run(*map(jnp.asarray, (images, clouds, boxes, det_mask, proj)))
    out = track_sequence_from_frames(
        module, images, clouds, boxes, det_mask, proj, CROP, P,
        compact_capacity=40, extract_chunk=16, crop_window=CROP_WINDOW)
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(ref["ids"]))
    assert int(out["n_dropped"]) == int(ref["n_dropped"]) == 0


def test_int8_ids_equal_float_on_separated_detections(models):  # noqa: F811
    """Three persistent, visually distinct detections: the int8 trunk
    (calibrated on them) tracks them as the float trunk does."""
    _, _, net = models
    r = np.random.default_rng(2)
    T, N = 4, 8
    base = r.normal(0, 1, (3, *CROP, 3)).astype(np.float32)
    crops = np.zeros((T, N, *CROP, 3), np.float32)
    for t in range(T):
        crops[t, :3] = base + 0.01 * r.normal(0, 1, base.shape)
    points = r.normal(0, 1, (T, N, P, 4)).astype(np.float32)
    det_mask = np.zeros((T, N), bool)
    det_mask[:, :3] = True
    point_mask = np.broadcast_to(det_mask[..., None], (T, N, P)).copy()
    args = (crops, points, point_mask, det_mask)
    ids_f = track_sequence(TrackingModule(net), *args)["ids"]
    try:
        pq.with_int8_appearance(net, torch.as_tensor(crops[det_mask]))
        ids_q = track_sequence(TrackingModule(net), *args)["ids"]
    finally:
        net.quant_int8 = None
    assert torch.equal(ids_q, ids_f)
    assert ids_f[:, :3].unique().numel() == 3


# -- artifacts -------------------------------------------------------------

H, W, M = 48, 96, 64


def tree_frames(root, n=5):
    from mmmot_tpu_torch.data.kitti_dataset import KittiTrackingDataset

    data = dataclasses.replace(tiny_debug().data, root=root,
                               cloud_filter="none")
    arrs = KittiTrackingDataset(data, max_cloud_points=M).load_sequence(
        "0000", max_frames=n)
    return [(arrs.images[t], arrs.clouds[t], arrs.boxes[t][arrs.det_mask[t]],
             arrs.proj) for t in range(n)]


def test_int8_export_round_trip(tmp_path):
    """``cli/export --int8`` calibrates on a tree and writes the trunk
    (``"int8": true``, the reference's tagged ``quant_int8`` layout, read
    back by the reference's reader); ``DeployedTracker`` serves it with
    the ids of the live step of the same net and trunk."""
    from mmmot_tpu.deploy import _fill_from_npz as j_fill
    from mmmot_tpu_torch.cli.export import main as export_main
    from mmmot_tpu_torch.cli.track import build_module
    from mmmot_tpu_torch.compat.from_jax import to_flax_variables
    from mmmot_tpu_torch.deploy import (DeployedTracker, _build_step,
                                        _fresh_state, _state_to_dict)

    root = build_kitti_tree(tmp_path)
    out = str(tmp_path / "int8_artifact")
    export_main(["--config", "tiny_debug", "--out", out, "--cpu", "--seed",
                 "3", "--shape", f"{H}x{W}x{M}", "--int8", "--calib-root",
                 root])
    man = json.load(open(os.path.join(out, "manifest.json")))
    assert man["int8"] is True
    layers = man["weights_structure"]["quant_int8"]["layers"]["__tuple__"]
    assert len(layers) == 8 and layers[0] == {"w": "int8", "m": "float32",
                                              "b": "float32"}
    cfg = dataclasses.replace(tiny_debug(), data=dataclasses.replace(
        tiny_debug().data, root=root))
    live = build_module(cfg, None, 3, "cpu")
    pq.quantize_for_inference(live.net, cfg.data)
    with np.load(os.path.join(out, "weights.npz")) as z:
        stored = j_fill(man["weights_structure"], z)
    want = to_flax_variables(live.net)
    assert isinstance(stored["quant_int8"]["layers"], tuple)
    for (kp, a), (kw, b) in zip(
            jax.tree_util.tree_flatten_with_path(stored)[0],
            jax.tree_util.tree_flatten_with_path(want)[0]):
        assert kp == kw and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=str(kp))
    trk = DeployedTracker.load(out, device="cpu")
    assert trk.module.net.quant_int8 is not None
    step = _build_step(live, CROP, P)
    st = _state_to_dict(_fresh_state(live, 8))
    for image, cloud, boxes, proj in tree_frames(root):
        got = trk.step(image, cloud, boxes, proj)[0]
        bp = np.zeros((8, 4), np.float32)
        bp[:len(boxes)] = boxes
        st, ids, _ = step(st, image, cloud, bp, np.arange(8) < len(boxes),
                          proj)
        assert got == ids[:len(boxes)].tolist()


def test_jax_int8_artifact_served_by_port(quant_pair, tmp_path):
    """A JAX int8 serve_step artifact (the reference exporter's pytree
    with ``quant_int8``, ``"int8": true``) tracks through the port's
    ``DeployedTracker`` to the JAX ``DeployedTracker``'s ids."""
    from mmmot_tpu.deploy import DeployedTracker as JDeployedTracker
    from mmmot_tpu.deploy import export_serve_step as j_export
    from mmmot_tpu.deploy import save_artifact as j_save
    from mmmot_tpu_torch.deploy import DeployedTracker

    from tests.test_torch_deploy import scene

    _, quant, variables, _ = quant_pair
    qvars = {**variables, "quant_int8": jax.tree.map(jnp.asarray, quant)}
    cfg = tiny_cfg_jax()
    exported, state0 = j_export(cfg, qvars, (64, 96), 300,
                                platforms=("cpu",))
    out = str(tmp_path / "jax_int8")
    j_save(out, exported, qvars, state0, cfg, (64, 96), 300,
           extra={"int8": True})
    jtrk = JDeployedTracker.load(out)
    trk = DeployedTracker.load(out, device="cpu")
    assert trk.module.net.quant_int8 is not None
    for f in scene(31, n_frames=5, n_dets=4, miss=0.2):
        want = jtrk.step(f["image"], f["cloud"], f["boxes"], f["proj"])
        got = trk.step(f["image"], f["cloud"], f["boxes"], f["proj"])
        assert got[0] == want[0]


@pytest.mark.parametrize("int8", [True, False])
def test_window_step_refuses_weights_of_the_other_kind(quant_pair, tmp_path,
                                                       int8):
    """A window artifact handed weights of the other kind at the call
    (float weights to an int8 artifact, an int8 trunk to a float one)
    raises the manifest's mismatch instead of serving another model."""
    from mmmot_tpu_torch.deploy import export_window_step, load_window_step

    _, quant, variables, _ = quant_pair
    net = port_net(variables, tiny_debug().model)
    if int8:
        net.quant_int8 = quant_from_flax(quant, DEPTH)
    out = str(tmp_path / "window")
    export_window_step(out, tiny_debug(), TrackingModule(net), (64, 96),
                       300, 2)
    assert json.load(open(os.path.join(out, "manifest.json")))["int8"] is int8
    step = load_window_step(out, device="cpu")
    if int8:
        other = {k: v for k, v in step.weights.items() if k != "quant_int8"}
        match = "says int8 but the weights hold no quant_int8"
    else:
        other = {**step.weights, "quant_int8": quant}
        match = "hold a quant_int8 trunk but the manifest does not say int8"
    with pytest.raises(ValueError, match=match):
        step(other, step.state0)


def test_int8_kernel_labels_and_tensor_core_count():
    """The build's ptxas and SASS readers name the int8 conv's two
    instances and count its ``IMMA`` (integer tensor-core) instructions."""
    from mmmot_tpu_torch.kernels import build as kbuild

    name = ("_ZN45_GLOBAL__N__e5b998cb_12_int8_conv_cu_ffac2ab819int8_conv3x3"
            "_kernelIL{}EEEvPKaS2_PKfS4_Paiiiiii")
    vec, byt = name.format("b1"), name.format("b0")
    log = (f"ptxas info    : Compiling entry function '{vec}' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 62 registers, used 1 barriers, 18432 bytes "
           "smem\n")
    assert kbuild.ptxas_summary(log) == {"int8_conv3x3_kernel<vec>": dict(
        stack=0, spill_stores=0, spill_loads=0, registers=62, smem=18432)}
    sass = (f"\t\tFunction : {byt}\n"
            "        /*0450*/                   IMMA.16832.S8.S8 R24, R4.ROW, "
            "R20.COL, R24 ;\n"
            f"\t\tFunction : {vec}\n"
            "        /*0010*/                   IMMA.16832.S8.S8 R24, R4.ROW, "
            "R20.COL, R24 ;\n"
            "        /*0020*/                   IMMA.16832.S8.S8 R8, R4.ROW, "
            "R22.COL, R8 ;\n")
    assert kbuild.sass_counts(sass, ("IMMA", "HMMA")) == {
        "int8_conv3x3_kernel<bytes>": {"IMMA": 1, "HMMA": 0},
        "int8_conv3x3_kernel<vec>": {"IMMA": 2, "HMMA": 0}}


def test_calibration_without_detections_raises(models, tmp_path):  # noqa: F811
    """A tree whose first sequence has no detection gives the reference's
    error, not a trunk calibrated on nothing."""
    _, _, net = models
    root = build_kitti_tree(tmp_path)
    os.makedirs(os.path.join(root, "detections", "pointpillars"))
    open(os.path.join(root, "detections", "pointpillars", "0000.txt"),
         "w").close()
    data = dataclasses.replace(tiny_debug().data, root=root)
    with pytest.raises(ValueError, match="no detections found"):
        pq.quantize_for_inference(net, data)
    assert net.quant_int8 is None
