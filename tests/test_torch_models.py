"""Port parity: config presets, the flax -> torch weight bridge, and every
model module of ``mmmot_tpu_torch`` against the flax ``apply`` of the JAX
package with the same weights (float32; tolerances in
tests/torch_port_fixtures.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import load_config
from mmmot_tpu.configs import flagship
from mmmot_tpu.models import model_entry
from mmmot_tpu.models.appearance import AppearanceNet as JAppearance
from mmmot_tpu.models.fusion import FusionModule as JFusion
from mmmot_tpu.models.layers import MLP as JMLP
from mmmot_tpu.models.new_end import NewEndHead as JNewEnd
from mmmot_tpu.models.pointnet import PointNet as JPointNet
from mmmot_tpu.models.affinity import AffinityModule as JAffinity
from mmmot_tpu.models.affinity import normalize_link as j_normalize_link
from mmmot_tpu_torch.assoc.auction import SCALING_STEPS
from mmmot_tpu_torch.compat.from_jax import load_flax_variables
from mmmot_tpu_torch.config import full_mmmot, tiny_debug
from mmmot_tpu_torch.models.affinity import normalize_link
from mmmot_tpu_torch.models.layers import fma, sigmoid
from mmmot_tpu_torch.models.pointnet import POINT_IN_DIM
from mmmot_tpu_torch.models.tracking_net import TrackingNet

from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax, to_numpy,
                                       torch_one_thread)  # noqa: F401

N = 8


@pytest.fixture(scope="module")
def shared():
    jcfg = tiny_cfg_jax().model
    jnet, variables = init_flax(jcfg, N=N)
    net = port_net(variables, tiny_debug().model)
    return jcfg, jnet, variables, net


def sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"].get(name, {})}


def inputs(seed=0, lead=(2, N)):
    r = np.random.default_rng(seed)
    crops = r.normal(0, 1, lead + (32, 32, 3)).astype(np.float32)
    points = r.normal(0, 1, lead + (16, 4)).astype(np.float32)
    pmask = r.random(lead + (16,)) < 0.7
    dmask = r.random(lead) < 0.75
    return crops, points, pmask, dmask


@pytest.mark.parametrize("name,yaml_path", [
    ("tiny_debug", "experiments/tiny_debug/config.yaml"),
    ("full_mmmot", "experiments/full_mmmot/config.yaml"),
    ("full_mmmot_b8", "experiments/full_mmmot_b8/config.yaml"),
    ("full_mmmot_ydet", "experiments/full_mmmot_ydet/config.yaml"),
    ("full_mmmot_noisy", "experiments/full_mmmot_noisy/config.yaml"),
    ("full_mmmot_lookalike",
     "experiments/full_mmmot_lookalike/config.yaml")])
def test_presets_match_yaml(name, yaml_path):
    """The Python presets carry the YAML values of every field they have."""
    import mmmot_tpu_torch.config as presets

    port = getattr(presets, name)()
    ref = load_config(yaml_path)
    assert port.name == ref.name
    for f in dataclasses.fields(port.assoc):
        assert getattr(port.assoc, f.name) == getattr(ref.assoc, f.name), (
            "assoc", f.name)
    for sect in ("appearance", "point", "fusion", "affinity", "new_end"):
        p, r = getattr(port.model, sect), getattr(ref.model, sect)
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), (sect, f.name)
    assert port.model.compute_dtype == ref.model.compute_dtype
    assert port.model.remat == ref.model.remat
    assert dataclasses.asdict(port.train) == dataclasses.asdict(ref.train)
    for f in dataclasses.fields(port.data):
        want = getattr(ref.data, f.name)
        assert getattr(port.data, f.name) == (
            tuple(want) if isinstance(want, list) else want), ("data", f.name)
    assert ref.data.crop_size == port.model.appearance.crop_size
    assert ref.data.point_len == port.model.point.point_len
    assert ref.assoc.solver == "auction"
    assert ref.assoc.auction_scaling_steps == SCALING_STEPS
    assert ref.model.point.in_dim == POINT_IN_DIM
    assert ref.assoc.link_threshold == 0.0
    # The knobs the port fixes rather than carries.
    m = ref.model
    assert m.affinity.correlation_ops == ("subabs",)
    assert (m.affinity.num_layers, m.affinity.softmax_mode) == (2, "dual")
    assert (m.new_end.version, m.new_end.pool) == (2, "max")
    assert (m.fusion.variant, m.fusion.keep_single) == ("C", True)
    assert (m.score_fusion, m.use_image, m.use_lidar) == ("add", True, True)
    assert not m.point.use_tnet and not m.appearance.s2d_stem
    assert m.appearance.batch_norm and m.appearance.skip_pool


def test_bridge_flagship_tree_has_no_leftovers():
    """A full flagship-shaped tree (shapes only, zero leaves) crosses the
    bridge with every leaf used and every port tensor filled."""
    jnet = model_entry(flagship().model)
    dummy = {"crops": jnp.zeros((1, 2, 1, 224, 224, 3)),
             "points": jnp.zeros((1, 2, 1, 512, 4)),
             "point_mask": jnp.ones((1, 2, 1, 512), bool),
             "det_mask": jnp.ones((1, 2, 1), bool)}
    shapes = jax.eval_shape(lambda r: jnet.init({"params": r}, dummy,
                                                train=False),
                            jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    net = TrackingNet(full_mmmot().model, device="cpu")
    sd = load_flax_variables(tree, net)
    assert set(sd) == set(net.state_dict())
    # A leaf the port does not have is refused.
    tree["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_flax_variables(tree, net)


def test_bridge_refuses_missing_leaf(shared):
    _, _, variables, net = shared
    tree = to_numpy(variables)
    del tree["batch_stats"]["point_net"]["bn_0"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(tree, net)


def test_appearance_net(shared):
    jcfg, _, variables, net = shared
    crops, _, _, dmask = inputs(1)
    ref = JAppearance(jcfg.appearance).apply(
        sub(variables, "appear_net"), jnp.asarray(crops), jnp.asarray(dmask))
    out = net.appear_net(torch.from_numpy(crops), torch.from_numpy(dmask))
    assert out.shape == (2, N, 64)
    assert_close(out, ref)


def test_pointnet(shared):
    jcfg, _, variables, net = shared
    _, points, pmask, dmask = inputs(2)
    ref = JPointNet(jcfg.point).apply(
        sub(variables, "point_net"), jnp.asarray(points), jnp.asarray(pmask),
        jnp.asarray(dmask))
    out = net.point_net(torch.from_numpy(points), torch.from_numpy(pmask),
                        torch.from_numpy(dmask))
    assert_close(out, ref)


def test_fusion(shared):
    jcfg, _, variables, net = shared
    r = np.random.default_rng(3)
    img, lid = (r.normal(0, 1, (2, N, 64)).astype(np.float32)
                for _ in range(2))
    dmask = r.random((2, N)) < 0.7
    ref = JFusion(jcfg.fusion).apply(sub(variables, "fusion"),
                                     jnp.asarray(img), jnp.asarray(lid),
                                     jnp.asarray(dmask))
    out = net.fusion(torch.from_numpy(img), torch.from_numpy(lid),
                     torch.from_numpy(dmask))
    assert set(out) == set(ref) == {"fused", "image", "lidar"}
    for k in out:
        assert_close(out[k], ref[k], err_msg=k)


def _pair_inputs(seed, D=64):
    r = np.random.default_rng(seed)
    fp, fc = (r.normal(0, 1, (3, N, D)).astype(np.float32) for _ in range(2))
    mp = np.arange(N)[None] < np.array([[5], [0], [8]])
    mc = np.arange(N)[None] < np.array([[7], [3], [8]])
    return fp, fc, mp, mc


@pytest.mark.parametrize("branch", ["fused", "image", "lidar"])
def test_affinity_module_and_normalize(shared, branch):
    jcfg, _, variables, net = shared
    fp, fc, mp, mc = _pair_inputs(4)
    name = f"affinity_{branch}"
    ref = JAffinity(jcfg.affinity).apply(
        sub(variables, name), *map(jnp.asarray, (fp, fc, mp, mc)))
    out = getattr(net, name)(*map(torch.from_numpy, (fp, fc, mp, mc)))
    assert_close(out, ref)
    assert_close(normalize_link(out, torch.from_numpy(mp),
                                torch.from_numpy(mc)),
                 j_normalize_link(ref, jnp.asarray(mp), jnp.asarray(mc)))


def test_new_end_and_mlp(shared):
    jcfg, _, variables, net = shared
    fp, fc, mp, mc = _pair_inputs(5)
    link = np.random.default_rng(6).normal(0, 2, (3, N, N)).astype(np.float32)
    link = link * (mp[:, :, None] & mc[:, None, :])
    args = (fp[:, :, :64], fc[:, :, :64], link, mp, mc)
    ref = JNewEnd(jcfg.new_end).apply(sub(variables, "new_end"),
                                      *map(jnp.asarray, args))
    out = net.new_end(*map(torch.from_numpy, args))
    assert_close(out[0], ref[0])
    assert_close(out[1], ref[1])
    ref_det = JMLP((jcfg.new_end.hidden_dim, 1), use_bn=False).apply(
        sub(variables, "det_head"), jnp.asarray(fp))
    assert_close(net.det_head(torch.from_numpy(fp)), ref_det)


def test_tracking_net_extract_affinity_det(shared):
    _, jnet, variables, net = shared
    crops, points, pmask, dmask = inputs(7)
    ref = jnet.apply(variables, *map(jnp.asarray,
                                     (crops, points, pmask, dmask)),
                     method=jnet.extract)
    with torch.inference_mode():
        out = net.extract(*map(torch.from_numpy,
                               (crops, points, pmask, dmask)))
    for k in ("fused", "image", "lidar"):
        assert_close(out[k], ref[k], err_msg=k)
    fp = {k: v[0] for k, v in ref.items()}
    fc = {k: v[1] for k, v in ref.items()}
    ref_aff = jnet.apply(variables, fp, fc, jnp.asarray(dmask[0]),
                         jnp.asarray(dmask[1]), method=jnet.affinity)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in fp.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in fc.items()}
    aff = net.affinity(tp, tc, torch.from_numpy(dmask[0]),
                       torch.from_numpy(dmask[1]))
    for k in ("link", "link_norm", "new", "end"):
        assert_close(getattr(aff, k), getattr(ref_aff, k), err_msg=k)
    ref_det = jnet.apply(variables, fp["fused"], jnp.asarray(dmask[0]),
                         method=jnet.det_score)
    assert_close(net.det_score(tp["fused"], torch.from_numpy(dmask[0])),
                 ref_det)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrackingNet(tiny_debug().model)


def test_sigmoid_every_bfloat16_value():
    """The port's sigmoid equals ``jax.nn.sigmoid`` on every finite
    bfloat16 input (``torch.sigmoid`` differs on 1116 of them), and is
    ``torch.sigmoid`` in float32."""
    bits = np.arange(2 ** 16, dtype=np.uint16).view(np.int16)
    x = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    assert x.numel() == 65280
    want = np.asarray(jax.nn.sigmoid(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
        .astype(jnp.float32))
    np.testing.assert_array_equal(sigmoid(x).float().numpy(), want)
    assert (torch.sigmoid(x).float().numpy() != want).sum() > 1000
    xf = x.float()
    assert torch.equal(sigmoid(xf), torch.sigmoid(xf))


def test_fusion_bfloat16():
    """Fusion C in bfloat16 from the same bfloat16 embeddings: the gate
    rounds as the reference's sigmoid does.  The projections' products
    sum in another order than XLA's, which may move a rare element by a
    bfloat16 ulp."""
    jcfg = dataclasses.replace(tiny_cfg_jax().model, compute_dtype="bfloat16")
    jnet, variables = init_flax(jcfg, N=N)
    pcfg = dataclasses.replace(tiny_debug().model, compute_dtype="bfloat16")
    net = port_net(variables, pcfg)
    r = np.random.default_rng(5)
    img, lid = (r.normal(0, 1, (512, 64)).astype(np.float32)
                for _ in range(2))
    ji, jl = (jnp.asarray(v).astype(jnp.bfloat16) for v in (img, lid))
    ref = jax.jit(lambda a, b: JFusion(jcfg.fusion, dtype=jnp.bfloat16)
                  .apply(sub(variables, "fusion"), a, b))(ji, jl)
    with torch.no_grad():
        got = net.fusion(torch.tensor(img).bfloat16(),
                         torch.tensor(lid).bfloat16())
    want = np.asarray(ref["fused"].astype(jnp.float32))
    differ = got["fused"].float().numpy() != want
    assert differ.mean() < 1e-3, differ.mean()
    assert_close(got["fused"], want, rtol=2 ** -7, atol=2 ** -7)


def test_fma_rounds_once_as_xla_does():
    """``a * b + c`` compiled by XLA rounds once; so does the port's
    ``fma``, and two roundings differ on about a quarter of the inputs."""
    r = np.random.default_rng(6)
    a, b, c = (r.normal(0, 10, 100000).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (a * b + c != want).mean() > 0.1
