"""The model variants of the port against the JAX package: fusion A and
B, ``keep_single`` off, the PointNet T-Net, new/end v1, a 3-layer link
head, and the correlation ops, pools and softmax modes the fused
kernel's instances carry.  Per variant: its flax tree across the weight
bridge both ways, and the module-path forward (``net.apply``) on a
training batch.  Then ``kernel_supported`` against ``pallas_supported``
over a grid of configs, the tracker's dispatch (the kernel for every
config it covers, the module path for the others), the plain kernel's
cosine and pool instances in bfloat16 against ``pallas_affinity`` in
interpret mode on the kept seeds, track ids of two kernel variants
equal to the JAX runner's, and one training step of fusion A with the
T-Net.  Float32 unless stated, at ``tiny_debug``'s widths; tolerances
are the fixtures'.  The float32 kernel instances (each op, two and four
ops, each pool and mode, N=100 and 128) are cases of
tests/test_torch_affinity_kernel.py.

    python -m pytest tests/test_torch_variants.py -q
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.kernels import build_affinity_params as j_build_params
from mmmot_tpu.kernels import pallas_affinity, pallas_supported
from mmmot_tpu.models import model_entry
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
from mmmot_tpu_torch.compat.from_jax import (load_flax_variables,
                                             to_flax_variables)
from mmmot_tpu_torch.config import AssocConfig, tiny_debug
from mmmot_tpu_torch.kernels.affinity import (affinity_plain,
                                              build_affinity_params,
                                              kernel_supported)
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_presets import BF16_SEEDS
from tests.test_torch_tracking import CROP_WINDOW, P, raw_sequence
from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax, to_numpy,
                                       torch_one_thread)  # noqa: F401

N = 8
D = 64          # tiny_debug's out_dim
ALL_OPS = ("mul", "subabs", "diff", "cosine")

# Variant -> {model sub-config: {field: value}}, applied to both sides.
VARIANTS = {
    # The two tracked variants: mul with fusion A and the T-Net (softmax
    # pool, single softmax); all four ops with fusion B (mean pool, no
    # softmax).
    "A_tnet_mul": dict(fusion={"variant": "A"}, point={"use_tnet": True},
                       affinity={"correlation_ops": ("mul",),
                                 "softmax_mode": "single"},
                       new_end={"pool": "softmax"}),
    "B_all_ops": dict(fusion={"variant": "B"},
                      affinity={"correlation_ops": ALL_OPS,
                                "softmax_mode": "none"},
                      new_end={"pool": "mean"}),
    # One score branch: the single embeddings are not kept.
    "no_single_cosine": dict(fusion={"keep_single": False},
                             affinity={"correlation_ops": ("cosine",)}),
    # The kernel covers neither: the module path.
    "v1": dict(new_end={"version": 1},
               affinity={"correlation_ops": ("diff",)}),
    "layers3": dict(affinity={"num_layers": 3,
                              "correlation_ops": ("subabs", "mul")}),
}


def switch(model_cfg, sections):
    return dataclasses.replace(model_cfg, **{
        k: dataclasses.replace(getattr(model_cfg, k), **v)
        for k, v in sections.items()})


@pytest.fixture(scope="module")
def variants():
    """(flax net, variables, port net) per variant, built on first use.
    The T-Net's output layer starts at zero in flax (an identity
    transform): it is drawn nonzero here.  The new/end output biases are
    pushed down so that links win the LP (as the ``models`` fixture of
    tests/test_torch_tracking.py does, further: at -3 fusion A's mul
    links lose every LP of the tracked sequence)."""
    cache = {}

    def get(name):
        if name not in cache:
            sw = VARIANTS[name]
            jnet, v = init_flax(switch(tiny_cfg_jax().model, sw), seed=3)
            params = jax.tree.map(np.asarray, jax.device_get(v["params"]))
            rng = np.random.default_rng(9)
            if "tnet" in params.get("point_net", {}):
                mat = params["point_net"]["tnet"]["fc_mat"]
                mat["kernel"] = rng.normal(
                    0, 0.05, mat["kernel"].shape).astype(np.float32)
            for head in ("new_mlp", "end_mlp"):
                params["new_end"][head]["dense_1"]["bias"] = np.full(
                    (1,), -6.0, np.float32)
            v = {"params": params, "batch_stats": v["batch_stats"]}
            cache[name] = (jnet, v, port_net(v, switch(tiny_debug().model,
                                                       sw)))
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tree_crosses_the_bridge_both_ways(variants, name):
    """The variant's own leaves (fusion ``proj`` or ``proj_image`` /
    ``proj_lidar``, ``point_net/tnet``, ``head_1``, the v1 heads' D-wide
    first Dense) load strictly into the port's net, and
    ``to_flax_variables`` gives the tree back leaf for leaf."""
    _, v, net = variants(name)
    v = to_numpy(v)
    back = to_flax_variables(net)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    sw, p = VARIANTS[name], v["params"]
    variant = sw.get("fusion", {}).get("variant", "C")
    assert ("proj" in p["fusion"]) == (variant == "A")
    assert ("gate" in p["fusion"]) == (variant == "C")
    assert ("tnet" in p["point_net"]) == ("point" in sw)
    layers = sw.get("affinity", {}).get("num_layers", 2)
    assert ("head_1" in p["affinity_fused"]) == (layers == 3)
    ops = sw.get("affinity", {}).get("correlation_ops", ("subabs",))
    assert p["affinity_fused"]["head_0"]["kernel"].shape[0] == len(ops) * D
    assert ("affinity_image" in p) == (name != "no_single_cosine")
    width = D if name == "v1" else D + 1
    assert p["new_end"]["new_mlp"]["dense_0"]["kernel"].shape[0] == width
    assert net.state_dict().keys() == load_flax_variables(v, net).keys()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_module_forward_matches_reference(variants, name):
    """The training forward in eval mode (``net.apply``: extraction,
    the module-path affinity of every adjacent pair, the det head) on a
    batch of two samples of two frames."""
    from tests.test_torch_train import make_batch, to_torch

    jnet, v, net = variants(name)
    b = make_batch(17)
    ref = jax.jit(lambda x: jnet.apply(v, x, train=False))(
        {k: jnp.asarray(x) for k, x in b.items()})
    with torch.no_grad():
        out = net(to_torch(b))
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k], np.asarray(ref[k]), err_msg=k)
    mode = VARIANTS[name].get("affinity", {}).get("softmax_mode", "dual")
    if mode == "none":
        assert torch.equal(out["link_norm"], out["link"])


def test_kernel_supported_equals_pallas_supported():
    """Over a grid of link-head depths, new/end versions and pools, ops,
    softmax modes and score fusions."""
    from mmmot_tpu.config import ModelConfig as JModelConfig

    from mmmot_tpu_torch.config import ModelConfig

    n = 0
    for layers, version, pool, ops, mode, fusion in itertools.product(
            (1, 2, 3), (1, 2), ("max", "mean", "softmax"),
            (("subabs",), ("cosine", "diff"), ALL_OPS),
            ("dual", "single", "none"), ("add", "avg", "fused-only")):
        sw = dict(affinity={"num_layers": layers, "correlation_ops": ops,
                            "softmax_mode": mode},
                  new_end={"version": version, "pool": pool})
        port = switch(ModelConfig(score_fusion=fusion), sw)
        ref = switch(JModelConfig(score_fusion=fusion), sw)
        assert kernel_supported(port) == pallas_supported(ref), sw
        n += kernel_supported(port)
    assert 0 < n < 3 * 2 * 3 * 3 * 3 * 3


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tracker_dispatch_follows_kernel_supported(variants, name,
                                                   monkeypatch):
    """A covered config runs ``fused_affinity`` (its plain version on
    the CPU) and never the module path; v1 and the 3-layer head run the
    module path and never the kernel, and forcing the kernel on them
    raises."""
    import mmmot_tpu_torch.tracker.tracker as tracker_mod

    _, _, net = variants(name)
    calls = {"kernel": 0, "module": 0}
    kernel, module = tracker_mod.fused_affinity, type(net).affinity_link

    def counted_kernel(*a, **kw):
        calls["kernel"] += 1
        return kernel(*a, **kw)

    def counted_module(self, *a, **kw):
        calls["module"] += 1
        return module(self, *a, **kw)

    monkeypatch.setattr(tracker_mod, "fused_affinity", counted_kernel)
    monkeypatch.setattr(type(net), "affinity_link", counted_module)
    supported = kernel_supported(net.cfg)
    if not supported:
        with pytest.raises(ValueError, match="does not cover"):
            TrackingModule(net, fused_kernel=True)
    mod = TrackingModule(net)
    assert mod.fused_kernel == supported
    images, clouds, boxes, det_mask, proj = raw_sequence(11)
    track_sequence_from_frames(mod, images, clouds, boxes, det_mask, proj,
                               (32, 32), P, compact_capacity=40,
                               extract_chunk=16, crop_window=CROP_WINDOW)
    assert (calls["kernel"] > 0, calls["module"] > 0) == (supported,
                                                          not supported)


# bfloat16 instances: (correlation ops, pool, softmax mode).
BF16_INSTANCES = {"cosine": (("cosine",), "max", "dual"),
                  "mean": (("subabs",), "mean", "dual"),
                  "softmax": (("subabs",), "softmax", "single"),
                  "all_ops_mean_none": (ALL_OPS, "mean", "none")}


@pytest.mark.parametrize("seed", BF16_SEEDS)
@pytest.mark.parametrize("inst", list(BF16_INSTANCES))
def test_bfloat16_instances_match_pallas(variants, inst, seed):
    """The plain version in bfloat16 against ``pallas_affinity`` in
    interpret mode on the same parameters: the link and its
    normalisation equal, the heads (whose first Dense the two sum in
    other orders) within one bfloat16 ulp of their scale; holed masks,
    an empty frame, N=40."""
    ops, pool, mode = BF16_INSTANCES[inst]
    # The weights of the variant with these ops; subabs alone takes the
    # subabs rows of the all-ops net's W1.
    name = "no_single_cosine" if ops == ("cosine",) else "B_all_ops"
    _, v, net = variants(name)
    rows = slice(None)
    if ops == ("subabs",):
        i = ALL_OPS.index("subabs")
        rows = slice(i * D, (i + 1) * D)
    K = len(net.score_branches)
    cdt = torch.bfloat16
    r = np.random.default_rng(seed)
    Nw = 40
    a = r.normal(0, 1, (3, K, Nw, D)).astype(np.float32)
    b = r.normal(0, 1, (3, K, Nw, D)).astype(np.float32)
    mp = np.stack([r.random(Nw) < 0.7, np.zeros(Nw, bool),
                   np.ones(Nw, bool)])
    mc = np.stack([r.random(Nw) < 0.6, r.random(Nw) < 0.5,
                   np.isin(np.arange(Nw), (0, 17, 39))])
    jp = j_build_params(v, switch(tiny_cfg_jax().model, VARIANTS[name]),
                        net.score_branches, jnp.bfloat16)
    jp = dict(jp, w1=jp["w1"][:, rows])
    ref = pallas_affinity(*(jnp.asarray(x, jnp.bfloat16) for x in (a, b)),
                          jnp.asarray(mp), jnp.asarray(mc), jp, ops=ops,
                          pool=pool, softmax_mode=mode, interpret=True)
    params = build_affinity_params(net, cdt)
    params = dict(params, w1=params["w1"][:, rows].contiguous())
    got = affinity_plain(*(torch.tensor(x).to(cdt) for x in (a, b)),
                         torch.tensor(mp), torch.tensor(mc), params, ops=ops,
                         pool=pool, softmax_mode=mode)
    for k, x, y in zip(got._fields, got, ref):
        y = np.asarray(y.astype(jnp.float32))
        if k in ("link", "link_norm"):
            np.testing.assert_array_equal(x.float().numpy(), y, err_msg=k)
        else:
            scale = max(1.0, np.abs(y).max())
            assert np.abs(x.float().numpy() - y).max() <= 2.0 ** -7 * scale, k


@pytest.mark.parametrize("name", ["A_tnet_mul", "B_all_ops"])
def test_variant_ids_equal_reference(variants, name):
    """The raw-frames tracker of each variant: the reference on its fused
    Pallas kernel (interpret mode) with the variant's instance, the port
    on the kernel's plain version; ids equal, and links won."""
    jnet, v, net = variants(name)
    images, clouds, boxes, det_mask, proj = raw_sequence(11)
    jmod = JTrackingModule(jnet, v, JAssocConfig(solver="auction"),
                           use_pallas_affinity=True, pallas_interpret=True)
    ref = jax.jit(lambda im, cl, bx, dm, pr: j_track(
        jmod, im, cl, bx, dm, pr, (32, 32), P, compact_capacity=40,
        extract_chunk=16, crop_window=CROP_WINDOW))(
        *map(jnp.asarray, (images, clouds, boxes, det_mask, proj)))
    out = track_sequence_from_frames(
        TrackingModule(net, AssocConfig(solver="auction")), images, clouds,
        boxes, det_mask, proj, (32, 32), P, compact_capacity=40,
        extract_chunk=16, crop_window=CROP_WINDOW)
    ids = out["ids"].numpy()
    np.testing.assert_array_equal(ids, np.asarray(ref["ids"]))
    assert_close(out["det_score"], ref["det_score"])
    assert len(np.unique(ids[ids >= 0])) < det_mask.sum()


def test_fusion_a_tnet_train_step_matches_reference(variants):
    """One tiny training step (sgd, clip active, compact-first at
    capacity 12) of fusion A with the T-Net (mul, softmax pool) against
    the reference's ``train_step``; then the port's own step on the CPU
    twice (``train.parity.step_agreement``, the GPU's check)."""
    from mmmot_tpu.train import train_step as j_train_step
    from mmmot_tpu_torch.train.parity import step_agreement
    from mmmot_tpu_torch.train.trainer import create_train_state, train_step

    from tests.test_torch_train import (GRAD_TOL, assert_state, make_batch,
                                        mapped, ref_state)
    from tests.test_torch_train import to_torch as batch_to_torch

    jnet, v, net = variants("A_tnet_mul")
    jcfg = tiny_cfg_jax()
    jtcfg = dataclasses.replace(jcfg.train, optimizer="sgd", lr=1e-2,
                                warmup_steps=0, grad_clip=1.0)
    b = make_batch(31)
    jstate = ref_state(v, jtcfg, 4)
    jstate, jm = jax.jit(lambda s, x: j_train_step(
        jnet, s, x, jax.random.PRNGKey(1), compact_capacity=12))(
        jstate, {k: jnp.asarray(x) for k, x in b.items()})
    tcfg = dataclasses.replace(tiny_debug().train, optimizer="sgd", lr=1e-2,
                               warmup_steps=0, grad_clip=1.0)
    state = create_train_state(port_net(v, net.cfg), tcfg, 4)
    state, m = train_step(state, batch_to_torch(b), compact_capacity=12)
    assert set(m) == set(jm)
    for k in m:
        assert_close(m[k], np.asarray(jm[k]), err_msg=k)
    assert_state(state.net, mapped(jstate.params, jstate.batch_stats,
                                   state.net), GRAD_TOL * tcfg.lr)
    sw = VARIANTS["A_tnet_mul"]
    m = tiny_debug().model
    agree = step_agreement("cpu", {k: dataclasses.replace(getattr(m, k), **f)
                                   for k, f in sw.items()})
    assert agree["loss"] == agree["loss_cpu"]
