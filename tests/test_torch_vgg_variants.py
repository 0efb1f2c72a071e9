"""The VGG trunk's variants in the port against the JAX package: VGG
without BatchNorm, without skip pooling (the last stage alone), with the
space-to-depth stem, and parameters in bfloat16 (``param_dtype``).

- ``trunk_ops`` equal to the reference's for every depth, with and
  without the stem.
- Per variant: its flax tree across the weight bridge both ways, the
  image embeddings of ``extract`` (float32), and the raw-frames tracker's
  ids against the reference's Pallas path (interpret mode) in float32
  and bfloat16.
- DropBlock: the layer against ``DropBlock2D`` with the reference's
  Bernoulli draw (``jax.random.bernoulli``, replaced inside the test)
  fed to the port as its seeds; the identity in eval mode and at rate
  0; the train-mode image branch with DropBlock on every stage; the
  trainer's seeded generator.
- The int8 trunk: with the stem, every stage map bit-equal to the
  jitted reference's ``quantized_trunk_stages`` (the plain int8 conv at
  Cin = 12 included, and against a numpy int64 reference), the pools
  fused after conv_3, 6, 9 and 12 of VGG16, the calibration; without
  BatchNorm, the stage maps and the port's own quantisation; without
  skip pooling, the float tail.
- Serving a variant: a port artifact of a non-preset config through
  ``DeployedTracker``; a manifest that holds only a non-preset name, or a
  config that does not fit the weights, is refused.

Tiny widths (``tiny_debug``), on the CPU; tolerances are the fixtures'.

    python -m pytest tests/test_torch_vgg_variants.py -q
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmot_tpu.config import AssocConfig as JAssocConfig
from mmmot_tpu.models import model_entry
from mmmot_tpu.models import quantize as jq
from mmmot_tpu.models.appearance import trunk_ops as j_trunk_ops
from mmmot_tpu.models.layers import DropBlock2D as JDropBlock2D
from mmmot_tpu.models.tracking_net import TrackingNet as JTrackingNet
from mmmot_tpu.tracker import TrackingModule as JTrackingModule
from mmmot_tpu.tracker import track_sequence_from_frames as j_track
from mmmot_tpu_torch.compat.from_jax import (load_flax_variables,
                                             quant_from_flax,
                                             to_flax_variables)
from mmmot_tpu_torch.config import (AppearanceConfig, AssocConfig,
                                    ModelConfig, tiny_debug)
from mmmot_tpu_torch.deploy import DeployedTracker, export_serve_step
from mmmot_tpu_torch.kernels.int8_conv import (conv_instance,
                                               int8_conv3x3_requant_plain,
                                               pack_weights)
from mmmot_tpu_torch.models import quantize as pq
from mmmot_tpu_torch.models.appearance import trunk_ops
from mmmot_tpu_torch.models.layers import DropBlock2D
from mmmot_tpu_torch.tracker.sequence import track_sequence_from_frames
from mmmot_tpu_torch.tracker.tracker import TrackingModule

from tests.test_torch_deploy import H, M, W, port_steps, scene
from tests.test_torch_quantize import numpy_conv_requant, rand_crops
from tests.test_torch_tracking import CROP_WINDOW, P, raw_sequence
from tests.torch_port_fixtures import (assert_close, init_flax, port_net,
                                       tiny_cfg_jax, to_numpy,
                                       torch_one_thread)  # noqa: F401

DEPTH = 11

# Variant -> (appearance fields, model fields), applied to both sides.
VARIANTS = {
    "no_bn": ({"batch_norm": False}, {}),
    "last_stage": ({"skip_pool": False}, {}),
    "s2d": ({"s2d_stem": True}, {}),
    "bf16_params": ({}, {"param_dtype": "bfloat16"}),
}


def switch(model_cfg, name, **extra):
    app, model = VARIANTS[name]
    return dataclasses.replace(
        model_cfg, appearance=dataclasses.replace(model_cfg.appearance,
                                                  **app), **model, **extra)


@pytest.fixture(scope="module")
def variants():
    """(flax net, variables, port net) per variant, built on first use;
    the new/end output biases pushed down so that links win the LP (the
    ``models`` fixture of tests/test_torch_tracking.py)."""
    cache = {}

    def get(name):
        if name not in cache:
            jnet, v = init_flax(switch(tiny_cfg_jax().model, name), seed=3)
            params = jax.tree.map(lambda x: x, v["params"])
            for head in ("new_mlp", "end_mlp"):
                b = params["new_end"][head]["dense_1"]["bias"]
                params["new_end"][head]["dense_1"]["bias"] = jnp.full(
                    (1,), -3.0, b.dtype)
            v = {"params": params, "batch_stats": v["batch_stats"]}
            cache[name] = (jnet, v, port_net(v, switch(tiny_debug().model,
                                                       name)))
        return cache[name]
    return get


@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("depth", [11, 13, 16, 19])
def test_trunk_ops_equal_reference(depth, s2d):
    ops = trunk_ops(depth, s2d)
    assert ops == j_trunk_ops(depth, s2d)
    assert sum(op == ("stage",) for op in ops) == 5
    assert (ops[0] == ("s2d",)) == s2d
    assert sum(op == ("pool",) for op in ops) == (4 if s2d else 5)


def test_config_checks():
    """The reference's defaults and checks; DropBlock builds."""
    app = AppearanceConfig()
    assert (app.batch_norm, app.skip_pool, app.s2d_stem, app.dropblock_size,
            app.dropblock_rate) == (True, True, False, 7, 0.1)
    assert ModelConfig().param_dtype == "float32"
    with pytest.raises(ValueError, match="even crop"):
        AppearanceConfig(crop_size=(33, 32), s2d_stem=True)
    with pytest.raises(ValueError, match="param_dtype"):
        ModelConfig(param_dtype="int8")
    assert AppearanceConfig(dropblock=True).dropblock


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tree_crosses_the_bridge_both_ways(variants, name):
    """No ``bn_i`` without BatchNorm, conv_0 on 12 channels with the
    stem, one reducer without skip pooling, every parameter but none of
    the statistics in bfloat16 with ``param_dtype``; ``to_flax_variables``
    gives the tree back leaf for leaf."""
    _, v, net = variants(name)
    v = to_numpy(v)
    back = to_flax_variables(net)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    app = v["params"]["appear_net"]
    bb = app["backbone"]
    assert ("bn_0" in bb) == (name != "no_bn")
    assert ("backbone" in v["batch_stats"]["appear_net"]) == (name != "no_bn")
    assert bb["conv_0"]["kernel"].shape[2] == (12 if name == "s2d" else 3)
    assert ("reduce_1" in app) == (name != "last_stage")
    want = torch.bfloat16 if name == "bf16_params" else torch.float32
    assert {p.dtype for p in net.parameters()} == {want}
    assert {b.dtype for b in net.buffers()} == {torch.float32}
    loaded = load_flax_variables(v, net)
    assert loaded.keys() == net.state_dict().keys()
    assert all(loaded[k].dtype == t.dtype
               for k, t in net.state_dict().items())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_image_embeddings_match_reference(variants, name):
    """``extract``'s image branch (``AppearanceNet``, eval mode) on 2 x 5
    crops with a holed mask, float32."""
    jnet, v, net = variants(name)
    r = np.random.default_rng(5)
    crops = r.normal(0, 1, (2, 5, 32, 32, 3)).astype(np.float32)
    points = r.normal(0, 1, (2, 5, P, 4)).astype(np.float32)
    pm = np.ones((2, 5, P), bool)
    dm = np.array([[1, 1, 0, 1, 0], [1, 0, 1, 1, 1]], bool)
    ref = jax.jit(lambda *a: jnet.apply(v, *a, method=JTrackingNet.extract))(
        crops, points, pm, dm)
    with torch.no_grad():
        got = net.extract(*map(torch.as_tensor, (crops, points, pm, dm)))
    assert_close(got["image"], np.asarray(ref["image"]))
    assert_close(got["fused"], np.asarray(ref["fused"]))
    assert not got["image"][~torch.as_tensor(dm)].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_ids_equal_reference(variants, name, dtype):
    """The raw-frames tracker: the reference on its fused Pallas kernel
    (interpret mode), the port on the kernel's plain version; ids equal,
    and links won."""
    jnet, v, net = variants(name)
    if dtype == "bfloat16":
        jnet = model_entry(switch(tiny_cfg_jax().model, name,
                                  compute_dtype=dtype))
        net = port_net(v, switch(tiny_debug().model, name,
                                 compute_dtype=dtype))
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
    assert int(out["n_dropped"]) == int(ref["n_dropped"]) == 0
    assert len(np.unique(ids[ids >= 0])) < det_mask.sum()


# -- DropBlock -----------------------------------------------------------

def reference_dropblock(x_nhwc, rate, bs, seeds_nhwc, monkeypatch):
    """The reference's ``DropBlock2D`` in train mode with its Bernoulli
    draw replaced by ``seeds_nhwc``; returns (output, the gamma it asked
    for)."""
    asked = []

    def bernoulli(key, p, shape):
        asked.append(float(p))
        assert tuple(shape) == seeds_nhwc.shape
        return jnp.asarray(seeds_nhwc)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    out = JDropBlock2D(rate=rate, block_size=bs).apply(
        {}, jnp.asarray(x_nhwc), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    return np.asarray(out), asked[0]


# (map shape NHWC, rate, block size, seed density): a 7-block on 12x12,
# a block larger than the map (bs falls to 4), a 3-block at rate 0.3,
# and every seed on (the kept share falls to 0: the 1e-6 floor).
DROP_CASES = {"7_on_12": ((2, 12, 12, 5), 0.1, 7, 0.05),
              "bs_above_map": ((2, 4, 6, 3), 0.1, 7, 0.2),
              "3_on_8_rate_0.3": ((1, 8, 8, 2), 0.3, 3, 0.1),
              "all_seeds": ((1, 6, 6, 2), 0.1, 3, 1.0)}


@pytest.mark.parametrize("case", list(DROP_CASES))
def test_dropblock_matches_reference(case, monkeypatch):
    shape, rate, bs, density = DROP_CASES[case]
    r = np.random.default_rng(3)
    x = r.normal(0, 1, shape).astype(np.float32)
    layer = DropBlock2D(rate, bs).train()
    grid, gamma, _ = layer.grid(torch.zeros(shape[0], shape[3], *shape[1:3]))
    seeds = (r.random((grid[0], grid[2], grid[3], 1)) < density).astype(
        np.float32)
    want, ref_gamma = reference_dropblock(x, rate, bs, seeds, monkeypatch)
    assert gamma == ref_gamma
    got = layer(torch.as_tensor(x).permute(0, 3, 1, 2),
                seeds=torch.as_tensor(seeds).permute(0, 3, 1, 2) > 0)
    assert_close(got.permute(0, 2, 3, 1), want)
    if density == 1.0:
        assert not got.any()


def test_dropblock_identity_and_generator():
    """Eval mode and rate 0 pass the map through; in train mode the seeds
    come from the generator (the same seed, the same drop) and without
    one the layer raises."""
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    layer = DropBlock2D(0.2, 5).eval()
    assert layer(x) is x
    assert DropBlock2D(0.0, 5).train()(x) is x
    layer.train()
    with pytest.raises(ValueError, match="generator"):
        layer(x)
    outs = []
    for _ in range(2):
        layer.generator = torch.Generator().manual_seed(4)
        outs.append(layer(x))
    assert torch.equal(outs[0], outs[1])
    assert (outs[0] == 0).any() and not torch.equal(outs[0], x)


def test_train_mode_dropblock_forward_matches_reference(monkeypatch):
    """The training forward (batch statistics) with DropBlock on all
    five stages of the image branch: the reference's five draws, fed to
    the port's layers in order, give the same links, heads and det
    scores."""
    from tests.test_torch_train import make_batch, to_torch

    app = dict(dropblock=True, dropblock_size=3, dropblock_rate=0.2)
    jnet, v = init_flax(dataclasses.replace(tiny_cfg_jax().model, appearance=(
        dataclasses.replace(tiny_cfg_jax().model.appearance, **app))),
        seed=4)
    net = port_net(v, dataclasses.replace(tiny_debug().model, appearance=(
        dataclasses.replace(tiny_debug().model.appearance, **app))))
    b = make_batch(17)
    r = np.random.default_rng(8)
    draws = []

    def bernoulli(key, p, shape):
        draws.append((r.random(shape) < 0.15).astype(np.float32))
        return jnp.asarray(draws[-1])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    ref, _ = jnet.apply(v, {k: jnp.asarray(x) for k, x in b.items()},
                        train=True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(1)})
    monkeypatch.undo()
    assert len(draws) == 5 and all(d.any() for d in draws)
    for i, d in enumerate(draws):
        layer = getattr(net.appear_net, f"dropblock_{i}")
        monkeypatch.setattr(layer, "draw", lambda shape, gamma, device, d=d:
                            torch.as_tensor(d).permute(0, 3, 1, 2) > 0)
    net.train()
    with torch.no_grad():
        out = net(to_torch(b))
    net.eval()
    for k in ("link", "link_norm", "new", "end", "det"):
        assert_close(out[k], np.asarray(ref[k]), err_msg=k)


def test_trainer_seeds_the_dropblock_generator():
    """``create_train_state`` hands every DropBlock layer one generator
    seeded from ``train.seed``: two states of the same seed take the same
    step."""
    from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_
    from mmmot_tpu_torch.train.trainer import create_train_state, train_step

    from tests.test_torch_train import make_batch, to_torch

    cfg = tiny_debug()
    model = dataclasses.replace(cfg.model, appearance=dataclasses.replace(
        cfg.model.appearance, dropblock=True, dropblock_rate=0.3,
        dropblock_size=3))
    after = []
    for _ in range(2):
        net = init_random_(TrackingNet(model, device="cpu"), 2)
        state = create_train_state(net, cfg.train)
        layers = [m for m in net.modules() if isinstance(m, DropBlock2D)]
        assert len(layers) == 5
        assert all(m.generator is state.dropblock_gen for m in layers)
        _, metrics = train_step(state, to_torch(make_batch(3)))
        assert torch.isfinite(metrics["total"])
        after.append(net.state_dict())
    for k in after[0]:
        assert torch.equal(after[0][k], after[1][k]), k


# -- the int8 trunk --------------------------------------------------------

@pytest.fixture(scope="module")
def quant_variant(variants):
    """Per variant: the JAX package's calibration and jitted quant tree
    on 24 crops of the variant's float32 weights (as numpy)."""
    cache = {}

    def get(name):
        if name not in cache:
            _, v, net = variants(name)
            cfg = switch(tiny_cfg_jax().model, name).appearance
            crops = rand_crops(1, 24)
            scales = jq.calibrate_appearance(v, cfg, jnp.asarray(crops))
            quant = jax.jit(lambda v: jq.quantize_appearance(v, cfg, scales))(
                v)
            cache[name] = (scales, to_numpy(quant), v, net, cfg)
        return cache[name]
    return get


@pytest.mark.parametrize("name", ["s2d", "no_bn"])
def test_int8_stages_bit_equal_reference(quant_variant, name):
    """Every int8 stage map, on the JAX tree carried across, equals the
    jitted reference's; with the stem, conv_0 reads the 12-channel
    space-to-depth map (the stem instance) and no pool follows it."""
    _, quant, _, _, cfg = quant_variant(name)
    x = rand_crops(2, 10)
    x[3] = 0.0
    want = jax.jit(lambda q, x: jq.quantized_trunk_stages(q, cfg, x))(
        quant, jnp.asarray(x))
    q = quant_from_flax(quant, DEPTH, s2d_stem=cfg.s2d_stem)
    assert q.cins[0] == (12 if cfg.s2d_stem else 3)
    assert conv_instance(q.cins[0]) == "stem"
    got = pq.quantized_trunk_stages(q, torch.as_tensor(x))
    assert len(got) == len(want) == 5
    for (g, gs), (w, ws) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert gs.item() == float(ws)


def test_int8_conv_plain_at_cin12_matches_numpy():
    """The plain int8 conv at the stem's Cin = 12 (K = 108 padded to
    128) against the numpy int64 reference, bit for bit."""
    r = np.random.default_rng(12)
    x = r.integers(-127, 128, (2, 5, 6, 12)).astype(np.int8)
    w = r.integers(-127, 128, (3, 3, 12, 16)).astype(np.int8)
    m = r.uniform(-2e-4, 4e-4, 16).astype(np.float32)
    b = r.uniform(-20, 60, 16).astype(np.float32)
    wq = pack_weights(torch.as_tensor(w))
    assert tuple(wq.shape) == (16, 128) and not wq[:, 108:].any()
    got = int8_conv3x3_requant_plain(torch.as_tensor(x), wq,
                                     torch.as_tensor(m), torch.as_tensor(b))
    want = numpy_conv_requant(x, w, m, b)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want > 0).mean() < 1


def test_s2d_vgg16_fuses_pools_after_conv_3_6_9_12(monkeypatch):
    """With the stem the space-to-depth replaces the pool after conv_1:
    VGG16's trunk hands conv_3, 6, 9 and 12 to the kernel with the pool
    fused and runs no separate pool; its stage maps equal the unfused
    chain's."""
    r = np.random.default_rng(6)
    chans = [max(8, int(c * 0.0625)) for c in
             (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)]
    layers, cin = [], 12
    for c in chans:
        layers.append({"w": r.integers(-60, 61, (3, 3, cin, c)).astype(
            np.int8), "m": np.full(c, 2e-3, np.float32),
            "b": r.uniform(0, 8, c).astype(np.float32)})
        cin = c
    q = pq.QuantizedAppearance(16, 0.02, layers, [0.1] * 5, s2d_stem=True)
    x = torch.as_tensor(rand_crops(3, 2))
    calls = []
    conv = pq.int8_conv3x3_requant

    def recorded(xq, wq, m, b, pool=False):
        calls.append(pool)
        return conv(xq, wq, m, b, pool=pool)

    def no_pool(xq):
        raise AssertionError("max_pool_int8 ran on a fused path")

    monkeypatch.setattr(pq, "int8_conv3x3_requant", recorded)
    monkeypatch.setattr(pq, "max_pool_int8", no_pool)
    got = pq.quantized_trunk_stages(q, x)
    monkeypatch.undo()
    assert [i for i, p in enumerate(calls) if p] == [3, 6, 9, 12]
    xq = pq.quantize_input(q, x)
    want = []
    for op in q.ops:
        if op[0] == "s2d":
            xq = pq.space_to_depth(xq).contiguous()
        elif op[0] == "conv":
            xq = int8_conv3x3_requant_plain(xq, *q.layer(op[1]))
        elif op[0] == "pool":
            xq = pq.max_pool_int8(xq)
        else:
            want.append(xq)
    assert [tuple(g.shape[1:3]) for g, _ in got] == [
        (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    for (g, _), w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["s2d", "no_bn"])
def test_int8_calibration_and_quantisation_match_reference(quant_variant,
                                                           name):
    """The port's calibration within 1e-5 relative; on the reference's
    scales its int8 weights within one level (the BN fold's rsqrt),
    exactly equal without BatchNorm, and ``m``, ``b`` within 1e-6."""
    scales, quant, _, net, _ = quant_variant(name)
    got = pq.calibrate_appearance(net.appear_net,
                                  torch.as_tensor(rand_crops(1, 24)))
    np.testing.assert_allclose(got, scales, rtol=1e-5)
    mine = pq.quantize_appearance(net.appear_net, scales).to_flax()
    for a, b in zip(mine["layers"], quant["layers"]):
        d = np.abs(a["w"].astype(np.int32) - b["w"].astype(np.int32))
        assert d.max() <= (0 if name == "no_bn" else 1)
        np.testing.assert_allclose(a["m"], b["m"], rtol=1e-6)
        np.testing.assert_allclose(a["b"], b["b"], rtol=1e-6, atol=1e-6)


def test_int8_last_stage_tail_matches_reference(quant_variant):
    """Without skip pooling the int8 image branch reads the last stage
    alone: ``quantized_appearance_apply`` against the reference's."""
    _, quant, v, net, cfg = quant_variant("last_stage")
    crops = rand_crops(9, 7).reshape(1, 7, 32, 32, 3)
    mask = np.array([[1, 1, 0, 1, 1, 1, 0]], bool)
    want = jax.jit(lambda q, c, m: jq.quantized_appearance_apply(
        q, v, cfg, c, m))(quant, jnp.asarray(crops), jnp.asarray(mask))
    got = pq.quantized_appearance_apply(
        quant_from_flax(quant, DEPTH), net.appear_net,
        torch.as_tensor(crops), torch.as_tensor(mask))
    assert net.appear_net.n_picked == 1
    assert_close(got, np.asarray(want))


# -- serving a variant -------------------------------------------------------

@pytest.fixture(scope="module")
def variant_artifact(variants, tmp_path_factory):
    """A port artifact of the s2d net under a name that no preset has."""
    _, _, net = variants("s2d")
    cfg = dataclasses.replace(tiny_debug(), name="tiny_s2d",
                              model=net.cfg)
    out = str(tmp_path_factory.mktemp("variant_artifact"))
    export_serve_step(out, cfg, TrackingModule(net), (H, W), M)
    return out


def test_variant_artifact_serves_as_the_live_step(variants,
                                                  variant_artifact):
    _, _, net = variants("s2d")
    man = json.load(open(os.path.join(variant_artifact, "manifest.json")))
    assert man["config"] == "tiny_s2d"
    assert man["config_dict"]["model"]["appearance"]["s2d_stem"] is True
    frames = scene(21, n_frames=4)
    trk = DeployedTracker.load(variant_artifact, device="cpu")
    assert trk.module.net.cfg == net.cfg
    got = [trk.step(f["image"], f["cloud"], f["boxes"], f["proj"])[0]
           for f in frames]
    assert got == port_steps(TrackingModule(net), frames)[0]


def test_variant_manifest_without_its_config_is_refused(variant_artifact,
                                                        tmp_path):
    """Without ``config_dict`` a non-preset name raises, as before; a
    config that does not describe the stored weights raises too."""
    out = str(tmp_path / "art")
    shutil.copytree(variant_artifact, out)
    path = os.path.join(out, "manifest.json")
    man = json.load(open(path))
    json.dump({k: v for k, v in man.items() if k != "config_dict"},
              open(path, "w"))
    with pytest.raises(ValueError, match="not a preset"):
        DeployedTracker.load(out, device="cpu")
    plain = json.loads(json.dumps(man))
    plain["config_dict"]["model"]["appearance"]["s2d_stem"] = False
    json.dump(plain, open(path, "w"))
    with pytest.raises(ValueError, match="flax shape"):
        DeployedTracker.load(out, device="cpu")
