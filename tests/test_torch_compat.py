"""The port's copy of the reference-checkpoint tools
(``mmmot_tpu_torch/compat/torch_convert.py``, ``mappings.py``,
``pretrained.py``, ``parity_check.py``) against the JAX package's.

- The name tables on synthetic state dicts with the original mmMOT's key
  spellings (tests/test_parity_harness.py's authored dict, and the
  twins of tests/torch_oracle.py): every port tensor bit-equal to the
  reference's ``torch_to_flax`` carried through ``compat.from_jax``, the
  same report, and the twins' outputs reproduced by the port's modules.
- ``load_pretrained_vgg`` on a small torchvision-style ``vgg11_bn``
  state dict written with ``torch.save``: every loaded tensor equals the
  one written (and the reference's load), the classifier is expected
  unused, and a width mismatch or a checkpoint without a trunk raises;
  ``cli/train --pretrained-vgg`` starts from it.
- Golden files: a file that the reference's ``dump_goldens`` writes holds
  the port's outputs within the fixtures' tolerance; the port's own
  files check exactly, and a perturbed net fails; the ``parity_check``
  CLI on a ``torch.save``'d checkpoint.

    python -m pytest tests/test_torch_compat.py -q
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mmmot_tpu.compat import mappings as jmap
from mmmot_tpu.compat import parity_check as jpc
from mmmot_tpu.compat.pretrained import \
    load_pretrained_vgg as j_load_pretrained_vgg
from mmmot_tpu.compat.torch_convert import torch_to_flax
from mmmot_tpu.config import DataConfig as JDataConfig
from mmmot_tpu.models import model_entry
from mmmot_tpu_torch.compat import mappings as pmap
from mmmot_tpu_torch.compat import parity_check as ppc
from mmmot_tpu_torch.compat.from_jax import _convert, load_flax_variables
from mmmot_tpu_torch.compat.pretrained import load_pretrained_vgg
from mmmot_tpu_torch.compat.torch_convert import torch_to_port
from mmmot_tpu_torch.config import (AffinityConfig, AppearanceConfig,
                                    DataConfig, FusionConfig, ModelConfig,
                                    NewEndConfig, PointConfig, tiny_debug)
from mmmot_tpu_torch.models.tracking_net import TrackingNet, init_random_

from tests import torch_oracle
from tests.test_parity_harness import (_randomize,
                                       build_reference_state_dict,
                                       tiny_cfg, torchvision_style_features)
from tests.torch_port_fixtures import (ATOL, RTOL, assert_close, to_numpy,
                                       torch_one_thread)  # noqa: F401

DEPTH, WM = 11, 0.0625     # tests/test_parity_harness.py's tiny model


def port_tiny_cfg():
    """The port's ``ModelConfig`` of test_parity_harness's ``tiny_cfg``."""
    return ModelConfig(
        appearance=AppearanceConfig(depth=DEPTH, crop_size=(32, 32),
                                    reduction_dim=16, out_dim=32,
                                    width_mult=WM),
        point=PointConfig(point_len=8, channels=(16, 32), out_dim=32),
        fusion=FusionConfig(variant="C", out_dim=32),
        affinity=AffinityConfig(hidden_dim=16),
        new_end=NewEndConfig(hidden_dim=16))


JDATA = JDataConfig(max_dets=4, point_len=8, crop_size=(32, 32))
DATA = DataConfig(max_dets=4, point_len=8, crop_size=(32, 32))


@pytest.fixture(scope="module")
def converted():
    """The authored reference state dict through both packages: the
    reference's flax variables (on its initialised net) and report, and
    the port's state dict and report (on its net)."""
    jcfg = tiny_cfg()
    sd = build_reference_state_dict(jcfg, np.random.default_rng(3))
    jnet = model_entry(jcfg)
    batch = jpc.golden_batch(jcfg, JDATA)
    init = jax.jit(lambda r, b: jnet.init({"params": r}, b, train=False))(
        jax.random.PRNGKey(0), batch)
    jvars, jrep = jpc.convert_reference_checkpoint(sd, jcfg, variables=init)
    net = init_random_(TrackingNet(port_tiny_cfg(), device="cpu"), 1)
    state, rep = ppc.convert_reference_checkpoint(sd, port_tiny_cfg(),
                                                  net=net)
    return sd, jcfg, jvars, jrep, net, state, rep


def test_trackingnet_mapping_bit_equal_reference(converted):
    """Every tensor of the port's conversion equals the reference's
    conversion carried through ``from_jax``, bit for bit; nothing unused,
    nothing missing, no shape error, and the converted names are the
    reference's flax paths joined by dots."""
    sd, _, jvars, jrep, net, state, rep = converted
    via_jax = load_flax_variables(to_numpy(jvars), net)
    assert state.keys() == via_jax.keys()
    for k in state:
        assert torch.equal(state[k], via_jax[k]), k
    assert rep["unused"] == jrep["unused"] == []
    assert rep["missing"] == [] and jrep["missing"] == []
    assert rep["shape_errors"] == jrep["shape_errors"] == []
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}
    want = sorted({".".join(p.split("/")[1:-1] + [leaves[p.split("/")[-1]]])
                   for p in jrep["converted"]})
    assert rep["converted"] == want
    # The mapping itself: the reference's flax paths, dotted.
    jm, jk = jmap.mmmot_trackingnet_mapping(tiny_cfg())
    pm, pk = pmap.mmmot_trackingnet_mapping(port_tiny_cfg())
    assert pm == {k: ".".join(v) for k, v in jm.items()} and pk == jk


def test_report_names_what_does_not_fit(converted):
    """A checkpoint key nothing maps is ``unused``; a tensor of the
    wrong shape is a ``shape_error`` (the net keeps its own there); a
    tensor the checkpoint lacks is ``missing``."""
    sd, *_ = converted
    sd = dict(sd)
    sd["extra.weight"] = torch.zeros(3)
    sd["w_det.1.weight"] = torch.zeros(1, 5)
    del sd["w_det.0.bias"]
    net = init_random_(TrackingNet(port_tiny_cfg(), device="cpu"), 1)
    state, rep = ppc.convert_reference_checkpoint(sd, port_tiny_cfg(),
                                                  net=net)
    assert rep["unused"] == ["extra.weight"]
    assert rep["shape_errors"] == [
        "det_head.dense_1.weight: model (1, 16) vs checkpoint (1, 5)"]
    assert rep["missing"] == ["det_head.dense_0.bias"]
    assert torch.equal(state["det_head.dense_1.weight"],
                       net.state_dict()["det_head.dense_1.weight"])


def test_oracle_twins_through_the_tables():
    """tests/torch_oracle.py's twins (the appearance branch and the
    PointNet in plain torch modules): their state dicts through the port's
    ``torch_to_port`` (bit-equal to ``torch_to_flax`` carried through
    ``from_jax``) give port modules with the twins' outputs."""
    gen = np.random.default_rng(2)
    torch.manual_seed(2)
    vgg = torch_oracle.TorchVGGSkipPool(depth=DEPTH, width_mult=0.125,
                                        reduction_dim=32, out_dim=64).eval()
    pn = torch_oracle.TorchPointNet(channels=(16, 32), out_dim=64).eval()
    for m in (vgg, pn):
        _randomize(m, gen)
    net = init_random_(TrackingNet(tiny_debug().model, device="cpu"), 0)
    own = net.state_dict()
    for twin, mapping, prefix in (
            (vgg, torch_oracle.vgg_mapping(DEPTH), "appear_net"),
            (pn, torch_oracle.pointnet_mapping(2), "point_net")):
        sd = twin.state_dict()
        mapping = {k: (prefix,) + v for k, v in mapping.items()}
        got, unused = torch_to_port(sd, mapping)
        assert unused == []
        params, stats, j_unused = torch_to_flax(sd, mapping)
        assert j_unused == []
        leaves = {"kernel": "weight", "scale": "weight", "bias": "bias"}
        for coll, names in ((params, leaves),
                            (stats, {"mean": "running_mean",
                                     "var": "running_var"})):
            for path, v in jax.tree_util.tree_flatten_with_path(coll)[0]:
                keys = [p.key for p in path]
                name = ".".join(keys[:-1] + [names[keys[-1]]])
                assert torch.equal(got[name], _convert(keys[-1], v)), name
        for k, v in got.items():
            own[k].copy_(v)
    r = np.random.default_rng(4)
    crops = r.normal(0, 1, (5, 32, 32, 3)).astype(np.float32)
    pts = r.normal(0, 1, (5, 16, 4)).astype(np.float32)
    pmask = r.random((5, 16)) < 0.8
    pmask[:, 0] = True
    with torch.no_grad():
        want_img = vgg(torch.as_tensor(crops).permute(0, 3, 1, 2))
        want_pts = pn(torch.as_tensor(pts), torch.as_tensor(pmask))
        got_img = net.appear_net(torch.as_tensor(crops))
        got_pts = net.point_net(torch.as_tensor(pts), torch.as_tensor(pmask),
                                torch.ones(5, dtype=torch.bool))
    assert_close(got_img, want_img)
    assert_close(got_pts, want_pts)


def test_torchvision_vgg_table_matches_reference():
    """vgg16_bn's conv indices, the table as the reference's (dotted),
    and the trunk found by its shapes."""
    pm, pk = pmap.torchvision_vgg_mapping(16)
    jm, jk = jmap.torchvision_vgg_mapping(16)
    assert pm == {k: ".".join(v) for k, v in jm.items()} and pk == jk
    idx = sorted(int(k.split(".")[1]) for k, v in pk.items() if v == "conv")
    assert idx == [0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40]
    sd = {"other.features.0.weight": torch.zeros(64, 3, 3, 3),
          "other.features.1.running_mean": torch.zeros(64),
          "decoy.0.weight": torch.zeros(64, 64, 3, 3)}
    assert pmap.detect_vgg_prefix(sd) == jmap.detect_vgg_prefix(sd) == \
        "other.features"


@pytest.fixture(scope="module")
def vgg_pth(tmp_path_factory):
    """A torchvision-style ``vgg11_bn`` features state dict at
    ``tiny_debug``'s width (0.125), with classifier keys, ``torch.save``d."""
    torch.manual_seed(1)
    feats = torchvision_style_features(DEPTH, 0.125).eval()
    _randomize(feats, np.random.default_rng(5))
    sd = {f"features.{k}": v for k, v in feats.state_dict().items()}
    sd["classifier.0.weight"] = torch.zeros(10, 25088)
    sd["classifier.0.bias"] = torch.zeros(10)
    path = str(tmp_path_factory.mktemp("vgg") / "vgg11_bn.pth")
    torch.save(sd, path)
    return path, sd


def test_load_pretrained_vgg(vgg_pth, tmp_path):
    """Every trunk tensor equals the one written and the reference's
    load carried through ``from_jax``; the rest of the net keeps its
    weights; a wider checkpoint and one without a trunk raise."""
    path, sd = vgg_pth
    net = init_random_(TrackingNet(tiny_debug().model, device="cpu"), 0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    report = load_pretrained_vgg(net, path, depth=DEPTH)
    assert report["unexpected_unused"] == []
    assert len(report["converted"]) == 8 * 6    # 8 convs: 2 + 4 tensors
    after = net.state_dict()
    idx = 0
    for ci in range(8):
        for name, src in (("conv", idx), ("bn", idx + 1)):
            for leaf in (("weight", "bias") if name == "conv" else
                         ("weight", "bias", "running_mean", "running_var")):
                assert torch.equal(
                    after[f"appear_net.backbone.{name}_{ci}.{leaf}"],
                    sd[f"features.{src}.{leaf}"])
        idx += 3 + (ci in (0, 1, 3, 5, 7))       # a pool after the stage
    for k in after:
        if not k.startswith("appear_net.backbone."):
            assert torch.equal(after[k], before[k]), k
    # The reference's load of the same file, carried across.
    from tests.torch_port_fixtures import init_flax, tiny_cfg_jax

    _, v = init_flax(tiny_cfg_jax().model)
    loaded, jrep = j_load_pretrained_vgg(to_numpy(v), path, depth=DEPTH)
    via_jax = load_flax_variables(to_numpy(loaded), net)
    for k in report["converted"]:
        assert torch.equal(after[k], via_jax[k]), k
    assert jrep["unexpected_unused"] == []
    wide = {f"features.{k}": t for k, t in torchvision_style_features(
        DEPTH, 0.25).state_dict().items()}
    torch.save(wide, str(tmp_path / "wide.pth"))
    with pytest.raises(ValueError, match="does not fit"):
        load_pretrained_vgg(net, str(tmp_path / "wide.pth"), depth=DEPTH)
    torch.save({"fc.weight": torch.zeros(2, 2)}, str(tmp_path / "none.pth"))
    with pytest.raises(ValueError, match="no VGG-bn trunk"):
        load_pretrained_vgg(net, str(tmp_path / "none.pth"), depth=DEPTH)


def test_train_cli_pretrained_vgg(vgg_pth, tmp_path, monkeypatch):
    """``cli/train --pretrained-vgg`` copies the trunk in before the
    first step and returns the report."""
    import mmmot_tpu_torch.train.trainer as trainer
    from mmmot_tpu_torch.cli.train import main

    path, sd = vgg_pth
    seen = {}
    step = trainer.train_step

    def first(state, *a, **kw):
        seen.setdefault("conv_0", state.net.state_dict()[
            "appear_net.backbone.conv_0.weight"].clone())
        return step(state, *a, **kw)

    monkeypatch.setattr(trainer, "train_step", first)
    monkeypatch.chdir(tmp_path)
    out = main(["--config", "tiny_debug", "--cpu", "--synthetic",
                "--steps-per-epoch", "1", "--val-every", "10",
                "--val-sequences", "1", "--val-frames", "4",
                "--pretrained-vgg", path])
    assert torch.equal(seen["conv_0"], sd["features.0.weight"])
    assert out["pretrained_vgg"]["unexpected_unused"] == []
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


def test_goldens_across_packages(converted, tmp_path):
    """A golden file of the reference's outputs (``dump_goldens`` on its
    conversion) holds the port's net on the port's conversion within the
    fixtures' tolerance; the port's own file checks exactly and a
    perturbed net fails it; the golden batch is the reference's."""
    _, jcfg, jvars, _, net, state, _ = converted
    jb = jpc.golden_batch(jcfg, JDATA)
    pb = ppc.golden_batch(port_tiny_cfg(), DATA)
    assert pb.keys() == jb.keys()
    for k in pb:
        np.testing.assert_array_equal(pb[k], np.asarray(jb[k]))
    net.load_state_dict(state)
    ref = str(tmp_path / "ref.npz")
    jpc.dump_goldens(jvars, jcfg, JDATA, ref)
    diffs = ppc.check_goldens(net, DATA, ref, atol=ATOL, rtol=RTOL)
    assert set(diffs) == {"link", "link_norm", "new", "end", "det"}
    mine = str(tmp_path / "port.npz")
    ppc.dump_goldens(net, DATA, mine)
    assert max(ppc.check_goldens(net, DATA, mine).values()) == 0.0
    with torch.no_grad():
        net.det_head.dense_1.bias += 1.0
    with pytest.raises(AssertionError, match="golden mismatch"):
        ppc.check_goldens(net, DATA, mine, atol=1e-6)
    with pytest.raises(AssertionError, match="golden mismatch"):
        ppc.check_goldens(net, DATA, ref, atol=ATOL, rtol=RTOL)


def test_parity_check_cli(tmp_path, capsys):
    """``python -m mmmot_tpu_torch.compat.parity_check`` on a saved
    reference checkpoint of ``tiny_debug``'s shapes: every key converted
    (exit 0), goldens dumped and checked; ``--list-keys``."""
    cfg = dataclasses.replace(tiny_cfg(), **{
        "appearance": dataclasses.replace(
            tiny_cfg().appearance, width_mult=0.125, reduction_dim=32,
            out_dim=64),
        "point": dataclasses.replace(tiny_cfg().point, channels=(16, 32),
                                     out_dim=64, point_len=16),
        "fusion": dataclasses.replace(tiny_cfg().fusion, out_dim=64),
        "affinity": dataclasses.replace(tiny_cfg().affinity, hidden_dim=32),
        "new_end": dataclasses.replace(tiny_cfg().new_end, hidden_dim=32)})
    sd = build_reference_state_dict(cfg, np.random.default_rng(7))
    pth = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               pth)
    assert ppc.main(["--pth", pth, "--list-keys"]) == 0
    assert "w_det.1.bias (1,)" in capsys.readouterr().out
    g = str(tmp_path / "g.npz")
    assert ppc.main(["--pth", pth, "--config", "tiny_debug", "--cpu",
                     "--dump-goldens", g]) == 0
    assert ppc.main(["--pth", pth, "--config", "tiny_debug", "--cpu",
                     "--goldens", g]) == 0
    out = capsys.readouterr().out
    assert '"missing": []' in out and '"golden_max_abs_diff"' in out
    with np.load(g) as z:
        assert z["link"].shape == (1, 1, 8, 8)
