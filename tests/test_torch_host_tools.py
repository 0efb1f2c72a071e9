"""The port's host tools against the JAX package's: ``data/det_convert``
(result files byte-equal on pickles written here, in each accepted
layout), the presets ``tiny_kitti``, ``tiny_long`` and ``tiny_long30``
and the ``configs`` builders ``flagship()`` and ``tiny()`` (field-equal
to the reference's YAML and builders), ``config_to_dict`` /
``config_from_dict``, the meters (``AverageMeter``, ``Timer``,
``ScalarWriter``), and ``utils/profiling`` (``FpsMeter``, ``trace``)
on the CPU.

    python -m pytest tests/test_torch_host_tools.py -q
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from mmmot_tpu.config import load_config


# -- det_convert -----------------------------------------------------------

def pickles(tmp_path):
    """One pickle per accepted layout: frame -> array [n, 4|5], frame ->
    dict (``bbox``/``scores`` with 3D fields, ``boxes``/``score``
    without), and a list indexed by frame with empty and None frames."""
    r = np.random.default_rng(0)

    def boxes(n):
        lt = r.uniform(0, 500, (n, 2))
        return np.concatenate([lt, lt + r.uniform(10, 90, (n, 2))], 1)

    layouts = {
        "arrays": {0: np.concatenate([boxes(3), r.random((3, 1))], 1),
                   2: boxes(2), 5: np.zeros((0, 5))},
        "dicts": {1: {"bbox": boxes(4), "scores": r.random(4),
                      "dimensions": r.uniform(1, 4, (4, 3)),
                      "location": r.uniform(-10, 40, (4, 3)),
                      "rotation_y": r.uniform(-3, 3, 4)},
                  3: {"boxes": boxes(2), "score": [0.9, 0.05]}},
        "list": [np.concatenate([boxes(2), [[0.7], [0.2]]], 1), None,
                 np.zeros((0, 4)), {"bbox": boxes(1)}],
    }
    paths = {}
    for name, data in layouts.items():
        paths[name] = str(tmp_path / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(data, f)
    return paths


@pytest.mark.parametrize("min_score", [0.0, 0.3])
@pytest.mark.parametrize("layout", ["arrays", "dicts", "list"])
def test_det_convert_files_equal_reference(tmp_path, layout, min_score):
    from mmmot_tpu.data.det_convert import \
        convert_detection_pickle as j_convert
    from mmmot_tpu_torch.data.det_convert import (convert_detection_pickle,
                                                  load_detection_pickle)

    src = pickles(tmp_path)[layout]
    ref, got = str(tmp_path / "ref.txt"), str(tmp_path / "port.txt")
    n_ref = j_convert(src, ref, "Car", min_score)
    n = convert_detection_pickle(src, got, "Car", min_score)
    assert n == n_ref > 0
    with open(ref, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    frames = load_detection_pickle(src, "Van", min_score)
    assert sum(map(len, frames.values())) == n
    assert all(o.obj_type == "Van" for f in frames.values() for o in f)


def test_det_convert_cli(tmp_path, capsys):
    from mmmot_tpu.data.det_convert import main as j_main
    from mmmot_tpu_torch.data.det_convert import main

    src = pickles(tmp_path)["dicts"]
    out = str(tmp_path / "out" / "0000.txt")
    assert main([src, out, "--type", "Pedestrian", "--min-score", "0.1"]) \
        == 0
    assert "detections ->" in capsys.readouterr().out
    ref = str(tmp_path / "ref.txt")
    j_main([src, ref, "--type", "Pedestrian", "--min-score", "0.1"])
    assert open(out, "rb").read() == open(ref, "rb").read()


# -- configs ---------------------------------------------------------------

def assert_fields_equal(port, ref, where=""):
    """Every field of the port's dataclass equals the reference's (a
    nested section field by field, a list as a tuple)."""
    for f in dataclasses.fields(port):
        p, r = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(p):
            assert_fields_equal(p, r, f"{where}{f.name}.")
        else:
            assert p == (tuple(r) if isinstance(r, list) else r), \
                where + f.name


@pytest.mark.parametrize("name", ["tiny_kitti", "tiny_long", "tiny_long30"])
def test_tiny_presets_match_yaml(name):
    import mmmot_tpu_torch.config as presets
    from mmmot_tpu_torch.cli.track import PRESETS as TRACK_PRESETS
    from mmmot_tpu_torch.cli.train import PRESETS as TRAIN_PRESETS

    port = getattr(presets, name)()
    assert name in TRACK_PRESETS and name in TRAIN_PRESETS
    assert_fields_equal(port, load_config(f"experiments/{name}/config.yaml"))
    if name == "tiny_long30":
        app = port.model.appearance
        assert (app.depth, app.width_mult, port.train.epochs) == (11, 0.125,
                                                                 30)


BUILDS = {"flagship": {}, "flagship_s2d_112": dict(
    s2d_stem=True, crop=112, max_dets=64, compute_dtype="float32",
    width_mult=0.5, point_len=256), "tiny": {}, "tiny_48": dict(
        crop=48, max_dets=6, point_len=8)}


@pytest.mark.parametrize("build", list(BUILDS))
def test_config_builders_match_reference(build):
    import mmmot_tpu.configs as jconfigs

    import mmmot_tpu_torch.configs as configs

    fn = build.split("_")[0]
    port = getattr(configs, fn)(**BUILDS[build])
    assert_fields_equal(port, getattr(jconfigs, fn)(**BUILDS[build]))


def test_model_sections_carry_every_reference_field():
    import mmmot_tpu.config as jc

    import mmmot_tpu_torch.config as pc

    for cls in ("AppearanceConfig", "ModelConfig"):
        assert ({f.name for f in dataclasses.fields(getattr(pc, cls))}
                == {f.name for f in dataclasses.fields(getattr(jc, cls))})
    with pytest.raises(ValueError, match="arch"):
        pc.AppearanceConfig(arch="resnet")


def test_config_dict_round_trip():
    """``config_to_dict`` through JSON and ``config_from_dict`` give the
    config back; the model section is the reference's
    ``config_to_dict``'s for the fields the port carries; unknown keys and
    failed checks raise."""
    from mmmot_tpu.config import config_to_dict as j_to_dict
    from mmmot_tpu.configs import flagship as j_flagship

    from mmmot_tpu_torch.config import (config_from_dict, config_to_dict,
                                        full_mmmot_lookalike)
    from mmmot_tpu_torch.configs import flagship

    for cfg in (flagship(s2d_stem=True), full_mmmot_lookalike()):
        d = json.loads(json.dumps(config_to_dict(cfg)))
        assert config_from_dict(d) == cfg
    mine = config_to_dict(flagship())["model"]
    ref = j_to_dict(j_flagship())["model"]
    for sect, fields in mine.items():
        if isinstance(fields, dict):
            for k, v in fields.items():
                assert ref[sect][k] == v, (sect, k)
        else:
            assert ref[sect] == fields, sect
    bad = config_to_dict(flagship())
    bad["model"]["appearance"]["colour"] = 1
    with pytest.raises(KeyError, match="colour"):
        config_from_dict(bad)
    odd = config_to_dict(flagship(s2d_stem=True))
    odd["model"]["appearance"]["crop_size"] = [33, 32]
    with pytest.raises(ValueError, match="even crop"):
        config_from_dict(odd)


# -- meters and profiling --------------------------------------------------

def test_meters_match_reference(tmp_path):
    from mmmot_tpu.utils import meters as jm

    from mmmot_tpu_torch.utils import meters as pm

    for window in (0, 3):
        a, b = pm.AverageMeter(window), jm.AverageMeter(window)
        for i, (v, n) in enumerate([(1.0, 1), (4.0, 2), (2.5, 1), (7, 3)]):
            a.update(v, n)
            b.update(v, n)
            assert (a.avg, a.count, a.sum) == (b.avg, b.count, b.sum)
    t = pm.Timer()
    assert t.toc() >= 0.0 and t.meter.count == 1
    rows = []
    for mod, name in ((pm, "port"), (jm, "ref")):
        w = mod.ScalarWriter(str(tmp_path / name / "s.jsonl"))
        w.write(3, {"loss": 1.5, "lr": np.float32(0.25)})
        w.close()
        with open(tmp_path / name / "s.jsonl") as f:
            rows.append([{k: v for k, v in json.loads(line).items()
                          if k != "wall"} for line in f])
    assert rows[0] == rows[1] and len(rows[0]) == 2


def test_fps_meter_leaves_out_the_first_call():
    from mmmot_tpu_torch.utils.profiling import FpsMeter

    meter = FpsMeter()
    for frames in (100, 10, 30):
        with meter.measure(frames):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert meter._meter.count == 2 and meter.fps > 0.0
    assert FpsMeter().fps == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    from mmmot_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "t")) as prof:
        torch.relu(torch.randn(32, 32) @ torch.randn(32, 32))
    path = os.path.join(tmp_path, "t", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in k.key for k in prof.key_averages())


def test_port_never_downloads():
    """No module of the port, and not the smoke, reaches for weights over
    the network (``torch.hub``, ``load_state_dict_from_url``,
    ``urllib``): pretrained weights come from a local file."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    files = sorted((repo / "mmmot_tpu_torch").rglob("*.py"))
    files.append(repo / "chip_smoke.py")
    assert len(files) > 60
    for path in files:
        src = path.read_text()
        for word in ("torch.hub", "load_state_dict_from_url", "urllib",
                     "model_zoo"):
            assert word not in src, (path.name, word)
