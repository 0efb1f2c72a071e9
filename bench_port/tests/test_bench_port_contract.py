"""The benchmark's files against its contract: BENCHMARK.json's shape,
one file a configuration, traffic mix, limit set and per-layer reader,
found by name; no module of the benchmark loads JAX or the JAX package,
and the reference loads nothing of the program."""

import ast
import importlib.util
import json
import re

import pytest

from bench_port.harness import common

BENCH = json.loads((common.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = common.load_cell(w["name"])
        assert cell["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert "setup_s" in {m["name"] for m in cell["end_to_end"]}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        entry = common.BENCH_DIR / "harness" / f"entry_{cell['mix']['entry']}.py"
        assert entry.exists()
        assert cell["limits"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_declares_what_benchmark_says(m):
    path = common.BENCH_DIR / "metrics" / f"{m['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.SOURCE, mod.UNIT, mod.BETTER, mod.LAYER, mod.MOVES) == (
        m["source"], m["unit"], m["better"], m["layer"], m["moves"])
    assert callable(mod.read)


def test_configs_hold_the_run_configuration():
    files = set()
    for c in BENCH["configs"]:
        raw = json.loads((common.REPO / c["file"]).read_text())
        assert c["file"].startswith("bench_port/") and c["file"] not in files
        files.add(c["file"])
        assert raw["name"] == c["name"] and raw["reduced"] == c["reduced"]
        assert raw["source"] == c["source"]
        assert "model" in raw["config"] and "train" in raw["config"]


def imports_of(path):
    """Top-level module names a source file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(common.BENCH_DIR.rglob("*.py"))
    assert files
    for f in files:
        bad = imports_of(f) & set(common.FORBIDDEN)
        assert not bad, f"{f} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((common.BENCH_DIR / "reference").rglob("*.py")):
        names = imports_of(f)
        assert "mmmot_tpu_torch" not in names, f
        assert not names & set(common.FORBIDDEN), f


def test_forbidden_names_are_whole_names():
    import sys
    sys.modules.setdefault("mmmot_tpu_torch_x", object())
    try:
        assert "mmmot_tpu_torch_x" not in common.forbidden_modules()
    finally:
        del sys.modules["mmmot_tpu_torch_x"]
