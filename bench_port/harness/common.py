"""What every cell of the benchmark shares: finding a cell and its files
by name, the checks before and after a run, seeded weights, and the
result line."""

from __future__ import annotations

import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent
# Top-level module names that no run may load: the JAX stack and the
# JAX package the port was made from (compared as whole names).
FORBIDDEN = ("jax", "jaxlib", "flax", "mmmot_tpu")
# The mean of every BatchNorm shift: with shifts near 0 the random VGG16
# trunk is chaotic (a 0.4 % input change grows to 7 % at conv_12; 1.4 %
# with this shift), which no trained trunk is.
BN_SHIFT = 1.0


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the program's nvcc libraries already go
    to ``build/mmmot_tpu_torch`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(REPO / "build" / "bench_port" / sub)


def load_cell(name: str, root: Path = REPO) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration
    (``cfg``: the file's contents), traffic mix (``mix``), limits and
    the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cell["cfg"] = json.loads((root / conf["file"]).read_text())
    cell["mix"] = json.loads((BENCH_DIR / "traffic" /
                              f"{cell['traffic']}.json").read_text())
    cell["limits"] = json.loads((BENCH_DIR / "limits" /
                                 f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", (name,))

    cell["end_to_end"] = [m for m in bench["end_to_end"] if mine(m)]
    moves = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"] if mine(m)
                         and ("workloads" in m or m["moves"] in moves)]
    cell["run_seconds"] = bench["run_seconds"]
    return cell


def require_cuda(chips: int) -> None:
    """Exit non-zero, printing no result, without the cards the cell
    asks for."""
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell needs {chips} GPUs, "
                 f"torch.cuda.device_count() = {torch.cuda.device_count()}")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def make_weights(shapes: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 weights from ``seed``, on ``device``, drawn in two calls:
    He-normal kernels (fan-in over all but the output axis), biases and
    running means 0.1 N(0, 1), BatchNorm scales U(0.8, 1.2), running
    variances U(0.5, 1.5), BatchNorm shifts ``BN_SHIFT`` + 0.1 N(0, 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63) ^ 0x5EED)
    total = sum(math.prod(s) for s in shapes.values())
    normal = torch.randn(total, generator=gen, device=device)
    unif = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z, r = normal[at:at + n].view(shape), unif[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) >= 2:
            v = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif leaf == "running_var":
            v = 0.5 + r
        elif leaf == "weight":
            v = 0.8 + 0.4 * r
        else:
            v = 0.1 * z
            if leaf == "bias" and "bn" in name.rsplit(".", 2)[-2]:
                v = v + BN_SHIFT
        out[name] = v.contiguous()
    return out


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(chips)))}


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: Dict[str, tuple],
         breakdown: Optional[dict] = None,
         readings: Optional[dict] = None) -> None:
    """Every reading of the check, then the numbers compared, each beside
    its limit, as the last lines of standard error; then the result as
    the last line of standard output, ``checks`` its last key."""
    for k, v in (readings or {}).items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    print(json.dumps(line), flush=True)


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every reading at or under its limit, and
    finite."""
    checks = {k: (float(readings[k]), float(limits[k])) for k in limits}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks


def read_metrics(cell: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell, from its reader
    ``metrics/<name>.py`` (``read(ctx)``); a reader that finds nothing to
    read returns None and its metric is left out."""
    import importlib.util

    out = {}
    for m in cell["per_layer"]:
        path = BENCH_DIR / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_port_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
