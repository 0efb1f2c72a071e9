"""The port imports neither JAX, flax, yaml, PIL nor the JAX package.

A fresh interpreter installs a ``sys.meta_path`` finder that refuses
those names, imports every module of ``mmmot_tpu_torch`` and loads
``chip_smoke.py``, ``auction_rounds.py``, ``int8_ids.py`` and
``affinity_ab.py`` as modules
(without running ``main``); none of the
refused names may reach ``sys.modules``.  The track and train CLIs'
``--help`` and a two-step synthetic training run on the CPU run under
the same finder, as do the serve and export CLIs' ``--help`` (with
``ml_dtypes`` refused too: the artifacts' bfloat16 leaves are read
without it).  The machine with the GPU has
none of them installed, so an import there would fail at start-up.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

GUARD = r"""
import importlib, importlib.util, pkgutil, sys
REFUSED = ("jax", "jaxlib", "flax", "yaml", "PIL", "mmmot_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
"""

WALK = GUARD + r"""
import mmmot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmmot_tpu_torch.__path__,
                                                "mmmot_tpu_torch.")]
for n in names:
    importlib.import_module(n)
for script in ("chip_smoke", "auction_rounds", "int8_ids", "affinity_ab"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(names))
"""


CLI_HELP = GUARD + r"""
import runpy
sys.argv = ["track", "--help"]
try:
    runpy.run_module("mmmot_tpu_torch.cli.track", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""


def test_port_and_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", WALK], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30     # every module was walked


def test_track_cli_help_without_jax():
    proc = subprocess.run([sys.executable, "-c", CLI_HELP], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--batch-sequences" in proc.stdout and "--weights" in proc.stdout


CLI_NOISY = GUARD + r"""
import runpy
sys.argv = ["track", "--config", "full_mmmot_noisy", "--help"]
try:
    runpy.run_module("mmmot_tpu_torch.cli.track", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
from mmmot_tpu_torch import config
from mmmot_tpu_torch.cli.track import PRESETS
cfg = config.full_mmmot_noisy()
assert "full_mmmot_noisy" in PRESETS and "full_mmmot_ydet" in PRESETS
assert cfg.assoc.revival_window == 4 and cfg.data.det_source == "noisy"
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""


def test_track_cli_noisy_preset_without_jax():
    """``--config full_mmmot_noisy --help`` and the preset itself under
    the refusing importer."""
    proc = subprocess.run([sys.executable, "-c", CLI_NOISY], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "full_mmmot_noisy" in proc.stdout


TRAIN_CLI = GUARD + r"""
import runpy
sys.argv = ["train", "--help"]
try:
    runpy.run_module("mmmot_tpu_torch.cli.train", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
from mmmot_tpu_torch.cli.train import main
out = main(["--config", "tiny_debug", "--cpu", "--synthetic",
            "--steps-per-epoch", "1", "--val-sequences", "1",
            "--val-frames", "4"])
assert out["state"].step == 2, out["state"].step
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print("steps", out["state"].step)
"""


def test_train_cli_help_and_synthetic_run_without_jax(tmp_path):
    """``--help``, then ``--cpu --synthetic`` for tiny_debug's two epochs
    of one step each with synthetic validation (checkpoints, results and
    scalars land in the working directory, here a temporary one)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", TRAIN_CLI], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "--load-path" in proc.stdout and "--steps-per-epoch" in proc.stdout
    assert "steps 2" in proc.stdout
    assert (tmp_path / "checkpoints" / "tiny_debug_best").is_dir()
    assert (tmp_path / "runs" / "tiny_debug" / "scalars.jsonl").is_file()


SERVE_EXPORT_HELP = GUARD.replace('"mmmot_tpu")', '"mmmot_tpu", "ml_dtypes")') + r"""
import runpy
for mod in ("mmmot_tpu_torch.cli.serve", "mmmot_tpu_torch.cli.export"):
    sys.argv = [mod, "--help"]
    try:
        runpy.run_module(mod, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
import mmmot_tpu_torch.deploy
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
"""


def test_serve_and_export_cli_help_without_jax_or_ml_dtypes():
    assert '"ml_dtypes")' in SERVE_EXPORT_HELP
    proc = subprocess.run([sys.executable, "-c", SERVE_EXPORT_HELP],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--streams" in proc.stdout and "--exported" in proc.stdout
    assert "--window" in proc.stdout and "--int8" in proc.stdout
