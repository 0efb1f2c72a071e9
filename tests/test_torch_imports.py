"""The port imports neither JAX, flax, yaml, PIL nor the JAX package.

A fresh interpreter installs a ``sys.meta_path`` finder that refuses
those names, imports every module of ``mmmot_tpu_torch`` and loads
``chip_smoke.py`` as a module (without running ``main``); none of the
refused names may reach ``sys.modules``.  The machine with the GPU has
none of them installed, so an import there would fail at start-up.
"""

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
import mmmot_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmmot_tpu_torch.__path__,
                                                "mmmot_tpu_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(names))
"""


def test_port_and_smoke_import_without_jax():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20     # every module was walked
