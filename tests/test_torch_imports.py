"""The port stands alone: no module of ``cloud_transformers_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax, the JAX package or ``tools``:
the training modules (trainer, optimizer, data, task, command line) too."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import cloud_transformers_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "cloud_transformers_tpu", "tools"))
mods = [m for m in sys.modules if m.startswith("cloud_transformers_tpu_torch")]
missing = [m for m in ("train.trainer", "train.optim", "train.config",
                       "train_classification", "tasks.classification",
                       "data.scanobjectnn", "data.loader", "data.augment",
                       "utils.metrics")
           if "cloud_transformers_tpu_torch." + m not in mods]
print(len(mods), bad + missing)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) > 30
    assert bad == "[]", bad
