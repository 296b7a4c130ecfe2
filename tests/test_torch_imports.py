"""The port stands alone: no module of ``cloud_transformers_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax, orbax, the JAX package,
``tools`` or scikit-learn (the card's machine has none): the training
modules (trainer, logger, optimizer, checkpoints, data, tasks, command
lines), the completion path's modules, the S3DIS segmenters' (both
protocols) and the single-view reconstructor's too, and the remat policies
and the reference converters of the scales classifier's slice."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "cloud_transformers_tpu", "tools",
                                    "sklearn"))
mods = [m for m in sys.modules if m.startswith("cloud_transformers_tpu_torch")]
missing = [m for m in ("train.trainer", "train.optim", "train.config",
                       "train_classification", "tasks.classification",
                       "data.scanobjectnn", "data.loader", "data.augment",
                       "utils.metrics", "ops.pallas_emd", "losses.emd",
                       "losses.chamfer", "losses.fscore", "core.noise",
                       "nn.multihead_adain", "models.inpainter",
                       "data.completion", "data.pointcloud_io",
                       "tasks.completion", "train.checkpoint",
                       "train_inpainter", "eval_inpainting",
                       "train.logging", "data.s3dis", "models.segmenter",
                       "tasks.segmentation", "train_segmentation",
                       "nn.resnet", "data.image_point",
                       "models.reconstructor", "tasks.reconstruction",
                       "train_image_reconstruction",
                       "eval_reconstruction_f1", "data.subsample",
                       "data.s3dis_kpconv", "tasks.segmentation_kpconv",
                       "train_segmentation_kpconv",
                       "eval_segmentation_kpconv", "nn.remat",
                       "nn.transforms", "convert", "serve",
                       "models.classifier")
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
    assert int(n) > 54
    assert bad == "[]", bad
