"""The port stands alone: no module of ``cloud_transformers_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, optax, orbax, the JAX package,
``tools`` or scikit-learn (the card's machine has none): the training
modules (trainer, logger, optimizer, checkpoints, data, tasks, command
lines), the completion path's modules, the S3DIS segmenters' (both
protocols) and the single-view reconstructor's too, the remat policies,
the reference converters, the operand policy, the vertex-list core API and
the V2V and UNet blocks, and the parallel layer (its process grid and
the model's points-axis crossings too).

The port's public names are the JAX package's: ``__all__`` of ``core`` (but
``grid_mapping``, which is the port's module of that name) and ``nn`` equal
the JAX lists, and the package exports the JAX package's top-level names,
each as the port's own object."""

import os
import subprocess
import sys
import types

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
                       "models.classifier", "nn.precision", "nn.unet2d",
                       "nn.conv_blocks", "nn.grouped_conv", "core.coords",
                       "core.vertex_list", "core.splat_slice",
                       "parallel", "parallel.distributed",
                       "parallel.point_sharded", "parallel.mesh",
                       "parallel.constrain")
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


def test_public_names_are_the_jax_packages():
    import cloud_transformers_tpu as jct
    import cloud_transformers_tpu.core as jcore
    import cloud_transformers_tpu.nn as jnn
    import cloud_transformers_tpu_torch as tct
    import cloud_transformers_tpu_torch.core as tcore
    import cloud_transformers_tpu_torch.nn as tnn

    # the port's core.grid_mapping is the module, not the function
    assert tcore.__all__ == [n for n in jcore.__all__ if n != "grid_mapping"]
    assert tcore.grid_mapping.grid_mapping.__module__ == \
        "cloud_transformers_tpu_torch.core.grid_mapping"
    assert tnn.__all__ == jnn.__all__
    def public(pkg):   # the names it defines, not its submodules
        return sorted(n for n, v in vars(pkg).items()
                      if not n.startswith("_")
                      and not isinstance(v, types.ModuleType))

    top = public(jct)
    assert len(top) == 7 and public(tct) == top
    for mod, names in ((tcore, tcore.__all__), (tnn, tnn.__all__),
                       (tct, top)):
        for name in names:
            obj = getattr(mod, name)
            assert obj.__module__.startswith("cloud_transformers_tpu_torch."),\
                (name, obj.__module__)
