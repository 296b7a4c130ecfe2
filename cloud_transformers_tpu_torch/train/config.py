"""YAML experiment configuration, with the JAX package's schema.

Counterpart of ``cloud_transformers_tpu/train/config.py``: sections
``experiment{root, writer_root}``, ``data{...}``, ``model{generator|name,
**kwargs}``, ``train{optimizer{type,..}, scheduler{type,..}, ...}``.  The
same files under ``configs/`` are read as they are.
"""

import copy
import os


def load_config(path):
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f)


def model_from_config(cfg):
    """Build the model named in ``cfg['model']`` with the remaining keys as
    constructor arguments.  The port computes in float32 only, so a
    ``model.mxu_dtype`` other than float32 raises."""
    from cloud_transformers_tpu_torch.models import get_model

    model_cfg = copy.deepcopy(cfg["model"])
    name = model_cfg.pop("generator", None) or model_cfg.pop("name")
    model_cfg.pop("name", None)
    mxu_dtype = model_cfg.pop("mxu_dtype", None)
    if mxu_dtype not in (None, "float32"):
        raise ValueError(f"model.mxu_dtype {mxu_dtype!r}: the port computes "
                         "in float32 only")

    def tuplify(v):
        return tuple(tuplify(x) for x in v) if isinstance(v, list) else v

    return get_model(name, **{k: tuplify(v) for k, v in model_cfg.items()})


def experiment_dirs(cfg, exp_name):
    """Make and return (experiment dir, writer dir) under the config's
    roots."""
    root = cfg["experiment"]["root"]
    writer_root = cfg["experiment"].get("writer_root", root)
    exp_dir = os.path.join(root, exp_name)
    writer_dir = os.path.join(writer_root, exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    os.makedirs(writer_dir, exist_ok=True)
    return exp_dir, writer_dir
