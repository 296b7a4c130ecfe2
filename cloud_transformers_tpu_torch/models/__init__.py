"""Model registry of the port (counterpart of
``cloud_transformers_tpu/models/__init__.py``).  This slice registers the
ScanObjectNN classifier."""

from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_model(name, **kwargs):
    """Instantiate a registered model with its constructor knobs."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


# import for side-effect registration
from cloud_transformers_tpu_torch.models import classifier  # noqa: E402,F401
