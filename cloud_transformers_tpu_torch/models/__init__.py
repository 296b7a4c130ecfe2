"""Model registry of the port (counterpart of
``cloud_transformers_tpu/models/__init__.py``): the ScanObjectNN classifier
with and without per-head scales, the ShapeNet completion inpainter, the
S3DIS segmenters of the 1x1 and the KPConv protocols and the single-view
reconstructor."""

from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}

# the reference's ``model.generator`` paths -> registry names, as in the JAX
# package (a config in the reference schema names its model by path)
_GENERATOR_ALIASES = {
    "./model_zoo/scanobject/classifier.py": "scanobject_classifier",
    "./model_zoo/scanobject/classifier_scales.py":
        "scanobject_classifier_scales",
    "./model_zoo/s3dis/segmenter.py": "s3dis_segmenter",
    "./model_zoo/s3dis/segmenter_pad.py": "s3dis_segmenter_pad",
    "./model_zoo/completion/inpainter.py": "completion_inpainter",
    "./model_zoo/image_reconstruction/reconstructor.py": "image_reconstructor",
}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def available_models():
    """The registered names, sorted."""
    return sorted(_REGISTRY)


def registry_name(name):
    """The registry name of ``name``: a registry name or one of the
    reference's ``generator`` paths (also under ``model_zoo_tpu``)."""
    key = _GENERATOR_ALIASES.get(name, name)
    key = _GENERATOR_ALIASES.get(key.replace("model_zoo_tpu", "model_zoo"),
                                 key)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {available_models()}")
    return key


def get_model(name, **kwargs):
    """Instantiate a registered model with its constructor knobs; ``name``
    as ``registry_name`` takes it."""
    return _REGISTRY[registry_name(name)](**kwargs)


# import for side-effect registration
from cloud_transformers_tpu_torch.models import classifier  # noqa: E402,F401
from cloud_transformers_tpu_torch.models import inpainter  # noqa: E402,F401
from cloud_transformers_tpu_torch.models import (  # noqa: E402,F401
    reconstructor,
)
from cloud_transformers_tpu_torch.models import segmenter  # noqa: E402,F401
