"""Fresh initialization with PyTorch's defaults, from an explicit generator.

Counterpart of ``cloud_transformers_tpu/nn/init.py``: conv/linear weights
and biases ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BatchNorm scale at its
``scale_init`` (0 for the key BN), bias 0, running mean 0 and var 1;
frame rotations ``log_R`` ~ N(0, 1), shifts 0.  Used only when no
weights are loaded.  Draws come from a CPU ``torch.Generator`` in module
order, so a seed gives the same weights on every device.
"""

import torch
from torch import nn

from cloud_transformers_tpu_torch.nn.grouped_conv import GridConvK
from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.transforms import VolTransformer


def _uniform(param, bound, generator):
    with torch.no_grad():
        param.copy_(torch.empty(param.shape).uniform_(
            -bound, bound, generator=generator))


def _fan_in(weight):
    fan = weight.shape[1]
    for k in weight.shape[2:]:
        fan *= k
    return fan


@torch.no_grad()
def init_model_(model, generator):
    """Initialize every parameter and buffer of ``model`` in place."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, GridConvK)):
            bound = _fan_in(m.weight) ** -0.5
            _uniform(m.weight, bound, generator)
            if m.bias is not None:
                _uniform(m.bias, bound, generator)
        elif isinstance(m, BatchNorm):
            m.scale.fill_(m.scale_init)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
        elif isinstance(m, VolTransformer):
            m.log_R.copy_(torch.randn(m.log_R.shape, generator=generator))
            m.shift.zero_()
    return model
