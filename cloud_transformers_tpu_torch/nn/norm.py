"""BatchNorm with the JAX package's state names, in eval mode.

Counterpart of ``cloud_transformers_tpu/nn/norm.py`` (``TorchBatchNorm``):
parameters ``scale``/``bias`` and buffers ``mean``/``var`` (torch's unbiased
running variance), eps 1e-5, normalizing over the channel axis ``dim``
(-1 for the channel-last point tensors, 1 for the channels-first trunks).

Only eval mode (running statistics) is ported in this slice; training mode
raises until the training slice lands.
"""

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, features, scale_init=1.0, eps=1e-5, dim=-1):
        super().__init__()
        self.scale_init = scale_init
        self.eps = eps
        self.dim = dim
        self.scale = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm training mode is not ported yet (eval only)")
        shape = [1] * x.dim()
        shape[self.dim] = -1
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        return (x - self.mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
