"""BatchNorm with the JAX package's state names.

Counterpart of ``cloud_transformers_tpu/nn/norm.py`` (``TorchBatchNorm``):
parameters ``scale``/``bias`` and buffers ``mean``/``var`` (torch's unbiased
running variance), eps 1e-5, normalizing over the channel axis ``dim``
(-1 for the channel-last point tensors, 1 for the channels-first trunks).

In training mode it normalizes with the biased variance of the batch, taken
over every axis but the channel axis, and moves ``mean``/``var`` towards the
batch mean and the *unbiased* batch variance (``n / max(n - 1, 1)``) with
momentum 0.1, as ``torch.nn.BatchNorm`` and the JAX package do.  In eval
mode it normalizes with the running statistics.
"""

import torch
from torch import nn


class BatchNorm(nn.Module):
    momentum = 0.1   # weight of the batch statistics in the running ones

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
        shape = [1] * x.dim()
        shape[self.dim] = -1
        if self.training:
            axes = [a for a in range(x.dim()) if a != self.dim % x.dim()]
            mean = x.mean(axes)
            var = (x - mean.view(shape)).square().mean(axes)
            n = x.numel() // x.shape[self.dim]
            with torch.no_grad():
                self.mean.lerp_(mean, self.momentum)
                self.var.lerp_(var * (n / max(n - 1, 1)), self.momentum)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
