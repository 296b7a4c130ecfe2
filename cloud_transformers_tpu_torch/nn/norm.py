"""BatchNorm with the JAX package's state names, instance norm and AdaIN.

Counterpart of ``cloud_transformers_tpu/nn/norm.py``.  ``BatchNorm``
(``TorchBatchNorm`` there):
parameters ``scale``/``bias`` and buffers ``mean``/``var`` (torch's unbiased
running variance), eps 1e-5, normalizing over the channel axis ``dim``
(-1 for the channel-last point tensors, 1 for the channels-first trunks).

In training mode it normalizes with the biased variance of the batch, taken
over every axis but the channel axis, and moves ``mean``/``var`` towards the
batch mean and the *unbiased* batch variance (``n / max(n - 1, 1)``) with
momentum 0.1, as ``torch.nn.BatchNorm`` and the JAX package do, once a
step: not again while a checkpointed region is recomputed
(``nn/remat.py``).  In eval mode it normalizes with the running
statistics.

``instance_norm_1d`` normalizes ``[B, P, C]`` over the point axis with the
biased variance, in training and in eval mode alike.  ``AdaIn1d`` follows it
with a per-channel affine from a latent code, ``x * (scale + 1) + bias``
with both halves from one ``Linear(L, 2C)``.
"""

import torch
from torch import nn

from cloud_transformers_tpu_torch.nn import remat


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
            if not remat.recomputing():
                with torch.no_grad():
                    self.mean.lerp_(mean, self.momentum)
                    self.var.lerp_(var * (n / max(n - 1, 1)),
                                   self.momentum)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)


def instance_norm_1d(x, eps=1e-5):
    """InstanceNorm over the point axis of ``[B, P, C]``, no parameters."""
    mean = x.mean(1, keepdim=True)
    var = x.var(1, unbiased=False, keepdim=True)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps))


class AdaIn1d(nn.Module):
    """Adaptive instance norm: ``AdaIn1d(L, C)(x [B, P, C], z [B, L])``."""

    def __init__(self, latent_dim, features):
        super().__init__()
        self.features = features
        self.dense = nn.Linear(latent_dim, 2 * features)

    def forward(self, x, z):
        var_bias = self.dense(z)
        scale = var_bias[:, :self.features]
        bias = var_bias[:, self.features:]
        return instance_norm_1d(x) * (scale[:, None, :] + 1.0) \
            + bias[:, None, :]
