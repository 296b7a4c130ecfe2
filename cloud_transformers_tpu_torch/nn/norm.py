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

Across processes (a ``torch.distributed`` group of more than one rank)
the training statistics are the global batch's, as the JAX package's are
under its 'data' mesh axis (SyncBN): the per-channel sums and counts are
all-reduced, then the sums of squares about the global mean (two passes,
so the variance is JAX's ``mean((x - mean)^2)``), and the running
variance takes the global count in its Bessel factor.  The all-reduces
are autograd Functions whose backward all-reduces the statistics'
cotangents, so the averaged gradients are those of the global batch.
With no such group the path is the single-process one.

Under an ambient points axis (``parallel/mesh.py``, ``n_points > 1``) a
BatchNorm of per-point tensors takes its statistics over the world as
above, every rank's block of every cloud.  One that ``parallel/constrain.
mark_replicated`` marked (``replicated``: the trunks after the pools, the
class vector's) normalises tensors that every points rank of a data row
holds whole, and takes them over the data group: over the world the
row's ``n_points`` copies would each count in the running variance's
Bessel factor.  ``instance_norm_1d`` (and so
``AdaIn1d``) takes each cloud's mean and biased variance over the points
group, in the same two all-reduced passes.

On a CUDA float32 tensor normalised over its last axis, with statistics
that do not span processes, ``BatchNorm`` runs the hand-written kernels of
``ops/batch_norm.py``: one statistics pass and one apply pass forward, a
reduce pass and an apply pass backward, the ReLU that follows a BatchNorm
folded in (``relu=True``).  Every other case (the CPU, other dtypes, the
channels-first trunks, the synced and points-axis statistics) runs the
plain ops below, which the tracer counts as ``bn.plain`` where the tensor
is on the card.

``instance_norm_1d`` normalizes ``[B, P, C]`` over the point axis with the
biased variance, in training and in eval mode alike.  ``AdaIn1d`` follows it
with a per-channel affine from a latent code, ``x * (scale + 1) + bias``
with both halves from one ``Linear(L, 2C)``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.nn import remat
from cloud_transformers_tpu_torch.ops import batch_norm as kernels
from cloud_transformers_tpu_torch.parallel.distributed import (
    AllReduceSum,
    is_distributed,
)
from cloud_transformers_tpu_torch.parallel.mesh import points_mesh
from cloud_transformers_tpu_torch.utils import trace


def _global_stats(x, axes, shape, group=None):
    """(mean, biased variance, count) over ``axes`` of the ``x`` of every
    rank of ``group`` (the world by default), in two all-reduced passes;
    the count is a tensor, so that nothing waits for the device."""
    count = x.new_full((1,), float(x.numel() // x.shape[shape.index(-1)]))
    sums = AllReduceSum.apply(torch.cat([x.sum(axes), count]), group)
    n = sums[-1].detach()
    mean = sums[:-1] / n
    var = AllReduceSum.apply((x - mean.view(shape)).square().sum(axes),
                             group) / n
    return mean, var, n


def _stats_group(replicated):
    """-> (whether the statistics span processes, their group): the world
    across processes, the data group for a replicated tensor under a
    points axis, none in one process."""
    if not is_distributed():
        return False, None
    mesh = points_mesh()
    if replicated and mesh is not None:
        return mesh.n_data > 1, mesh.data_group
    return True, None


def kernel_path(device, dtype, channel_last, spread):
    """Whether a BatchNorm call takes the kernels of ``ops/batch_norm.py``:
    a CUDA float32 tensor normalised over its last axis, with statistics
    that do not span processes."""
    return (device.type == "cuda" and dtype == torch.float32
            and channel_last and not spread)


class _KernelBatchNorm(torch.autograd.Function):
    """``(x - mean) * (rstd * scale) + bias`` (+ ReLU) on the kernels; where
    ``train``, mean and rstd are ``x``'s batch statistics and the backward
    takes their gradient too.  Saves x, mean and rstd (and the
    parameters)."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, rstd, relu, train):
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.relu, ctx.train = relu, train
        return kernels.bn_apply(x, mean, rstd, scale, bias, relu)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        if kernels.rows_of(dy) is None:
            dy = dy.contiguous()
        dx, d_scale, d_bias = kernels.bn_backward(
            x, dy, mean, rstd, scale, bias, ctx.relu, ctx.train)
        return dx, d_scale, d_bias, None, None, None, None


class BatchNorm(nn.Module):
    momentum = 0.1   # weight of the batch statistics in the running ones
    replicated = False   # normalises replicated tensors (a points axis's)

    def __init__(self, features, scale_init=1.0, eps=1e-5, dim=-1):
        super().__init__()
        self.scale_init = scale_init
        self.eps = eps
        self.dim = dim
        self.scale = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, relu=False):
        """The normalised ``x``, then ``F.relu`` where ``relu``."""
        spread, group = (_stats_group(self.replicated) if self.training
                         else (False, None))
        if kernel_path(x.device, x.dtype,
                       self.dim % x.dim() == x.dim() - 1, spread):
            return self._kernels(x, relu)
        if x.is_cuda:
            trace.count("bn.plain")
        return self._plain(x, relu, spread, group)

    def _plain(self, x, relu, spread=False, group=None):
        shape = [1] * x.dim()
        shape[self.dim] = -1
        if self.training:
            axes = [a for a in range(x.dim()) if a != self.dim % x.dim()]
            if spread:
                mean, var, n = _global_stats(x, axes, shape, group)
                bessel = n / (n - 1).clamp_min(1)
            else:
                mean = x.mean(axes)
                var = (x - mean.view(shape)).square().mean(axes)
                n = x.numel() // x.shape[self.dim]
                bessel = n / max(n - 1, 1)
            if not remat.recomputing():
                with torch.no_grad():
                    self.mean.lerp_(mean, self.momentum)
                    self.var.lerp_(var * bessel, self.momentum)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        out = (x - mean.view(shape)) * inv.view(shape) \
            + self.bias.view(shape)
        return F.relu(out) if relu else out

    def _kernels(self, x, relu):
        if kernels.rows_of(x) is None:
            x = x.contiguous()
        if self.training:
            mean, rstd = kernels.bn_stats(
                x.detach(), self.mean, self.var, self.eps, self.momentum,
                not remat.recomputing())
        else:
            mean, rstd = self.mean, torch.rsqrt(self.var + self.eps)
        return _KernelBatchNorm.apply(x, self.scale, self.bias, mean, rstd,
                                      relu, self.training)


def instance_norm_1d(x, eps=1e-5):
    """InstanceNorm over the point axis of ``[B, P, C]``, no parameters;
    under a points axis over each cloud's points on every points rank."""
    mesh = points_mesh()
    if mesh is None:
        mean = x.mean(1, keepdim=True)
        var = x.var(1, unbiased=False, keepdim=True)
    else:
        b, p, _ = x.shape
        sums = AllReduceSum.apply(
            torch.cat([x.sum(1), x.new_full((b, 1), float(p))], -1),
            mesh.points_group)
        n = sums[:, -1:].detach()
        mean = (sums[:, :-1] / n)[:, None]
        var = (AllReduceSum.apply((x - mean).square().sum(1),
                                  mesh.points_group) / n)[:, None]
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
