"""Grouped 3^dim 'same' conv of the MHCT grids.

Counterpart of ``GridConvK`` in ``cloud_transformers_tpu/nn/grouped_conv.py``
with the same dispatch as its ``_pallas_wins``: 3D grids with X >= 16
(32^3 and 16^3 in the classifier) go to the hand-written kernel
(``ops/pallas_grid_conv.py``); 2D grids and small 3D grids go to PyTorch's
grouped ``F.conv2d``/``F.conv3d``, as the JAX package leaves them to XLA.

The kernel branch is a ``torch.autograd.Function`` (the counterpart of
``_grid_conv``'s ``custom_vjp``): the input gradient is the forward kernel
on the cotangent with the transposed weights and a zero bias, the weight
gradient is the ``grid_conv3d_dw`` kernel, and the bias gradient a plain sum
of the cotangent, outside any kernel as in the JAX package.  The library
branch's backward is PyTorch's own.
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.ops.pallas_grid_conv import (
    grid_conv3d,
    grid_conv3d_dw,
    transpose_weight,
)


def kernel_wins(sizes):
    """Grids that go to the CUDA kernel (the JAX package's dispatch)."""
    return len(sizes) == 3 and sizes[0] >= 16


class _GridConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gk, weight, bias, sizes, heads):
        ctx.save_for_backward(gk, weight)
        ctx.sizes, ctx.heads = sizes, heads
        return grid_conv3d(gk, weight, bias, sizes, heads)

    @staticmethod
    def backward(ctx, g):
        gk, weight = ctx.saved_tensors
        sizes, heads = ctx.sizes, ctx.heads
        g = g.contiguous()
        d_gk = grid_conv3d(g, transpose_weight(weight, heads),
                           weight.new_zeros(weight.shape[0]), sizes, heads)
        d_weight = grid_conv3d_dw(gk, g, sizes, heads)
        f = gk.shape[-1]
        d_bias = g.reshape(-1, heads, g.shape[1], f).sum((0, 2)).reshape(-1)
        return d_gk, d_weight, d_bias, None, None


class GridConvK(nn.Module):
    """Grouped 'same' conv + bias on flat grids [R = B*H, G, F].

    ``weight`` [H*F, F, 3, 3(, 3)] (PyTorch's grouped layout, groups = H),
    ``bias`` [H*F]; row r of the grid belongs to head r % H."""

    def __init__(self, feat, heads, sizes):
        super().__init__()
        self.feat, self.heads, self.sizes = feat, heads, tuple(sizes)
        dim = len(sizes)
        self.weight = nn.Parameter(
            torch.zeros((heads * feat, feat) + (3,) * dim))
        self.bias = nn.Parameter(torch.zeros(heads * feat))

    def forward(self, gk):
        if kernel_wins(self.sizes):
            return _GridConv3d.apply(gk, self.weight, self.bias, self.sizes,
                                     self.heads)
        h, f, dim = self.heads, self.feat, len(self.sizes)
        b = gk.shape[0] // h
        x = gk.reshape((b, h) + self.sizes + (f,))
        x = x.movedim(-1, 2).reshape((b, h * f) + self.sizes)
        conv = F.conv2d if dim == 2 else F.conv3d
        out = conv(x, self.weight, self.bias, padding=1, groups=h)
        out = out.reshape((b, h, f) + self.sizes).movedim(2, -1)
        return out.reshape(b * h, -1, f)
