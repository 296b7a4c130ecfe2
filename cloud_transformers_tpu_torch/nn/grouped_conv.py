"""Grouped 3^dim 'same' conv of the MHCT grids.

Counterpart of ``GridConvK`` in ``cloud_transformers_tpu/nn/grouped_conv.py``
with the same dispatch as its ``_pallas_wins``: 3D grids with X >= 16
(32^3 and 16^3 in the classifier) go to the hand-written kernel
(``ops/pallas_grid_conv.py``); 2D grids and small 3D grids go to PyTorch's
grouped ``F.conv2d``/``F.conv3d``, as the JAX package leaves them to XLA.
"""

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.ops.pallas_grid_conv import grid_conv3d


def kernel_wins(sizes):
    """Grids that go to the CUDA kernel (the JAX package's dispatch)."""
    return len(sizes) == 3 and sizes[0] >= 16


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
            return grid_conv3d(gk, self.weight, self.bias, self.sizes,
                               self.heads)
        h, f, dim = self.heads, self.feat, len(self.sizes)
        b = gk.shape[0] // h
        x = gk.reshape((b, h) + self.sizes + (f,))
        x = x.movedim(-1, 2).reshape((b, h * f) + self.sizes)
        conv = F.conv2d if dim == 2 else F.conv3d
        out = conv(x, self.weight, self.bias, padding=1, groups=h)
        out = out.reshape((b, h, f) + self.sizes).movedim(2, -1)
        return out.reshape(b * h, -1, f)
