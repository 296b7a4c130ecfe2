"""Learned per-head coordinate frames (shift + SO(3) rotation).

Counterpart of ``cloud_transformers_tpu/nn/transforms.py``.  Clouds are
channel-last ``[B, P, H, 3]``; the per-head scales of the JAX
``scales=True`` variant are not ported.  The rotation applies R transposed
(``out[..., n] = sum_c (pcd + shift)[..., c] * R[h, c, n]``).
"""

import torch
from torch import nn

from cloud_transformers_tpu_torch.core.so3 import so3_exponential_map


class VolTransformer(nn.Module):
    """3D frame: ``R^T (pcd + shift)`` per head."""

    out_dims = 3

    def __init__(self, heads):
        super().__init__()
        self.log_R = nn.Parameter(torch.zeros(heads, 3))
        self.shift = nn.Parameter(torch.zeros(heads, 3))

    def forward(self, pcd):  # [B, P, H, 3] -> [B, P, H, out_dims]
        rot = so3_exponential_map(self.log_R)             # [H, 3, 3]
        out = torch.einsum("bphc,hcn->bphn", pcd + self.shift, rot)
        return out[..., :self.out_dims]


class PlaneTransformer(VolTransformer):
    """2D frame: rotate in 3D, keep xy."""

    out_dims = 2
