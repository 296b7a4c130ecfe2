"""Multi-Headed Cloud Transform blocks.

Counterpart of ``cloud_transformers_tpu/nn/multihead.py`` (``GridKeysValues``,
``head_stats``, ``MultiHead``, ``MultiHeadUnion``, ``MultiHeadPool``).  On
the ``"ops"`` block strategy (the default) splat, grouped conv and slice run
as three kernels, each with its backward kernel; on ``"fused"``
(``nn/grouped_conv.set_block_fusion``) as one kernel, with the same
parameters.  Points are channel-last ``[B, P, C]``; grids are flat
``[B*H, G, F]``.

Per head group: a 1x1 projection predicts per-head key offsets and values;
keys go through a zero-init-scale BatchNorm, a learned per-head frame and
tanh; the values are splatted onto the head's grid, convolved with a grouped
3^dim conv, sliced back, and normalized.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cloud_transformers_tpu_torch.core.grid_mapping import (
    _sizes,
    grid_mapping,
)
from cloud_transformers_tpu_torch.core.splat_slice import (
    gridk_to_spatial,
    slice_grid_mapping_k,
    splat_max_mapping_k,
)
from cloud_transformers_tpu_torch.nn.grouped_conv import (
    GridConvK,
    block_fusion_strategy,
)
from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.transforms import (
    PlaneTransformer,
    VolTransformer,
)


class GridKeysValues(nn.Module):
    """Shared key/value head: 1x1 projection + key/value BN + learned frame
    + tanh -> lattice coords, plus the splat values."""

    def __init__(self, in_dim, in_feature_dim, tensor_dim, heads):
        super().__init__()
        h, f = heads, in_feature_dim
        self.heads = heads
        self.keys_values_pred = nn.Linear(in_dim, h * (f + 3), bias=False)
        self.key_bn = BatchNorm(h * 3, scale_init=0.0)
        self.values_bn = BatchNorm(h * f)
        self.transform = (VolTransformer if tensor_dim == 3
                          else PlaneTransformer)(h)

    def forward(self, x, orig_pcd):
        h = self.heads
        b, p, _ = x.shape
        kv = self.keys_values_pred(x)
        keys_res = self.key_bn(kv[..., :h * 3])
        values = self.values_bn(kv[..., h * 3:])
        keys3 = orig_pcd[:, :, None, :] + keys_res.reshape(b, p, h, 3)
        keys = self.transform(keys3)                     # [B, P, H, dim]
        return torch.tanh(keys), keys, values


@torch.no_grad()
def head_stats(grid, keys, in_feature_dim, heads):
    """Occupancy / key statistics, normalized as the JAX package does:
    occupied-element count over grid.shape[0] * F * H."""
    r = grid.shape[0]
    occ = (grid.abs() > 1e-9).sum() / (r * in_feature_dim * heads)
    return {
        "occupancy": occ.to(torch.float32),
        "key_mean": keys.mean(),
        "key_var": keys.var(unbiased=False),
    }


class MultiHead(nn.Module):
    """One Splat -> grouped 3^dim conv -> Slice unit."""

    def __init__(self, in_dim, in_feature_dim, tensor_size, tensor_dim,
                 heads):
        super().__init__()
        self.feat, self.heads = in_feature_dim, heads
        self.sizes = _sizes(tensor_size, tensor_dim)
        self.kv = GridKeysValues(in_dim, in_feature_dim, tensor_dim, heads)
        self.conv = GridConvK(in_feature_dim, heads, self.sizes)
        self.after_bn = BatchNorm(heads * in_feature_dim)

    def forward(self, x, orig_pcd, pts_mask=None):
        lattice, keys, values = self.kv(x, orig_pcd)
        mapping = grid_mapping(lattice, self.sizes, len(self.sizes))
        if block_fusion_strategy(self.sizes) == "fused":
            out, gk = self.conv.fused(mapping, values, pts_mask=pts_mask)
            stats = head_stats(gk, keys, self.feat, self.heads)
        else:
            gk = splat_max_mapping_k(mapping, values, self.sizes,
                                     pts_mask=pts_mask)
            stats = head_stats(gk, keys, self.feat, self.heads)
            gk2 = self.conv(gk)
            out = slice_grid_mapping_k(mapping, gk2, self.sizes, self.feat,
                                       pts_mask=pts_mask)
        return F.relu(self.after_bn(out)), stats


class MultiHeadUnion(nn.Module):
    """Residual union of parallel MultiHeads on different grids.  The
    classifier keeps the width (the JAX module's ``model_dim_out`` shortcut
    projection is not ported)."""

    def __init__(self, model_dim, features_dims: Sequence[int],
                 tensor_sizes, tensor_dims: Sequence[int],
                 heads: Sequence[int]):
        super().__init__()
        if not (len(features_dims) == len(tensor_sizes)
                == len(tensor_dims) == len(heads)):
            raise ValueError("head-group settings differ in length")
        self.n_groups = len(features_dims)
        for i, (fd, ts, td, hd) in enumerate(zip(
                features_dims, tensor_sizes, tensor_dims, heads)):
            self.add_module(f"attention_{i}", MultiHead(
                model_dim, fd, ts, td, hd))
        self.after_conv = nn.Linear(
            sum(f * h for f, h in zip(features_dims, heads)), model_dim,
            bias=False)
        self.after_bn = BatchNorm(model_dim)

    def forward(self, x, orig_pcd, pts_mask=None):
        results, stats = [], []
        for i in range(self.n_groups):
            r, s = getattr(self, f"attention_{i}")(x, orig_pcd, pts_mask)
            results.append(r)
            stats.append(s)
        gathered = self.after_conv(torch.cat(results, -1))
        return x + F.relu(self.after_bn(gathered)), stats


class MultiHeadPool(nn.Module):
    """Splat-only head: points -> raw per-head grid, channel-last
    ``[B, *spatial, H*F]``."""

    def __init__(self, in_dim, in_feature_dim, tensor_size, tensor_dim,
                 heads):
        super().__init__()
        self.feat, self.heads = in_feature_dim, heads
        self.sizes = _sizes(tensor_size, tensor_dim)
        self.kv = GridKeysValues(in_dim, in_feature_dim, tensor_dim, heads)

    def forward(self, x, orig_pcd, pts_mask=None):
        lattice, keys, values = self.kv(x, orig_pcd)
        mapping = grid_mapping(lattice, self.sizes, len(self.sizes))
        gk = splat_max_mapping_k(mapping, values, self.sizes,
                                 pts_mask=pts_mask)
        stats = head_stats(gk, keys, self.feat, self.heads)
        return gridk_to_spatial(gk, x.shape[0], self.sizes, self.feat), stats
