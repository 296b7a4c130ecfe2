"""Multi-Headed Cloud Transform blocks.

Counterpart of ``cloud_transformers_tpu/nn/multihead.py`` (``GridKeysValues``,
``head_stats``, ``MultiHead``, ``MultiHeadUnion``, ``MultiHeadPool``).  On
the ``"ops"`` block strategy (the default) splat, grouped conv and slice run
as three kernels, each with its backward kernel; on ``"fused"``
(``nn/grouped_conv.set_block_fusion``) as one kernel, with the same
parameters.  Points are channel-last ``[B, P, C]``; grids are flat
``[B*H, G, F]``.

Per head group: a 1x1 projection predicts per-head key offsets and values;
keys go through a zero-init-scale BatchNorm, a learned per-head frame (with
per-head ``scales`` where asked) and tanh; the values are splatted onto the
head's grid, convolved with a grouped 3^dim conv, sliced back, and
normalized.  A union whose ``model_dim_out`` differs from ``model_dim``
puts a bias-free projection and a BatchNorm on its shortcut.

Under a remat policy (``nn/remat.py``, set by the trunk) a head group's
dense ops before the splat, its kernel chain and the union's dense ops
after the slices are checkpointed regions, as the policy says.

Under a points axis (``parallel/mesh.py``) the splat combines the points
ranks' grids (``core/splat_slice.py``), so the conv and the pool run on the
data row's grids and the slice reads them at the rank's points; the
BatchNorms take the world's statistics (``nn/norm.py``).
"""

from typing import Sequence

import torch
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
from cloud_transformers_tpu_torch.nn import remat
from cloud_transformers_tpu_torch.nn.norm import BatchNorm
from cloud_transformers_tpu_torch.nn.precision import MXULinear
from cloud_transformers_tpu_torch.nn.transforms import (
    PlaneTransformer,
    VolTransformer,
)
from cloud_transformers_tpu_torch.parallel.distributed import all_reduce_
from cloud_transformers_tpu_torch.parallel.mesh import points_mesh


class GridKeysValues(nn.Module):
    """Shared key/value head: 1x1 projection + key/value BN + learned frame
    + tanh -> lattice coords, plus the splat values."""

    def __init__(self, in_dim, in_feature_dim, tensor_dim, heads,
                 scales=False):
        super().__init__()
        h, f = heads, in_feature_dim
        self.heads = heads
        self.keys_values_pred = MXULinear(in_dim, h * (f + 3), bias=False)
        self.key_bn = BatchNorm(h * 3, scale_init=0.0)
        self.values_bn = BatchNorm(h * f)
        self.transform = (VolTransformer if tensor_dim == 3
                          else PlaneTransformer)(h, scales)

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
    occupied-element count over grid.shape[0] * F * H.  Under a points axis
    the grid is the combined one and the key statistics are the whole
    clouds', over the points group (the JAX package's global mean)."""
    r = grid.shape[0]
    occ = (grid.abs() > 1e-9).sum() / (r * in_feature_dim * heads)
    mesh = points_mesh()
    if mesh is None:
        key_mean, key_var = keys.mean(), keys.var(unbiased=False)
    else:
        sums = all_reduce_(torch.stack(
            [keys.sum(), keys.new_tensor(float(keys.numel()))]), "sum",
            mesh.points_group)
        key_mean = sums[0] / sums[1]
        key_var = all_reduce_((keys - key_mean).square().sum(), "sum",
                              mesh.points_group) / sums[1]
    return {
        "occupancy": occ.to(torch.float32),
        "key_mean": key_mean,
        "key_var": key_var,
    }


class MultiHead(nn.Module):
    """One Splat -> grouped 3^dim conv -> Slice unit."""

    remat = None   # the remat policy (nn/remat.py), set by the trunk

    def __init__(self, in_dim, in_feature_dim, tensor_size, tensor_dim,
                 heads, scales=False):
        super().__init__()
        self.feat, self.heads = in_feature_dim, heads
        self.sizes = _sizes(tensor_size, tensor_dim)
        self.kv = GridKeysValues(in_dim, in_feature_dim, tensor_dim, heads,
                                 scales)
        self.conv = GridConvK(in_feature_dim, heads, self.sizes)
        self.after_bn = BatchNorm(heads * in_feature_dim)

    def forward(self, x, orig_pcd, pts_mask=None):
        out, stats = self.points(x, orig_pcd, pts_mask)
        return self.after(out), stats

    def points(self, x, orig_pcd, pts_mask=None):
        """-> (the slice output [B, P, H*F] before ``after``, stats)."""
        dense = self.remat in ("point_io", "point_io_grids")
        mapping, keys, values = remat.region(dense, self._keys_values, x,
                                             orig_pcd)
        out, gk = remat.region(self.remat == "point_io", self._kernels,
                               mapping, values, pts_mask)
        return out, head_stats(gk, keys, self.feat, self.heads)

    def after(self, out):
        return self.after_bn(out, relu=True)

    def _keys_values(self, x, orig_pcd):
        lattice, keys, values = self.kv(x, orig_pcd)
        return grid_mapping(lattice, self.sizes, len(self.sizes)), keys, \
            values

    def _kernels(self, mapping, values, pts_mask):
        """Splat -> conv -> slice: -> (points out, the splatted grid)."""
        if block_fusion_strategy(self.sizes) == "fused":
            return self.conv.fused(mapping, values, pts_mask=pts_mask)
        gk = splat_max_mapping_k(mapping, values, self.sizes,
                                 pts_mask=pts_mask)
        out = slice_grid_mapping_k(mapping, self.conv(gk), self.sizes,
                                   self.feat, pts_mask=pts_mask)
        return out, gk


class MultiHeadUnion(nn.Module):
    """Residual union of parallel MultiHeads on different grids; a
    ``model_dim_out`` other than ``model_dim`` puts a projection and a
    BatchNorm on the shortcut."""

    remat = None   # the remat policy (nn/remat.py), set by the trunk

    def __init__(self, model_dim, features_dims: Sequence[int],
                 tensor_sizes, tensor_dims: Sequence[int],
                 heads: Sequence[int], model_dim_out=None, scales=False):
        super().__init__()
        if not (len(features_dims) == len(tensor_sizes)
                == len(tensor_dims) == len(heads)):
            raise ValueError("head-group settings differ in length")
        out_dim = model_dim if model_dim_out is None else model_dim_out
        self.n_groups = len(features_dims)
        self.has_shortcut = model_dim != out_dim
        if self.has_shortcut:
            self.shortcut_conv = MXULinear(model_dim, out_dim, bias=False)
            self.shortcut_bn = BatchNorm(out_dim)
        for i, (fd, ts, td, hd) in enumerate(zip(
                features_dims, tensor_sizes, tensor_dims, heads)):
            self.add_module(f"attention_{i}", MultiHead(
                model_dim, fd, ts, td, hd, scales))
        self.after_conv = MXULinear(
            sum(f * h for f, h in zip(features_dims, heads)), out_dim,
            bias=False)
        self.after_bn = BatchNorm(out_dim)

    def forward(self, x, orig_pcd, pts_mask=None):
        outs, stats = [], []
        for i in range(self.n_groups):
            o, s = getattr(self, f"attention_{i}").points(x, orig_pcd,
                                                          pts_mask)
            outs.append(o)
            stats.append(s)
        dense = self.remat in ("point_io", "point_io_grids")
        return remat.region(dense, self._gather, x, *outs), stats

    def _gather(self, x, *outs):
        residual = x
        if self.has_shortcut:
            residual = self.shortcut_bn(self.shortcut_conv(x))
        gathered = self.after_conv(torch.cat(
            [getattr(self, f"attention_{i}").after(o)
             for i, o in enumerate(outs)], -1))
        return residual + self.after_bn(gathered, relu=True)


class MultiHeadPool(nn.Module):
    """Splat-only head: points -> raw per-head grid, channel-last
    ``[B, *spatial, H*F]``."""

    def __init__(self, in_dim, in_feature_dim, tensor_size, tensor_dim,
                 heads, scales=False):
        super().__init__()
        self.feat, self.heads = in_feature_dim, heads
        self.sizes = _sizes(tensor_size, tensor_dim)
        self.kv = GridKeysValues(in_dim, in_feature_dim, tensor_dim, heads,
                                 scales)

    def forward(self, x, orig_pcd, pts_mask=None):
        lattice, keys, values = self.kv(x, orig_pcd)
        mapping = grid_mapping(lattice, self.sizes, len(self.sizes))
        gk = splat_max_mapping_k(mapping, values, self.sizes,
                                 pts_mask=pts_mask)
        stats = head_stats(gk, keys, self.feat, self.heads)
        return gridk_to_spatial(gk, x.shape[0], self.sizes, self.feat), stats
