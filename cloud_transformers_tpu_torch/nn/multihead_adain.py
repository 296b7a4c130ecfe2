"""AdaIN-conditioned cloud transform blocks (the generative decoder's).

Counterpart of ``cloud_transformers_tpu/nn/multihead_adain.py``
(``MultiHeadAdaIn``, ``MultiHeadUnionAdaIn``), with the block strategies of
``nn/multihead.py`` (``"ops"``: splat, grouped conv and slice as three
kernels; ``"fused"``: one kernel).  The structure of ``nn/multihead.py``,
with every normalization an adaptive instance norm driven by a latent ``z``
and the key offsets multiplied by a learned scalar ``scale`` that starts at
0, so the decoder's keys start at exactly the input geometry.
``train/optim.py`` gives the parameters named ``scale`` a learning rate of
their own (``scale_lr``).  ``scales`` puts learned per-head scales in the
frames, as in ``nn/multihead.py`` (no model sets it), and the remat
regions are those of ``nn/multihead.py``.
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
    slice_grid_mapping_k,
    splat_max_mapping_k,
)
from cloud_transformers_tpu_torch.nn.grouped_conv import (
    GridConvK,
    block_fusion_strategy,
)
from cloud_transformers_tpu_torch.nn import remat
from cloud_transformers_tpu_torch.nn.multihead import head_stats
from cloud_transformers_tpu_torch.nn.norm import AdaIn1d
from cloud_transformers_tpu_torch.nn.precision import MXULinear
from cloud_transformers_tpu_torch.nn.transforms import (
    PlaneTransformer,
    VolTransformer,
)


class MultiHeadAdaIn(nn.Module):
    """Splat -> grouped conv -> Slice with AdaIN everywhere."""

    remat = None   # the remat policy (nn/remat.py), set by the decoder

    def __init__(self, in_dim, latent_dim, in_feature_dim, tensor_size,
                 tensor_dim, heads, scales=False):
        super().__init__()
        h, f = heads, in_feature_dim
        self.feat, self.heads = f, h
        self.sizes = _sizes(tensor_size, tensor_dim)
        self.keys_values_pred = MXULinear(in_dim, h * (f + 3), bias=False)
        self.keys_adain = AdaIn1d(latent_dim, h * 3)
        self.values_adain = AdaIn1d(latent_dim, h * f)
        self.scale = nn.Parameter(torch.zeros(()))
        self.transform = (VolTransformer if tensor_dim == 3
                          else PlaneTransformer)(h, scales)
        self.conv = GridConvK(f, h, self.sizes)
        self.after_adain = AdaIn1d(latent_dim, h * f)

    def forward(self, x, z, orig_pcd):
        out, stats = self.points(x, z, orig_pcd)
        return self.after(out, z), stats

    def points(self, x, z, orig_pcd):
        """-> (the slice output [B, P, H*F] before ``after``, stats)."""
        dense = self.remat in ("point_io", "point_io_grids")
        mapping, keys, values = remat.region(dense, self._keys_values, x, z,
                                             orig_pcd)
        out, gk = remat.region(self.remat == "point_io", self._kernels,
                               mapping, values)
        return out, head_stats(gk, keys, self.feat, self.heads)

    def after(self, out, z):
        return F.relu(self.after_adain(out, z))

    def _keys_values(self, x, z, orig_pcd):
        h = self.heads
        b, p, _ = x.shape
        kv = self.keys_values_pred(x)
        keys_res = self.keys_adain(kv[..., :h * 3], z)
        values = self.values_adain(kv[..., h * 3:], z)
        keys3 = (orig_pcd[:, :, None, :]
                 + self.scale * keys_res.reshape(b, p, h, 3))
        keys = self.transform(keys3)
        mapping = grid_mapping(torch.tanh(keys), self.sizes, len(self.sizes))
        return mapping, keys, values

    def _kernels(self, mapping, values):
        """Splat -> conv -> slice: -> (points out, the splatted grid)."""
        if block_fusion_strategy(self.sizes) == "fused":
            return self.conv.fused(mapping, values)
        gk = splat_max_mapping_k(mapping, values, self.sizes)
        out = slice_grid_mapping_k(mapping, self.conv(gk), self.sizes,
                                   self.feat)
        return out, gk


class MultiHeadUnionAdaIn(nn.Module):
    """Residual union of parallel AdaIN heads on different grids; a
    ``model_dim_out`` other than ``model_dim`` puts a projection and an
    AdaIN on the shortcut."""

    remat = None   # the remat policy (nn/remat.py), set by the decoder

    def __init__(self, model_dim, latent_dim, features_dims: Sequence[int],
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
            self.shortcut_adain = AdaIn1d(latent_dim, out_dim)
        for i, (fd, ts, td, hd) in enumerate(zip(
                features_dims, tensor_sizes, tensor_dims, heads)):
            self.add_module(f"attention_{i}", MultiHeadAdaIn(
                model_dim, latent_dim, fd, ts, td, hd, scales))
        self.after_conv = MXULinear(
            sum(f * h for f, h in zip(features_dims, heads)), out_dim,
            bias=False)
        self.after_adain = AdaIn1d(latent_dim, out_dim)

    def forward(self, x, z, orig_pcd):
        outs, stats = [], []
        for i in range(self.n_groups):
            o, s = getattr(self, f"attention_{i}").points(x, z, orig_pcd)
            outs.append(o)
            stats.append(s)
        dense = self.remat in ("point_io", "point_io_grids")
        return remat.region(dense, self._gather, x, z, *outs), stats

    def _gather(self, x, z, *outs):
        residual = x
        if self.has_shortcut:
            residual = self.shortcut_adain(self.shortcut_conv(x), z)
        gathered = self.after_conv(torch.cat(
            [getattr(self, f"attention_{i}").after(o, z)
             for i, o in enumerate(outs)], -1))
        return residual + F.relu(self.after_adain(gathered, z))
