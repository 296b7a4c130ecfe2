"""Splat (rasterization by scatter-max) and Slice (de-rasterization).

Counterpart of the mapping-based ops of
``cloud_transformers_tpu/core/splat_slice.py`` (``splat_max_mapping_k``,
``slice_grid_mapping_k``, ``gridk_to_spatial``, ``spatial_to_gridk``) with
their gradients (``_splat_mk``, ``_slice_mk``).  Where the JAX package keeps
grids in the TPU kernel layout, the port keeps them flat,
``[R = B*H, G, F]`` with cells in row-major (x, y[, z]) order; the kernels
live in ``ops/pallas_splat.py``.

Semantics: the splat is a scatter-max of weight-modulated point features
into a zero grid, so purely negative contributions clamp to 0; the slice
gathers each point's 2**dim cell vertices and takes the weighted sum.
``pts_mask`` (0 = padded point) zeroes a point's features before the splat
and its output after the slice.

Gradients: the splat's cotangent goes to the single lowest-indexed point
that won each (cell, feature), ties included, never split among them; the
slice's goes to the grid by scatter-add and to the vertex weights by a dot
with the grid rows.  Both are ``torch.autograd.Function``s whose backward is
the backward kernel on the card and its plain version on the CPU; the key
gradient then flows on from the vertex weights through ``grid_mapping`` by
ordinary autograd.  The integer base cells get no gradient.
"""

import torch

from cloud_transformers_tpu_torch.ops.pallas_splat import (
    slice_bwd,
    slice_gather,
    splat_max,
    splat_max_bwd,
)


class _SplatMax(torch.autograd.Function):
    """``splat_max`` with the winner-routed backward."""

    @staticmethod
    def forward(ctx, x0, lane0, w_lo, w_hi, values, sizes):
        grid = splat_max(x0, lane0, w_lo, w_hi, values, sizes)
        ctx.save_for_backward(x0, lane0, w_lo, w_hi, values, grid)
        ctx.sizes = sizes
        return grid

    @staticmethod
    def backward(ctx, g):
        d_w_lo, d_w_hi, d_values = splat_max_bwd(
            *ctx.saved_tensors, g.contiguous(), ctx.sizes)
        return None, None, d_w_lo, d_w_hi, d_values, None


class _SliceGather(torch.autograd.Function):
    """``slice_gather`` with the fused (d_grid, d_w) backward."""

    @staticmethod
    def forward(ctx, x0, lane0, w_lo, w_hi, grid, sizes):
        ctx.save_for_backward(x0, lane0, w_lo, w_hi, grid)
        ctx.sizes = sizes
        return slice_gather(x0, lane0, w_lo, w_hi, grid, sizes)

    @staticmethod
    def backward(ctx, g):
        x0, lane0, w_lo, w_hi, grid = ctx.saved_tensors
        d_grid, d_w_lo, d_w_hi = slice_bwd(x0, lane0, w_lo, w_hi,
                                           g.contiguous(), grid, ctx.sizes)
        return None, None, d_w_lo, d_w_hi, d_grid, None


def _flatten_mapping(mapping):
    """[B, P, H(, 4)] arrays -> per-(b*h) rows [R, P(, 4)]."""
    b, p, h = mapping.x0.shape
    return (mapping.x0.transpose(1, 2).reshape(b * h, p),
            mapping.lane0.transpose(1, 2).reshape(b * h, p),
            mapping.w_lo.transpose(1, 2).reshape(b * h, p, 4),
            mapping.w_hi.transpose(1, 2).reshape(b * h, p, 4))


def splat_max_mapping_k(mapping, values, sizes, pts_mask=None):
    """values [B, P, H*F] (channel c = h*F + f) -> flat grid [B*H, G, F]."""
    b, p, h = mapping.x0.shape
    f = values.shape[-1] // h
    v = values.reshape(b, p, h, f)
    if pts_mask is not None:
        v = v * pts_mask[:, :, None, None].to(v.dtype)
    v = v.transpose(1, 2).reshape(b * h, p, f)
    return _SplatMax.apply(*_flatten_mapping(mapping), v, tuple(sizes))


def slice_grid_mapping_k(mapping, gk, sizes, feat, pts_mask=None):
    """Flat grid [B*H, G, F] -> per-point [B, P, H*F]."""
    b, p, h = mapping.x0.shape
    out = _SliceGather.apply(*_flatten_mapping(mapping), gk,
                             tuple(sizes))
    out = out.reshape(b, h, p, feat).transpose(1, 2).reshape(b, p, h * feat)
    if pts_mask is not None:
        out = out * pts_mask[:, :, None].to(out.dtype)
    return out


def gridk_to_spatial(gk, batch, sizes, feat):
    """[B*H, G, F] -> channel-last [B, *sizes, H*F] (c = h*F + f)."""
    h = gk.shape[0] // batch
    g = gk.reshape((batch, h) + tuple(sizes) + (feat,))
    dim = len(sizes)
    g = g.permute(0, *range(2, 2 + dim), 1, 2 + dim)   # [B, *sizes, H, F]
    return g.reshape((batch,) + tuple(sizes) + (h * feat,))


def spatial_to_gridk(gs, heads, sizes, feat):
    """Inverse of ``gridk_to_spatial``: [B, *sizes, H*F] -> [B*H, G, F]."""
    b = gs.shape[0]
    g = gs.reshape(b, -1, heads, feat).transpose(1, 2)
    return g.reshape(b * heads, -1, feat)
