"""Splat (rasterization by scatter-max) and Slice (de-rasterization).

Counterpart of the mapping-based ops of
``cloud_transformers_tpu/core/splat_slice.py`` (``splat_max_mapping_k``,
``slice_grid_mapping_k``, ``gridk_to_spatial``, ``spatial_to_gridk``) with
their gradients (``_splat_mk``, ``_slice_mk``).  Where the JAX package keeps
grids in the TPU kernel layout, the port keeps them flat,
``[R = B*H, G, F]`` with cells in row-major (x, y[, z]) order; the kernels
live in ``ops/pallas_splat.py``.  The JAX package's spatial-layout forms
``splat_max_mapping``/``slice_grid_mapping`` (grids ``[B, H, G, F]``) are
reshapes around the ``_k`` forms here, so they run the same kernels; the
vertex-list forms are in ``core/vertex_list.py``.

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

``FWD_WINNER`` (off by default, as in the JAX package) makes a splat whose
gradient will be taken record the winner map in its forward
(``splat_max_winner``), so that its backward is the routing pass alone
(``splat_route``); the gradients are bit-equal to the two-pass backward's.
A splat under ``no_grad`` runs the plain ``splat_max`` either way.

Under an ambient points axis (``parallel/mesh.py``) each rank splats its
block of the points and ``splat_max_mapping_k`` combines the local grids
by a max all-reduce over the points group (``parallel/constrain.
combine_max``), whose backward sums the ranks' cotangents of the grid and
hands each cell's to the ranks that hold its maximum; each rank's splat
backward then routes its share to its own winner, the forward-tracked
winner map of ``FWD_WINNER`` included.  The slice reads the combined grid
at the rank's points as it is.  The fused block raises there: its one
launch cannot hold the all-reduce between its splat and its conv.

The fused block (``fused_block_mk``, the JAX package's ``_fused_block_mk``)
runs splat -> grouped conv -> slice in one kernel (``ops/pallas_fused_block``)
and returns the splatted grid beside the points; under a gradient it also
keeps the convolved grid, and its backward composes the slice backward, the
conv's backward kernels and the two-pass splat backward.
"""

import torch

from cloud_transformers_tpu_torch.ops.pallas_fused_block import fused_block
from cloud_transformers_tpu_torch.ops.pallas_grid_conv import grid_conv_vjp
from cloud_transformers_tpu_torch.ops.pallas_splat import (
    slice_bwd,
    slice_gather,
    splat_max,
    splat_max_bwd,
    splat_max_winner,
    splat_route,
)

# the forward-tracked winner map (the JAX package's switch of this name)
FWD_WINNER = False


def _grad_will_be_taken(*tensors):
    """Whether autograd will record an op on ``tensors``.  An autograd
    Function cannot tell from inside its forward: grad mode is off there,
    and ``ctx.needs_input_grad`` reads ``requires_grad``, which is True
    under ``no_grad`` too."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _SplatMax(torch.autograd.Function):
    """``splat_max`` with the winner-routed backward: two passes from the
    grid, or, with ``track_winner``, the routing pass from the winner map
    that the forward recorded."""

    @staticmethod
    def forward(ctx, x0, lane0, w_lo, w_hi, values, sizes,
                track_winner=False):
        ctx.sizes, ctx.routed = sizes, track_winner
        if track_winner:
            grid, winner = splat_max_winner(x0, lane0, w_lo, w_hi, values,
                                            sizes)
            ctx.save_for_backward(x0, lane0, w_lo, w_hi, values, winner)
        else:
            grid = splat_max(x0, lane0, w_lo, w_hi, values, sizes)
            ctx.save_for_backward(x0, lane0, w_lo, w_hi, values, grid)
        return grid

    @staticmethod
    def backward(ctx, g):
        bwd = splat_route if ctx.routed else splat_max_bwd
        d_w_lo, d_w_hi, d_values = bwd(*ctx.saved_tensors, g.contiguous(),
                                       ctx.sizes)
        return None, None, d_w_lo, d_w_hi, d_values, None, None


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
    x0, lane0, w_lo, w_hi = _flatten_mapping(mapping)
    track = FWD_WINNER and _grad_will_be_taken(w_lo, w_hi, v)
    grid = _SplatMax.apply(x0, lane0, w_lo, w_hi, v, tuple(sizes), track)
    # imported here: the parallel package imports this module
    from cloud_transformers_tpu_torch.parallel.constrain import combine_max
    return combine_max(grid)


def slice_grid_mapping_k(mapping, gk, sizes, feat, pts_mask=None):
    """Flat grid [B*H, G, F] -> per-point [B, P, H*F]."""
    b, p, h = mapping.x0.shape
    out = _SliceGather.apply(*_flatten_mapping(mapping), gk,
                             tuple(sizes))
    out = out.reshape(b, h, p, feat).transpose(1, 2).reshape(b, p, h * feat)
    if pts_mask is not None:
        out = out * pts_mask[:, :, None].to(out.dtype)
    return out


def splat_max_mapping(mapping, values, sizes, pts_mask=None):
    """values [B, P, H*F] -> grid [B, H, G, F] (``splat_max_mapping_k``'s
    rows, one per (batch, head))."""
    b, _, h = mapping.x0.shape
    gk = splat_max_mapping_k(mapping, values, sizes, pts_mask)
    return gk.reshape(b, h, gk.shape[1], gk.shape[2])


def slice_grid_mapping(mapping, grid, sizes, pts_mask=None):
    """grid [B, H, G, F] -> [B, P, H*F] (``slice_grid_mapping_k`` on its
    rows)."""
    b, h, g, f = grid.shape
    return slice_grid_mapping_k(mapping, grid.reshape(b * h, g, f), sizes,
                                f, pts_mask)


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


class _FusedBlock(torch.autograd.Function):
    """``fused_block`` -> (pts [R, K, F], gk [R, G, F]).  With ``grad`` the
    kernel also writes the convolved grid, which the slice backward reads;
    the backward is the slice backward, the conv's backward kernels (the
    transposed conv and the weight gradient, whatever the grid-conv
    strategy), the ``gk`` cotangent where there is one, and the two-pass
    splat backward through ``gk`` (``FWD_WINNER`` is not for this block)."""

    @staticmethod
    def forward(ctx, x0, lane0, w_lo, w_hi, values, weight, bias, sizes,
                heads, grad):
        ctx.set_materialize_grads(False)
        ctx.sizes, ctx.heads = sizes, heads
        if not grad:
            return fused_block(x0, lane0, w_lo, w_hi, values, weight, bias,
                               sizes, heads)
        pts, gk, gk2 = fused_block(x0, lane0, w_lo, w_hi, values, weight,
                                   bias, sizes, heads, want_gk2=True)
        ctx.save_for_backward(x0, lane0, w_lo, w_hi, values, weight, gk, gk2)
        return pts, gk

    @staticmethod
    def backward(ctx, d_pts, d_gk_out):
        x0, lane0, w_lo, w_hi, values, weight, gk, gk2 = ctx.saved_tensors
        sizes, heads = ctx.sizes, ctx.heads
        if d_pts is None:
            d_pts = torch.zeros_like(values)
        d_gk2, d_lo_s, d_hi_s = slice_bwd(x0, lane0, w_lo, w_hi,
                                          d_pts.contiguous(), gk2, sizes)
        d_gk, d_weight, d_bias = grid_conv_vjp(gk, weight, d_gk2, sizes,
                                               heads)
        if d_gk_out is not None:
            d_gk = d_gk + d_gk_out
        d_lo_p, d_hi_p, d_values = splat_max_bwd(x0, lane0, w_lo, w_hi,
                                                 values, gk, d_gk, sizes)
        return (None, None, d_lo_s + d_lo_p, d_hi_s + d_hi_p, d_values,
                d_weight, d_bias, None, None, None)


def fused_block_mk(mapping, values, weight, bias, sizes, feat, heads,
                   pts_mask=None):
    """Splat -> grouped conv (``weight`` [H*F, F, 3, 3(, 3)], ``bias``
    [H*F]) -> slice as one kernel: values [B, P, H*F] -> (out [B, P, H*F],
    the splatted grid [B*H, G, F]).  ``pts_mask`` as in
    ``splat_max_mapping_k`` and ``slice_grid_mapping_k``.  Raises under a
    points axis."""
    from cloud_transformers_tpu_torch.parallel.mesh import points_mesh
    if points_mesh() is not None:
        raise ValueError("the fused block (CT_BLOCK_FUSION=fused) cannot "
                         "run under a points axis: its splat's grid must be "
                         "all-reduced before the conv; use the 'ops' block "
                         "strategy")
    b, p, h = mapping.x0.shape
    v = values.reshape(b, p, h, feat)
    if pts_mask is not None:
        v = v * pts_mask[:, :, None, None].to(v.dtype)
    v = v.transpose(1, 2).reshape(b * h, p, feat)
    x0, lane0, w_lo, w_hi = _flatten_mapping(mapping)
    grad = _grad_will_be_taken(w_lo, w_hi, v, weight, bias)
    pts, gk = _FusedBlock.apply(x0, lane0, w_lo, w_hi, v, weight, bias,
                                tuple(sizes), heads, grad)
    out = pts.reshape(b, h, p, feat).transpose(1, 2).reshape(b, p, h * feat)
    if pts_mask is not None:
        out = out * pts_mask[:, :, None].to(out.dtype)
    return out, gk
