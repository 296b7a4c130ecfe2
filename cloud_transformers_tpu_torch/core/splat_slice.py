"""Splat (rasterization by scatter-max) and Slice (de-rasterization).

Counterpart of the mapping-based ops of
``cloud_transformers_tpu/core/splat_slice.py`` (``splat_max_mapping_k``,
``slice_grid_mapping_k``, ``gridk_to_spatial``, ``spatial_to_gridk``), for
the forward pass.  Where the JAX package keeps grids in the TPU kernel
layout, the port keeps them flat, ``[R = B*H, G, F]`` with cells in
row-major (x, y[, z]) order; the kernels live in ``ops/pallas_splat.py``.

Semantics: the splat is a scatter-max of weight-modulated point features
into a zero grid, so purely negative contributions clamp to 0; the slice
gathers each point's 2**dim cell vertices and takes the weighted sum.
``pts_mask`` (0 = padded point) zeroes a point's features before the splat
and its output after the slice.
"""

from cloud_transformers_tpu_torch.ops.pallas_splat import (
    slice_gather,
    splat_max,
)


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
    return splat_max(*_flatten_mapping(mapping), v, tuple(sizes))


def slice_grid_mapping_k(mapping, gk, sizes, feat, pts_mask=None):
    """Flat grid [B*H, G, F] -> per-point [B, P, H*F]."""
    b, p, h = mapping.x0.shape
    out = slice_gather(*_flatten_mapping(mapping), gk, tuple(sizes))
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
