"""Bi/trilinear cell-vertex weights and flat indices: the vertex-list form of
the point -> grid relation.

Counterpart of ``cloud_transformers_tpu/core/coords.py``.  Given continuous
grid coordinates ``u`` in ``[0, size_d - 1]``, each point is a convex
combination of the 2**dim vertices of its cell: vertex s has the weight
``prod_d (frac_d if offset_d else 1 - frac_d)`` and the flat row-major index
of ``floor(u) + offset``.  The vertex order is the reference's spread table:
3D (x, y, z) offsets [000, 100, 010, 110, 001, 101, 011, 111], 2D [00, 10,
01, 11].  ``core/grid_mapping.py`` holds the same relation in the kernels'
form (a base cell and two rows of four weights).
"""

import torch

from cloud_transformers_tpu_torch.core.balance import balance_op
from cloud_transformers_tpu_torch.core.grid_mapping import (
    _EPS,
    _half_extent,
    _sizes,
)

_SPREAD_3D = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
              (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))
_SPREAD_2D = ((0, 0), (1, 0), (0, 1), (1, 1))


def _linear_coords(keys, spread):
    """keys [..., dim] in grid units -> (weights [..., S], integer vertex
    coordinates [..., S, dim] in int64)."""
    floored = torch.floor(keys)
    frac = keys - floored
    o = torch.tensor(spread, device=keys.device)
    w = torch.where(o > 0, frac[..., None, :], 1.0 - frac[..., None, :])
    weights = w[..., 0]
    for d in range(1, w.shape[-1]):
        weights = weights * w[..., d]
    return weights, floored[..., None, :].long() + o


def trilinear_coords(keys):
    """``keys [..., 3]`` -> (weights ``[..., 8]``, vertex coords
    ``[..., 8, 3]``)."""
    return _linear_coords(keys, _SPREAD_3D)


def bilinear_coords(keys):
    """``keys [..., 2]`` -> (weights ``[..., 4]``, vertex coords
    ``[..., 4, 2]``)."""
    return _linear_coords(keys, _SPREAD_2D)


def grid_positions(keys, tensor_size, dim):
    """Normalized keys ``[..., H, dim]`` in [-1, 1] -> (weights
    ``[..., H, S]``, flat_idx ``[..., H, S]``), S = 2**dim.

    The keys are clipped to +-(1 - 1e-7) and rescaled to ``[0, size - 1]``
    by ``balance_op`` (forward ``(keys + 1) * (size - 1) / 2``, backward the
    identity), in the JAX package's float32 order.  ``flat_idx`` is int64
    (the JAX package's is int32), so that it indexes a flat grid directly."""
    sizes = _sizes(tensor_size, dim)
    if keys.shape[-1] != dim:
        raise ValueError(f"keys last dim {keys.shape[-1]} != {dim}")
    keys = torch.clamp(keys, -1.0 + _EPS, 1.0 - _EPS)
    keys_scaled = balance_op(keys + 1.0,
                             _half_extent(sizes, keys.dtype, keys.device))
    if dim == 3:
        weights, vert = trilinear_coords(keys_scaled)
        flat_idx = (vert[..., 0] * (sizes[1] * sizes[2])
                    + vert[..., 1] * sizes[2] + vert[..., 2])
    else:
        weights, vert = bilinear_coords(keys_scaled)
        flat_idx = vert[..., 0] * sizes[1] + vert[..., 1]
    return weights, flat_idx
