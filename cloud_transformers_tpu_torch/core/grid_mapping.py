"""GridMapping: the point -> cell-vertex relation.

Counterpart of ``cloud_transformers_tpu/core/grid_mapping.py``:

  x0     [B, P, H]     first-axis base cell
  lane0  [B, P, H]     flattened remaining-axes base (y0, or y0*Z+z0)
  w_lo   [B, P, H, 4]  vertex weights for row x0   (2D: [w00, w01, 0, 0])
  w_hi   [B, P, H, 4]  vertex weights for row x0+1 (3D offsets [0,1,Z,Z+1])
"""

import functools
from typing import NamedTuple, Tuple

import torch

from cloud_transformers_tpu_torch.core.balance import balance_op
from cloud_transformers_tpu_torch.ops.pallas_splat import (
    lane_offsets,
    vertex_decomposition,
    vertex_index_weights,
)

_EPS = 1e-7

__all__ = ["GridMapping", "grid_mapping", "lane_offsets",
           "flat_vertex_indices", "vertex_weights"]


class GridMapping(NamedTuple):
    x0: torch.Tensor
    lane0: torch.Tensor
    w_lo: torch.Tensor
    w_hi: torch.Tensor


def _sizes(tensor_size, dim) -> Tuple[int, ...]:
    if isinstance(tensor_size, int):
        return (tensor_size,) * dim
    if len(tensor_size) != dim:
        raise ValueError(f"tensor_size {tensor_size} is not {dim}D")
    return tuple(tensor_size)


@functools.lru_cache(maxsize=None)
def _half_extent(sizes, dtype, device):
    """(size - 1) / 2 per axis, exact in f32.  Cached per device, read
    only: building it afresh would be a blocking host-to-device copy, which
    makes the host wait for the device once per block."""
    return torch.tensor([(s - 1) * 0.5 for s in sizes], dtype=dtype,
                        device=device)


def grid_mapping(keys, tensor_size, dim):
    """Normalized keys [..., dim] in [-1, 1] -> GridMapping.

    The f32 operation order is the JAX package's: clip to +-(1 - 1e-7),
    then + 1, then * (size - 1) / 2 (gradient-balanced), then floor.  Any
    reordering moves points across cell boundaries."""
    sizes = _sizes(tensor_size, dim)
    if keys.shape[-1] != dim:
        raise ValueError(f"keys last dim {keys.shape[-1]} != {dim}")
    keys = torch.clamp(keys, -1.0 + _EPS, 1.0 - _EPS)
    keys_scaled = balance_op(keys + 1.0,
                             _half_extent(sizes, keys.dtype, keys.device))
    return GridMapping(*vertex_decomposition(keys_scaled, sizes))


def flat_vertex_indices(mapping: GridMapping, sizes):
    """All 8 (2x4) vertex flat indices [..., 8], lo row first; matches
    ``vertex_weights`` order."""
    return vertex_index_weights(*mapping, sizes)[0]


def vertex_weights(mapping: GridMapping):
    """[..., 8] weights matching ``flat_vertex_indices`` order."""
    return torch.cat([mapping.w_lo, mapping.w_hi], -1)
