"""core of the PyTorch port: the point -> grid relation, splat and slice,
the frames' rotations and the completion noise (see the package
docstring).

Exports the JAX package's ``core`` names but ``grid_mapping``: here
``core.grid_mapping`` stays the module (``core.grid_mapping.grid_mapping``
is the function), which the port's modules and tests import as such.
"""

from cloud_transformers_tpu_torch.core.balance import balance_op
from cloud_transformers_tpu_torch.core.coords import (
    bilinear_coords,
    grid_positions,
    trilinear_coords,
)
from cloud_transformers_tpu_torch.core.grid_mapping import GridMapping
from cloud_transformers_tpu_torch.core.noise import (
    partial_postprocess,
    sphere_noise,
)
from cloud_transformers_tpu_torch.core.so3 import so3_exponential_map
from cloud_transformers_tpu_torch.core.splat_slice import (
    gridk_to_spatial,
    slice_grid_mapping,
    slice_grid_mapping_k,
    spatial_to_gridk,
    splat_max_mapping,
    splat_max_mapping_k,
)
from cloud_transformers_tpu_torch.core.vertex_list import (
    slice_grid,
    splat_conv_slice,
    splat_max,
)

__all__ = [
    "balance_op",
    "bilinear_coords",
    "trilinear_coords",
    "grid_positions",
    "so3_exponential_map",
    "splat_max",
    "slice_grid",
    "splat_conv_slice",
    "splat_max_mapping",
    "slice_grid_mapping",
    "splat_max_mapping_k",
    "slice_grid_mapping_k",
    "gridk_to_spatial",
    "spatial_to_gridk",
    "GridMapping",
    "sphere_noise",
    "partial_postprocess",
]
