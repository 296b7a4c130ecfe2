"""PyTorch + CUDA port of cloud_transformers_tpu for one NVIDIA H100.

Mirrors the JAX package's module names and its public API (``core``,
``nn``).  It serves, trains and evaluates the JAX package's six models
(``models.get_model``: the ScanObjectNN classifier with and without
per-head scales, the S3DIS segmenters, the completion inpainter and the
single-view reconstructor) through ``serve.InferenceEngine``, ``train``
and the CLIs.  Its twelve TPU kernels' counterparts (splat, slice, grid
convs, the fused block, the EMD auction) are hand-written CUDA under
``csrc/``, built on first use (``ops/cuda_build.py``), and stay float32;
the dense contractions follow the operand policy of ``nn/precision.py``
(``model.mxu_dtype: bfloat16`` in a config).
"""

__version__ = "0.1.0"

from cloud_transformers_tpu_torch.core import (  # noqa: F401
    balance_op,
    bilinear_coords,
    grid_positions,
    slice_grid,
    so3_exponential_map,
    splat_max,
    trilinear_coords,
)
