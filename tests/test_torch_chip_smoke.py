"""``chip_smoke.py``'s library yardstick for the slice: one
``F.grid_sample`` call on the re-laid-out grid computes what the slice
computes, here on the CPU at a small size."""

import numpy as np
import pytest
import torch

import chip_smoke
from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
from cloud_transformers_tpu_torch.core.splat_slice import _flatten_mapping
from cloud_transformers_tpu_torch.ops import pallas_splat as ps


@pytest.mark.parametrize("sizes", [(16, 16), (8, 16), (8, 8, 8), (4, 8, 16)])
def test_grid_sample_matches_slice(sizes):
    rng = np.random.RandomState(0)
    b, k, h, f = 2, 64, 3, 5
    lat = torch.from_numpy(np.tanh(
        rng.randn(b, k, h, len(sizes)) * 2).astype(np.float32))
    mapping = _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))
    cells = ps.kernel_grid_dims(sizes)[2]
    grid = torch.from_numpy(rng.randn(b * h, cells, f).astype(np.float32))
    keys = lat.transpose(1, 2).reshape(b * h, k, len(sizes)).clamp(
        -1 + 1e-7, 1 - 1e-7)
    inp, pts = chip_smoke.grid_sample_inputs(grid, keys, sizes)
    got = chip_smoke.grid_sample_slice(inp, pts).reshape(b * h, f, k)
    want = ps.slice_plain(*mapping, grid, sizes)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want.numpy(),
                               atol=chip_smoke.LIB_TOL)
