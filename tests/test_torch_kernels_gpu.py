"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip without
one; they import no JAX, so they run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)

``chip_smoke.py`` runs the same comparison at the classifier's full shapes.
"""

import pytest
import torch

from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
from cloud_transformers_tpu_torch.core.splat_slice import _flatten_mapping
from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc
from cloud_transformers_tpu_torch.ops import pallas_splat as tps


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [(16, 16), (16, 16, 16), (8, 8, 8)])
def test_splat_slice_kernels_match_plain(gen, sizes):
    b, h, k, f = 2, 4, 256, 8
    lat = torch.tanh(torch.randn(b, k, h, len(sizes), generator=gen,
                                 device="cuda"))
    mapping = [a.contiguous() for a in
               _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))]
    values = torch.randn(b * h, k, f, generator=gen, device="cuda")
    values[:, 1::2] = values[:, 0::2]       # exact ties
    values[-1] = -values[-1].abs()          # all-negative row
    n = tps.splat_max.launches
    grid = tps.splat_max(*mapping, values, sizes)
    assert tps.splat_max.launches == n + 1
    assert torch.equal(grid, tps.splat_max_plain(*mapping, values, sizes))
    assert not grid[-1].any()
    out = tps.slice_gather(*mapping, grid, sizes)
    ref = tps.slice_plain(*mapping, grid, sizes)
    assert float((out - ref).abs().max()) <= 1e-6 * max(
        1.0, float(ref.abs().max()))


@pytest.mark.gpu
def test_grid_conv3d_kernel_matches_plain(gen):
    sizes, f, h = (16, 16, 16), 16, 4
    grid = torch.randn(2 * h, 16 ** 3, f, generator=gen, device="cuda")
    weight = torch.randn(h * f, f, 3, 3, 3, generator=gen,
                         device="cuda") * (27 * f) ** -0.5
    bias = torch.randn(h * f, generator=gen, device="cuda")
    n = tgc.grid_conv3d.launches
    out = tgc.grid_conv3d(grid, weight, bias, sizes, h)
    assert tgc.grid_conv3d.launches == n + 1
    ref = tgc.grid_conv3d_plain(grid, weight, bias, sizes, h)
    assert float((out - ref).abs().max()) <= 1e-5 * max(
        1.0, float(ref.abs().max()))


@pytest.mark.gpu
def test_grid_mapping_does_not_wait_for_the_device(gen):
    keys = torch.rand(2, 64, 4, 3, generator=gen, device="cuda") * 2 - 1
    grid_mapping(keys, (16, 16, 16), 3)   # builds the per-device scale
    torch.cuda.set_sync_debug_mode("error")
    try:
        grid_mapping(keys, (16, 16, 16), 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
def test_cuda_wrappers_validate_inputs(gen):
    grid = torch.zeros(4, 64, 4, device="cuda")
    with pytest.raises(ValueError):
        tgc.grid_conv3d(grid, torch.zeros(8, 4, 3, 3, 3), torch.zeros(8),
                        (4, 4, 4), 2)           # weight on the CPU
