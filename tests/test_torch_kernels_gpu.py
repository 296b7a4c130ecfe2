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
from cloud_transformers_tpu_torch.core.splat_slice import (
    _flatten_mapping,
    _SliceGather,
)
from cloud_transformers_tpu_torch.nn.grouped_conv import GridConvK
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


def _close(got, ref, tol):
    err = float((got - ref).abs().max())
    assert err <= tol * max(1.0, float(ref.abs().max())), err


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((16, 16), 8), ((16, 16, 16), 4),
                                     ((8, 8, 8), 32), ((8, 8, 8), 5)])
def test_backward_kernels_match_plain(gen, sizes, f):
    """Ties, an all-negative row, empty cells, and an F that is no power of
    two: the winner map is exact, the gradients agree with the plain
    versions."""
    b, h, k = 2, 4, 256
    lat = torch.tanh(torch.randn(b, k, h, len(sizes), generator=gen,
                                 device="cuda"))
    lat[:, 1::2] = lat[:, 0::2]             # duplicated points
    mapping = [a.contiguous() for a in
               _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))]
    values = torch.randn(b * h, k, f, generator=gen, device="cuda")
    values[:, 1::2] = values[:, 0::2]       # exact ties
    values[-1] = -values[-1].abs()          # all-negative row
    grid = tps.splat_max(*mapping, values, sizes)
    g = torch.randn(grid.shape, generator=gen, device="cuda")
    n = tps.splat_max_bwd.launches
    d_lo, d_hi, d_val, winner = tps.splat_max_bwd(
        *mapping, values, grid, g, sizes, return_winner=True)
    assert tps.splat_max_bwd.launches == n + 1
    assert torch.equal(winner, tps.splat_winner_plain(*mapping, values, grid,
                                                      sizes))
    assert (winner[grid == 0] == tps.NO_WINNER).all()
    p_lo, p_hi, p_val = tps.splat_max_bwd_plain(*mapping, values, grid, g,
                                                sizes)
    assert torch.equal(d_val != 0, p_val != 0)
    for got, ref in ((d_lo, p_lo), (d_hi, p_hi), (d_val, p_val)):
        _close(got, ref, 1e-6)
    assert not d_val[:, 1::2].any() and d_val[:, 0::2].any()
    assert not d_val[-1].any()

    g_pts = torch.randn(b * h, k, f, generator=gen, device="cuda")
    dense = torch.randn(grid.shape, generator=gen, device="cuda")
    n = tps.slice_bwd.launches
    d_grid, d_lo, d_hi = tps.slice_bwd(*mapping, g_pts, dense, sizes)
    assert tps.slice_bwd.launches == n + 1
    p_grid, p_lo, p_hi = tps.slice_bwd_plain(*mapping, g_pts, dense, sizes)
    _close(d_grid, p_grid, 1e-5)            # float atomics: another order
    _close(d_lo, p_lo, 1e-6)
    _close(d_hi, p_hi, 1e-6)
    if len(sizes) == 2:
        assert not d_lo[..., 2:].any() and not d_hi[..., 2:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((16, 16, 16), 16), ((32, 32, 32), 4),
                                     ((6, 5, 7), 3)])
def test_grid_conv3d_dw_kernel_matches_plain(gen, sizes, f):
    h, cells = 4, sizes[0] * sizes[1] * sizes[2]
    grid = torch.randn(2 * h, cells, f, generator=gen, device="cuda")
    g = torch.randn(2 * h, cells, f, generator=gen, device="cuda")
    n = tgc.grid_conv3d_dw.launches
    out = tgc.grid_conv3d_dw(grid, g, sizes, h)
    assert tgc.grid_conv3d_dw.launches == n + 1
    _close(out, tgc.grid_conv3d_dw_plain(grid, g, sizes, h), 1e-5)
    assert torch.equal(out, tgc.grid_conv3d_dw(grid, g, sizes, h))


@pytest.mark.gpu
def test_grid_conv_function_matches_library_backward(gen):
    """GridConvK's kernel branch (forward kernel on transposed weights,
    weight-gradient kernel, summed bias) against autograd through conv3d."""
    sizes, f, h, b = (16, 16, 16), 4, 2, 2
    mod = GridConvK(f, h, sizes).cuda()
    with torch.no_grad():
        mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen,
                                     device="cuda") * (27 * f) ** -0.5)
        mod.bias.copy_(torch.randn(h * f, generator=gen, device="cuda"))
    gk = torch.randn(b * h, 16 ** 3, f, generator=gen,
                     device="cuda").requires_grad_()
    cot = torch.randn(b * h, 16 ** 3, f, generator=gen, device="cuda")
    before = (tgc.grid_conv3d.launches, tgc.grid_conv3d_dw.launches)
    mod(gk).backward(cot)
    assert (tgc.grid_conv3d.launches - before[0],
            tgc.grid_conv3d_dw.launches - before[1]) == (2, 1)
    got = (gk.grad, mod.weight.grad, mod.bias.grad)

    def cf(t):
        return t.reshape(b, h, *sizes, f).movedim(-1, 2).reshape(
            b, h * f, *sizes)
    torch.backends.cudnn.allow_tf32 = False
    x = gk.detach().clone().requires_grad_()
    w = mod.weight.detach().clone().requires_grad_()
    bias = mod.bias.detach().clone().requires_grad_()
    (torch.nn.functional.conv3d(cf(x), w, bias, padding=1, groups=h)
     * cf(cot)).sum().backward()
    for a, ref in zip(got, (x.grad, w.grad, bias.grad)):
        _close(a, ref, 1e-5)


@pytest.mark.gpu
def test_slice_function_finite_differences(gen):
    """Central differences in float32 through the slice Function on the
    card, for the grid and for the vertex weights: loose tolerance, the
    function being linear in each."""
    sizes, r, k, f = (8, 8, 8), 2, 16, 4
    lat = torch.tanh(torch.randn(1, k, r, 3, generator=gen, device="cuda"))
    x0, lane0, w_lo, w_hi = [a.contiguous() for a in _flatten_mapping(
        grid_mapping(lat, sizes, 3))]
    grid = torch.randn(r, 512, f, generator=gen, device="cuda")
    cot = torch.randn(r, k, f, generator=gen, device="cuda")

    def fn(w_lo, w_hi, grid):
        return float((_SliceGather.apply(x0, lane0, w_lo, w_hi, grid, sizes)
                      .double() * cot).sum())

    args = [t.clone().requires_grad_() for t in (w_lo, w_hi, grid)]
    _SliceGather.apply(x0, lane0, *args, sizes).backward(cot)
    eps = 1e-2
    for i, t in enumerate(args):
        flat = t.detach().reshape(-1)
        for j in torch.randint(0, flat.numel(), (8,), generator=gen,
                               device="cuda").tolist():
            moved = []
            for sign in (1, -1):
                probe = flat.clone()
                probe[j] += sign * eps
                a = [x.detach() for x in args]
                a[i] = probe.reshape(t.shape)
                moved.append(fn(*a))
            fd = (moved[0] - moved[1]) / (2 * eps)
            an = float(t.grad.reshape(-1)[j])
            assert abs(fd - an) <= 1e-2 * max(1.0, abs(an)), (i, j, fd, an)


@pytest.mark.gpu
def test_backward_raises_on_the_card_instead_of_falling_back(gen):
    """A CUDA tensor the kernel does not take raises; nothing reaches the
    plain version."""
    grid = torch.zeros(4, 64, 4, device="cuda")
    with pytest.raises(ValueError):
        tgc.grid_conv3d_dw(grid, grid.double(), (4, 4, 4), 2)
    wide = torch.zeros(2, 8, 22, device="cuda")
    with pytest.raises(ValueError):
        tgc.grid_conv3d_dw(wide, wide, (2, 2, 2), 2)     # F > 21


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
