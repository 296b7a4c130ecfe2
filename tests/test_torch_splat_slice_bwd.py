"""Port parity: the splat and slice backward against the JAX package.

The same numpy inputs go through the JAX Pallas backward kernels (interpret
mode, as the JAX tests run them on the CPU), the JAX portable backward, and
the port's plain versions, which its wrappers and autograd Functions take
for CPU tensors.  The splat's routing must be the same single lowest-indexed
winner (exact ties included) with values within 1e-6; the slice's d_grid
agrees within 1e-5 (another order of summation) and d_w within 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.ops.pallas_splat import (
    kernel_to_flat,
    pallas_slice_bwd,
    pallas_splat_bwd,
)
from cloud_transformers_tpu_torch.core import grid_mapping as tgm
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.ops import pallas_splat as tps

jgm = importlib.import_module("cloud_transformers_tpu.core.grid_mapping")
jss = importlib.import_module("cloud_transformers_tpu.core.splat_slice")

SIZES = [(16, 16), (16, 16, 16), (8, 8, 8)]


def _inputs(sizes, r=4, k=64, f=4, seed=0):
    """Kernel inputs with exact ties (every odd point duplicates its even
    neighbour), one all-negative row, and (k being small) empty cells."""
    rs = np.random.RandomState(seed)
    scaled = np.stack([rs.uniform(0, s - 1.001, (r, k)) for s in sizes],
                      -1).astype(np.float32)
    scaled[:, 1::2] = scaled[:, 0::2]
    x0, lane0, w_lo, w_hi = tps.vertex_decomposition(
        torch.from_numpy(scaled), sizes)
    values = rs.randn(r, k, f).astype(np.float32)
    values[:, 1::2] = values[:, 0::2]
    values[-1] = -np.abs(values[-1])
    return [x0, lane0, w_lo, w_hi, torch.from_numpy(values)]


def _j(tensors):
    return [jnp.asarray(t.numpy()) for t in tensors]


def _cot(shape, seed):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


@pytest.mark.parametrize("sizes", SIZES)
def test_splat_bwd_plain_matches_jax(sizes):
    args = _inputs(sizes)
    f = args[-1].shape[-1]
    grid = tps.splat_max(*args, sizes)
    g = _cot(grid.shape, 1)
    got = tps.splat_max_bwd(*args, grid, g, sizes)
    assert tps.splat_max_bwd.launches == 0       # CPU: the plain version
    refs = {
        "pallas": pallas_splat_bwd(*_j(args + [grid, g]), sizes, f,
                                   interpret=True),
        "portable": jss._splat_m_bwd_portable(sizes, *_j(args + [grid, g])),
    }
    for name, ref in refs.items():
        for what, a, b in zip(("d_w_lo", "d_w_hi", "d_values"), got, ref):
            b = np.asarray(b)
            # the same contributions are routed: the same nonzero pattern
            np.testing.assert_array_equal(a.numpy() != 0, b != 0,
                                          err_msg=f"{name} {what}")
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                       err_msg=f"{name} {what}")
    d_values = got[2].numpy()
    assert np.abs(d_values[:, 0::2]).max() > 0
    # exact ties: the odd twin never wins, so it gets nothing at all
    assert not d_values[:, 1::2].any()
    assert not got[0].numpy()[:, 1::2].any()
    # the all-negative row left a zero grid: nothing won there
    assert not d_values[-1].any()


@pytest.mark.parametrize("sizes", SIZES)
def test_winner_map_sentinel_and_point_zero(sizes):
    """Point 0 is a valid winner, and a cell nobody won holds a sentinel
    that is no point index, so its cotangent goes nowhere."""
    args = _inputs(sizes, seed=2)
    k = args[0].shape[1]
    grid = tps.splat_max(*args, sizes)
    winner = tps.splat_winner_plain(*args, grid, sizes)
    assert winner.dtype == torch.int32
    assert (winner == 0).any()
    empty = grid == 0
    assert empty.any()
    assert (winner[empty] == tps.NO_WINNER).all() and tps.NO_WINNER >= k
    assert (winner[~empty] < k).all()
    # a cotangent that lives only on the empty cells gives exactly zero
    g = _cot(grid.shape, 3) * empty
    for d in tps.splat_max_bwd(*args, grid, g, sizes):
        assert not d.any()
    # and what is routed adds up: every won (cell, feature) hands its
    # cotangent to exactly one contribution
    g = _cot(grid.shape, 4)
    d_w_lo, d_w_hi, d_values = tps.splat_max_bwd_plain(*args, grid, g, sizes)
    w = torch.cat([args[2], args[3]], -1)
    values = args[4]
    # sum_k d_values . values == sum over won cells of g * grid
    lhs = float((d_values * values).sum())
    rhs = float((g * grid)[~empty].sum())
    assert abs(lhs - rhs) <= 1e-4 * max(1.0, abs(rhs))
    lhs_w = float((torch.cat([d_w_lo, d_w_hi], -1) * w).sum())
    assert abs(lhs_w - rhs) <= 1e-4 * max(1.0, abs(rhs))


@pytest.mark.parametrize("sizes", SIZES)
def test_slice_bwd_plain_matches_jax(sizes):
    args = _inputs(sizes, seed=5)
    mapping, f = args[:4], args[-1].shape[-1]
    r, k = args[0].shape
    grid = _cot((r, int(np.prod(sizes)), f), 6)
    g_pts = _cot((r, k, f), 7)
    d_grid, d_w_lo, d_w_hi = tps.slice_bwd(*mapping, g_pts, grid, sizes)
    assert tps.slice_bwd.launches == 0
    j_grid, j_lo, j_hi = pallas_slice_bwd(*_j(mapping + [g_pts, grid]),
                                          sizes, f, interpret=True)
    np.testing.assert_allclose(d_grid.numpy(), np.asarray(j_grid), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(d_w_lo.numpy(), np.asarray(j_lo), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(d_w_hi.numpy(), np.asarray(j_hi), rtol=0,
                               atol=1e-6)
    assert np.abs(d_w_lo.numpy()[..., :2]).max() > 0
    if len(sizes) == 2:                          # constants, not vertices
        assert not d_w_lo[..., 2:].any() and not d_w_hi[..., 2:].any()


@pytest.mark.parametrize("sizes", [(16, 16), (8, 8, 8)])
def test_functions_match_jax_grad(sizes):
    """Gradients for the keys and values through grid_mapping -> splat ->
    slice with a pts_mask, against jax.grad of the JAX package's ops."""
    dim, b, p, h, f = len(sizes), 2, 40, 3, 4
    rs = np.random.RandomState(8)
    keys = rs.uniform(-1, 1, (b, p, h, dim)).astype(np.float32)
    values = rs.randn(b, p, h * f).astype(np.float32)
    values[:, 1::2] = values[:, 0::2]            # exact ties
    keys[:, 1::2] = keys[:, 0::2]
    mask = (rs.uniform(size=(b, p)) > 0.3).astype(np.float32)
    cot = rs.randn(b, p, h * f).astype(np.float32)
    cells = int(np.prod(sizes))
    cot_grid = rs.randn(b * h, cells, f).astype(np.float32)

    def j_loss(keys, values):
        m = jgm.grid_mapping(keys, sizes, dim)
        gk = jss.splat_max_mapping_k(m, values, sizes,
                                     pts_mask=jnp.asarray(mask))
        out = jss.slice_grid_mapping_k(m, gk, sizes, f,
                                       pts_mask=jnp.asarray(mask))
        return (jnp.sum(out * cot)
                + jnp.sum(kernel_to_flat(gk, sizes, f) * cot_grid))

    j_dk, j_dv = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(keys),
                                                  jnp.asarray(values))

    tk = torch.from_numpy(keys).requires_grad_()
    tv = torch.from_numpy(values).requires_grad_()
    m = tgm.grid_mapping(tk, sizes, dim)
    gk = tss.splat_max_mapping_k(m, tv, sizes, pts_mask=torch.from_numpy(mask))
    out = tss.slice_grid_mapping_k(m, gk, sizes, f,
                                   pts_mask=torch.from_numpy(mask))
    ((out * torch.from_numpy(cot)).sum()
     + (gk * torch.from_numpy(cot_grid)).sum()).backward()

    for got, ref in ((tk.grad, j_dk), (tv.grad, j_dv)):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale)
    assert np.abs(tk.grad.numpy()).max() > 0
    assert not tv.grad.numpy()[mask == 0].any()  # masked points get nothing


def test_ties_do_not_split_the_gradient():
    """torch's own backward of scatter_reduce 'amax' shares the gradient
    among tied contributions; the splat's Function gives all of it to the
    lowest-indexed one."""
    sizes = (8, 8, 8)
    x0, lane0, w_lo, w_hi, values = _inputs(sizes, r=2, k=16, seed=9)
    values = values.abs()                        # every row has winners
    g = _cot((2, 512, values.shape[-1]), 10)

    v1 = values.clone().requires_grad_()
    tss._SplatMax.apply(x0, lane0, w_lo, w_hi, v1, sizes).backward(g)
    v2 = values.clone().requires_grad_()
    tps.splat_max_plain(x0, lane0, w_lo, w_hi, v2, sizes).backward(g)

    assert not v1.grad[:, 1::2].any()            # the odd twin gets nothing
    assert v2.grad[:, 1::2].any()                # autograd would have shared
    # the pair's total is the same either way
    torch.testing.assert_close(v1.grad[:, 0::2],
                               v2.grad[:, 0::2] + v2.grad[:, 1::2],
                               rtol=0, atol=1e-5)


def test_backward_wrappers_validate_inputs():
    args = _inputs((8, 8, 8), r=2, k=16)
    grid = tps.splat_max(*args, (8, 8, 8))
    with pytest.raises(ValueError):
        tps.splat_max_bwd(*args, grid, grid[:, :10], (8, 8, 8))
    with pytest.raises(ValueError):
        tps.slice_bwd(*args[:4], args[4].double(), grid, (8, 8, 8))
