"""Port parity: splat-max, slice and grid_mapping against the JAX package.

The same numpy inputs go through the JAX Pallas kernels (interpret mode, as
the JAX tests run them on the CPU) and the port's wrappers, which take their
plain versions for CPU tensors.  Splat must agree exactly, slice to 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.ops.pallas_splat import (
    kernel_to_flat,
    pallas_slice,
    pallas_splat,
)
from cloud_transformers_tpu_torch.core import grid_mapping as tgm
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.ops import pallas_splat as tps

# the modules, not the functions that cloud_transformers_tpu.core re-exports
jgm = importlib.import_module("cloud_transformers_tpu.core.grid_mapping")
jss = importlib.import_module("cloud_transformers_tpu.core.splat_slice")

SIZES = [(16, 16), (16, 16, 16), (8, 8, 8)]


def _mapping(sizes, r=4, k=64, f=4, seed=0):
    """Random kernel inputs with exact ties (duplicated points) and one
    all-negative row."""
    rs = np.random.RandomState(seed)
    dim = len(sizes)
    base = np.stack([rs.randint(0, s - 1, (r, k)) for s in sizes], -1)
    frac = rs.uniform(0, 1, (r, k, dim)).astype(np.float32)
    x0 = base[..., 0].astype(np.int32)
    if dim == 2:
        lane0 = base[..., 1].astype(np.int32)
        fx, fy = frac[..., 0], frac[..., 1]
        z = np.zeros_like(fx)
        w_lo = np.stack([(1 - fx) * (1 - fy), (1 - fx) * fy, z, z], -1)
        w_hi = np.stack([fx * (1 - fy), fx * fy, z, z], -1)
    else:
        lane0 = (base[..., 1] * sizes[2] + base[..., 2]).astype(np.int32)
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
        w_lo = np.stack([(1 - fx) * (1 - fy) * (1 - fz),
                         (1 - fx) * (1 - fy) * fz,
                         (1 - fx) * fy * (1 - fz), (1 - fx) * fy * fz], -1)
        w_hi = np.stack([fx * (1 - fy) * (1 - fz), fx * (1 - fy) * fz,
                         fx * fy * (1 - fz), fx * fy * fz], -1)
    values = rs.randn(r, k, f).astype(np.float32)
    # exact ties: every odd point duplicates its even neighbour
    for a in (x0, lane0, w_lo, w_hi, values):
        a[:, 1::2] = a[:, 0::2]
    values[-1] = -np.abs(values[-1])          # all-negative row -> zero grid
    return [np.ascontiguousarray(a.astype(a.dtype)) for a in
            (x0, lane0, w_lo.astype(np.float32), w_hi.astype(np.float32),
             values)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("sizes", SIZES)
def test_splat_max_matches_jax_exactly(sizes):
    x0, lane0, w_lo, w_hi, values = _mapping(sizes)
    f = values.shape[-1]
    ref = kernel_to_flat(pallas_splat(
        jnp.asarray(x0), jnp.asarray(lane0), jnp.asarray(w_lo),
        jnp.asarray(w_hi), jnp.asarray(values), sizes, f, op="max",
        interpret=True, kernel_layout_out=True), sizes, f)
    got = tps.splat_max(*_t((x0, lane0, w_lo, w_hi, values)), sizes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[-1].any()                  # all-negative row clamps to 0
    assert got.numpy().max() > 0


@pytest.mark.parametrize("sizes", SIZES)
def test_slice_matches_jax(sizes):
    x0, lane0, w_lo, w_hi, values = _mapping(sizes, seed=1)
    f = values.shape[-1]
    rs = np.random.RandomState(2)
    grid = rs.randn(x0.shape[0], int(np.prod(sizes)), f).astype(np.float32)
    ref = pallas_slice(jnp.asarray(x0), jnp.asarray(lane0),
                       jnp.asarray(w_lo), jnp.asarray(w_hi),
                       jnp.asarray(grid), sizes, f, interpret=True)
    got = tps.slice_gather(*_t((x0, lane0, w_lo, w_hi, grid)), sizes)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("sizes", SIZES + [(128, 128), (32, 32, 32)])
def test_grid_mapping_matches_jax(sizes):
    """Same f32 op order as JAX (clip, +1, *(size-1)/2, floor): the mapping
    is bit-identical, clipped keys and keys near cell edges included."""
    dim = len(sizes)
    rs = np.random.RandomState(3)
    keys = np.tanh(2 * rs.randn(2, 500, 3, dim)).astype(np.float32)
    keys[0, :10] = 1.5                         # clipped to +-(1 - 1e-7)
    keys[1, :10] = -1.5
    ref = jgm.grid_mapping(jnp.asarray(keys), sizes, dim)
    got = tgm.grid_mapping(torch.from_numpy(keys), sizes, dim)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(
        tgm.flat_vertex_indices(got, sizes).numpy(),
        np.asarray(jgm.flat_vertex_indices(ref, sizes)))
    np.testing.assert_array_equal(tgm.vertex_weights(got).numpy(),
                                  np.asarray(jgm.vertex_weights(ref)))


@pytest.mark.parametrize("sizes", [(16, 16), (8, 8, 8)])
def test_mapping_ops_pts_mask_match_jax(sizes):
    """splat_max_mapping_k / slice_grid_mapping_k with a pts_mask: masked
    points add nothing to the grid and read back zeros."""
    dim, b, p, h, f = len(sizes), 2, 40, 3, 4
    rs = np.random.RandomState(4)
    keys = rs.uniform(-1, 1, (b, p, h, dim)).astype(np.float32)
    values = rs.randn(b, p, h * f).astype(np.float32)
    mask = (rs.uniform(size=(b, p)) > 0.3).astype(np.float32)

    jm = jgm.grid_mapping(jnp.asarray(keys), sizes, dim)
    jgk = jss.splat_max_mapping_k(jm, jnp.asarray(values), sizes,
                                  pts_mask=jnp.asarray(mask))
    jout = jss.slice_grid_mapping_k(jm, jgk, sizes, f,
                                    pts_mask=jnp.asarray(mask))
    tm = tgm.grid_mapping(torch.from_numpy(keys), sizes, dim)
    tgk = tss.splat_max_mapping_k(tm, torch.from_numpy(values), sizes,
                                  pts_mask=torch.from_numpy(mask))
    tout = tss.slice_grid_mapping_k(tm, tgk, sizes, f,
                                    pts_mask=torch.from_numpy(mask))

    np.testing.assert_array_equal(tgk.numpy(),
                                  np.asarray(kernel_to_flat(jgk, sizes, f)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)
    assert not tout.numpy()[mask == 0].any()
    # the mask equals zeroing the masked points' values before the splat
    unmasked = tss.splat_max_mapping_k(
        tm, torch.from_numpy(values * mask[..., None]), sizes)
    assert torch.equal(unmasked, tgk)
    # and the spatial view round-trips
    gs = tss.gridk_to_spatial(tgk, b, sizes, f)
    assert gs.shape == (b,) + tuple(sizes) + (h * f,)
    assert torch.equal(tss.spatial_to_gridk(gs, h, sizes, f), tgk)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    args = _t(_mapping((8, 8, 8), r=2, k=16))
    before = (tps.splat_max.launches, tps.slice_gather.launches)
    grid = tps.splat_max(*args, (8, 8, 8))
    assert torch.equal(grid, tps.splat_max_plain(*args, (8, 8, 8)))
    tps.slice_gather(*args[:4], grid, (8, 8, 8))
    assert (tps.splat_max.launches, tps.slice_gather.launches) == before


def test_wrappers_validate_inputs():
    x0, lane0, w_lo, w_hi, values = _t(_mapping((8, 8, 8), r=2, k=16))
    with pytest.raises(ValueError):
        tps.splat_max(x0.long(), lane0, w_lo, w_hi, values, (8, 8, 8))
    with pytest.raises(ValueError):
        tps.slice_gather(x0, lane0, w_lo, w_hi, torch.zeros(2, 10, 4),
                         (8, 8, 8))

