"""The vertex-list core API against the JAX package's.

* ``trilinear_coords``/``bilinear_coords``/``grid_positions``: weights and
  (flat) vertex indices bit-equal to JAX's, keys at cell edges and clipped
  keys included; the key gradient through ``balance_op`` within 1e-6; and
  the same relation as the kernels' ``grid_mapping`` (``vertex_weights``,
  ``flat_vertex_indices``), bit-equal, in the other vertex order.
* ``splat_max``/``slice_grid``/``splat_conv_slice`` with and without
  ``pts_mask``, with exact ties (every odd point duplicates its even
  neighbour, so the single-winner routing decides): the grid bit-equal
  (within 1e-6 under ``jax.grad``, whose weights round otherwise), the
  slice within 1e-6, the key and value gradients within 1e-5 of their
  scale (the sums over vertices and heads run in another order); a tied
  cell's gradient goes to its lowest point alone.
* ``splat_max_mapping``/``slice_grid_mapping`` (the kernels, spatial layout
  ``[B, H, G, F]``): bit-equal to the ``_k`` forms reshaped, forward and
  backward, and against JAX's forward and every gradient (keys, values,
  grid).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu_torch.core import coords as tco
from cloud_transformers_tpu_torch.core import grid_mapping as tgm
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.core import vertex_list as tvl

# the modules, not the functions that cloud_transformers_tpu.core re-exports
jco = importlib.import_module("cloud_transformers_tpu.core.coords")
jgm = importlib.import_module("cloud_transformers_tpu.core.grid_mapping")
jss = importlib.import_module("cloud_transformers_tpu.core.splat_slice")

SIZES = [(8, 8), (6, 5, 4), (16, 16, 16)]
# grid_positions' vertex s in grid_mapping's order (lo row first, then the
# lanes' offsets): 3D offsets (x, y, z), 2D (x, y)
_TO_MAPPING = {3: [0, 4, 2, 6, 1, 5, 3, 7], 2: [0, 2, 1, 3]}


def _keys(sizes, b=2, p=60, h=3, seed=0):
    """Keys in [-1, 1] with clipped ones and ones on cell edges."""
    dim = len(sizes)
    rs = np.random.RandomState(seed)
    keys = np.tanh(2 * rs.randn(b, p, h, dim)).astype(np.float32)
    keys[0, :5] = 1.5
    keys[1, :5] = -1.5
    edges = [np.float32(2 * rs.randint(0, s) / (s - 1) - 1) for s in sizes]
    keys[:, 5:10] = np.asarray(edges, np.float32)
    return keys


@pytest.mark.parametrize("dim", [2, 3])
def test_linear_coords_match_jax_exactly(dim):
    rs = np.random.RandomState(1)
    keys = rs.uniform(0, 7, (5, 11, dim)).astype(np.float32)
    keys[0] = np.floor(keys[0])                  # integer coordinates
    j_fn, t_fn = ((jco.bilinear_coords, tco.bilinear_coords) if dim == 2
                  else (jco.trilinear_coords, tco.trilinear_coords))
    jw, jv = j_fn(jnp.asarray(keys))
    tw, tv = t_fn(torch.from_numpy(keys))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("sizes", SIZES)
def test_grid_positions_match_jax_and_the_mapping(sizes):
    dim = len(sizes)
    keys = _keys(sizes)
    jw, ji = jco.grid_positions(jnp.asarray(keys), sizes, dim)
    tk = torch.from_numpy(keys).requires_grad_()
    tw, ti = tco.grid_positions(tk, sizes, dim)
    np.testing.assert_array_equal(tw.detach().numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int64 and ti.max() < np.prod(sizes)

    # the kernels' form of the same relation, vertex for vertex
    m = tgm.grid_mapping(torch.from_numpy(keys), sizes, dim)
    order = _TO_MAPPING[dim]
    mw, mi = tgm.vertex_weights(m), tgm.flat_vertex_indices(m, sizes)
    if dim == 2:        # the mapping's 2D slots 2, 3 of each row are empty
        mw, mi = mw[..., [0, 1, 4, 5]], mi[..., [0, 1, 4, 5]]
    assert torch.equal(tw.detach()[..., order], mw)
    assert torch.equal(ti[..., order], mi)

    # the key gradient through balance_op
    cot = np.random.RandomState(2).randn(*tw.shape).astype(np.float32)
    j_dk = jax.grad(lambda k: jnp.sum(
        jco.grid_positions(k, sizes, dim)[0] * cot))(jnp.asarray(keys))
    (tw * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(j_dk), rtol=0,
                               atol=1e-6)
    assert np.abs(tk.grad.numpy()).max() > 0


def _point_inputs(sizes, masked, b=2, p=40, h=3, f=4, seed=3):
    dim = len(sizes)
    rs = np.random.RandomState(seed)
    keys = rs.uniform(-1, 1, (b, p, h, dim)).astype(np.float32)
    values = rs.randn(b, p, h * f).astype(np.float32)
    keys[:, 1::2] = keys[:, 0::2]                    # exact ties
    values[:, 1::2] = values[:, 0::2]
    values[-1, :, :f] = -np.abs(values[-1, :, :f])   # an all-negative grid
    mask = ((rs.uniform(size=(b, p)) > 0.3).astype(np.float32) if masked
            else None)
    cot = rs.randn(b, p, h * f).astype(np.float32)
    cot_grid = rs.randn(b, h, int(np.prod(sizes)), f).astype(np.float32)
    return keys, values, mask, cot, cot_grid


def _conv_fn(grid):
    """A grid transform that both frameworks compute alike."""
    return grid * 0.5 + 0.25


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sizes", [(8, 8), (6, 5, 4)])
def test_vertex_list_splat_slice_match_jax(sizes, masked):
    dim, h, f = len(sizes), 3, 4
    cells = int(np.prod(sizes))
    keys, values, mask, cot, cot_grid = _point_inputs(sizes, masked)

    def j_run(keys, values):
        w, idx = jco.grid_positions(keys, sizes, dim)
        grid = jss.splat_max(w, idx, values, h, cells, _j(mask))
        out = jss.slice_grid(w, idx, grid, h, _j(mask))
        both = jss.splat_conv_slice(w, idx, values, h, cells, _conv_fn,
                                    _j(mask))
        loss = (jnp.sum(out * cot) + jnp.sum(grid * cot_grid)
                + jnp.sum(both * cot[..., ::-1]))
        return loss, (grid, out, both)

    (_, j_outs), j_grads = jax.value_and_grad(
        j_run, argnums=(0, 1), has_aux=True)(jnp.asarray(keys),
                                             jnp.asarray(values))
    tk = torch.from_numpy(keys).requires_grad_()
    tv = torch.from_numpy(values).requires_grad_()
    w, idx = tco.grid_positions(tk, sizes, dim)
    grid = tvl.splat_max(w, idx, tv, h, cells, _t(mask))
    out = tvl.slice_grid(w, idx, grid, h, _t(mask))
    both = tvl.splat_conv_slice(w, idx, tv, h, cells, _conv_fn, _t(mask))
    ((out * _t(cot)).sum() + (grid * _t(cot_grid)).sum()
     + (both * _t(np.ascontiguousarray(cot[..., ::-1]))).sum()).backward()

    assert grid.shape == (2, h, cells, f)
    # under jax.grad the JAX weights' product rounds otherwise (1 ulp in 3D)
    j_grid = j_run(jnp.asarray(keys), jnp.asarray(values))[1][0]
    np.testing.assert_array_equal(grid.detach().numpy(), np.asarray(j_grid))
    for got, ref in ((out, j_outs[1]), (both, j_outs[2]),
                     (grid, j_outs[0])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6)
    for got, ref in ((tk.grad, j_grads[0]), (tv.grad, j_grads[1])):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale)
        assert np.abs(ref).max() > 0
    if masked:
        assert not out.detach().numpy()[mask == 0].any()
        assert not tv.grad.numpy()[mask == 0].any()


def test_ties_route_to_the_lowest_point():
    """Two points with the same keys and values: the splat's gradient goes
    to the first alone, never split between them."""
    keys = np.full((1, 2, 1, 2), 0.3, np.float32)
    values = torch.tensor([[[1.0, 2.0], [1.0, 2.0]]], requires_grad=True)
    w, idx = tco.grid_positions(torch.from_numpy(keys), (4, 4), 2)
    grid = tvl.splat_max(w, idx, values, 1, 16)
    grid.sum().backward()
    assert values.grad[0, 1].abs().max() == 0
    assert torch.allclose(values.grad[0, 0], w[0, 0, 0].sum().expand(2))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sizes", [(8, 8), (8, 8, 8)])
def test_mapping_forms_match_jax_and_the_k_forms(sizes, masked):
    dim, h, f = len(sizes), 3, 4
    keys, values, mask, cot, cot_grid = _point_inputs(sizes, masked)
    grid_in = np.random.RandomState(5).randn(*cot_grid.shape).astype(
        np.float32)

    def j_run(keys, values, grid_in):
        m = jgm.grid_mapping(keys, sizes, dim)
        grid = jss.splat_max_mapping(m, values, sizes, _j(mask))
        out = jss.slice_grid_mapping(m, grid_in, sizes, _j(mask))
        return (jnp.sum(out * cot) + jnp.sum(grid * cot_grid)), (grid, out)

    (_, j_outs), j_grads = jax.value_and_grad(
        j_run, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(keys), jnp.asarray(values), jnp.asarray(grid_in))

    runs = {}
    for form in ("spatial", "k"):
        tk, tv, tg = (torch.from_numpy(a).requires_grad_()
                      for a in (keys, values, grid_in))
        m = tgm.grid_mapping(tk, sizes, dim)
        if form == "spatial":
            grid = tss.splat_max_mapping(m, tv, sizes, _t(mask))
            out = tss.slice_grid_mapping(m, tg, sizes, _t(mask))
        else:
            grid = tss.splat_max_mapping_k(m, tv, sizes, _t(mask)).reshape(
                tg.shape)
            out = tss.slice_grid_mapping_k(m, tg.reshape(-1, *tg.shape[2:]),
                                           sizes, f, _t(mask))
        ((out * _t(cot)).sum() + (grid * _t(cot_grid)).sum()).backward()
        runs[form] = [t.detach() for t in (grid, out)] + [
            t.grad for t in (tk, tv, tg)]
    for a, b in zip(runs["spatial"], runs["k"]):
        assert torch.equal(a, b)

    grid, out, d_keys, d_values, d_grid = runs["spatial"]
    assert grid.shape == (2, h, int(np.prod(sizes)), f)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(j_outs[0]))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_outs[1]), rtol=0,
                               atol=1e-6)
    for got, ref in zip((d_keys, d_values, d_grid), j_grads):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale)
        assert np.abs(ref).max() > 0
