"""Port parity: the forward-tracked winner map (``FWD_WINNER``).

``splat_max_winner`` (the plain version on the CPU) against the JAX
package's ``pallas_splat(..., with_winner=True)`` in interpret mode: the
grid bit-equal, the winner map equal after converting JAX's float index in
the kernel layout (3e38 where nothing won) to the port's int32 map
(``NO_WINNER``).  ``splat_route`` against ``pallas_splat_bwd_routed`` within
1e-6 (a few terms each).  And through ``splat_max_mapping_k`` and the
slice: with ``FWD_WINNER`` the port's gradients are bit-identical to its
two-pass path, exact duplicates included, and within 1e-6 of the JAX
package's under its own ``FWD_WINNER``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloud_transformers_tpu.ops.pallas_splat as jps
from cloud_transformers_tpu_torch.core import grid_mapping as tgm
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.ops import pallas_splat as tps

jgm = importlib.import_module("cloud_transformers_tpu.core.grid_mapping")
jss = importlib.import_module("cloud_transformers_tpu.core.splat_slice")

SIZES = [(16, 16), (8, 8, 8), (6, 5, 4)]


def _inputs(sizes, r=4, k=64, f=4, seed=0):
    """Kernel inputs with exact ties (every odd point duplicates its even
    neighbour), one all-negative row, and empty cells."""
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


def _port_winner(winner_k, sizes, f):
    """JAX's kernel-layout float winner map -> the port's int32 [R, G, F]."""
    flat = np.asarray(jps.kernel_to_flat(winner_k, sizes, f))
    out = np.full(flat.shape, tps.NO_WINNER, np.int64)
    won = flat < 3e38
    out[won] = flat[won].astype(np.int64)
    return out


@pytest.mark.parametrize("sizes", SIZES)
def test_winner_map_and_routing_match_jax(sizes):
    args = _inputs(sizes)
    f = args[-1].shape[-1]
    grid, winner = tps.splat_max_winner(*args, sizes)
    assert tps.splat_max_winner.launches == 0     # CPU: the plain version
    assert winner.dtype == torch.int32
    gk, wk = jps.pallas_splat(*_j(args), sizes, f, interpret=True,
                              kernel_layout_out=True, with_winner=True)
    np.testing.assert_array_equal(
        grid.numpy(), np.asarray(jps.kernel_to_flat(gk, sizes, f)))
    np.testing.assert_array_equal(winner.numpy(), _port_winner(wk, sizes, f))
    # the same map as the two-pass backward's, sentinel where nothing won
    assert torch.equal(winner,
                       tps.splat_winner_plain(*args, grid, sizes))
    assert (winner[grid == 0] == tps.NO_WINNER).all()
    # an odd point only ever ties with its even twin, which wins
    assert not (winner % 2 == 1)[winner != tps.NO_WINNER].any()

    g = torch.from_numpy(
        np.random.RandomState(1).randn(*grid.shape).astype(np.float32))
    got = tps.splat_route(*args, winner, g, sizes)
    assert tps.splat_route.launches == 0
    ref = jps.pallas_splat_bwd_routed(
        *_j(args), wk, jps.flat_to_kernel(jnp.asarray(g.numpy()), sizes, f),
        sizes, f, interpret=True)
    two_pass = tps.splat_max_bwd(*args, grid, g, sizes)
    for what, a, b, c in zip(("d_w_lo", "d_w_hi", "d_values"), got, ref,
                             two_pass):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy() != 0, b != 0, err_msg=what)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6,
                                   err_msg=what)
        assert torch.equal(a, c), what           # bit for bit
    if len(sizes) == 2:
        assert not got[0][..., 2:].any() and not got[1][..., 2:].any()


def _case(dim, seed=3, b=1, p=16, heads=2, feat=4):
    """Keys and values where point 5 duplicates point 0 exactly."""
    rs = np.random.RandomState(seed)
    keys = np.tanh(rs.randn(b, p, heads, dim)).astype(np.float32)
    values = rs.randn(b, p, heads * feat).astype(np.float32)
    keys[:, 5] = keys[:, 0]
    values[:, 5] = values[:, 0]
    return (8,) * dim, keys, values, feat


def _port_grads(sizes, keys, values, feat):
    k = torch.from_numpy(keys).requires_grad_()
    v = torch.from_numpy(values).requires_grad_()
    m = tgm.grid_mapping(k, sizes, len(sizes))
    gk = tss.splat_max_mapping_k(m, v, sizes)
    out = tss.slice_grid_mapping_k(m, gk, sizes, feat)
    (torch.tanh(out) * 0.01).sum().backward()
    return k.grad, v.grad


@pytest.mark.parametrize("dim", [2, 3])
def test_fwd_winner_gradients_bit_identical_to_two_pass(dim, monkeypatch):
    sizes, keys, values, feat = _case(dim)
    calls = {"winner": 0, "route": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(tss, "splat_max_winner",
                        counted("winner", tss.splat_max_winner))
    monkeypatch.setattr(tss, "splat_route", counted("route", tss.splat_route))
    grads = {}
    for fw in (False, True):
        monkeypatch.setattr(tss, "FWD_WINNER", fw)
        grads[fw] = _port_grads(sizes, keys, values, feat)
    assert calls == {"winner": 1, "route": 1}
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
    assert not grads[True][1][0, 5].any() and grads[True][1][0, 0].any()
    # under no_grad the switch changes nothing: the plain splat_max
    with torch.no_grad():
        m = tgm.grid_mapping(torch.from_numpy(keys), sizes, dim)
        tss.splat_max_mapping_k(m, torch.from_numpy(values), sizes)
    assert calls == {"winner": 1, "route": 1}


@pytest.mark.parametrize("dim", [2, 3])
def test_fwd_winner_gradients_match_jax(dim, monkeypatch):
    sizes, keys, values, feat = _case(dim)

    def loss(keys, values):
        m = jgm.grid_mapping(keys, sizes, len(sizes))
        gk = jss.splat_max_mapping_k(m, values, sizes)
        out = jss.slice_grid_mapping_k(m, gk, sizes, feat)
        return jnp.sum(jnp.tanh(out) * 0.01)

    old = jss.FWD_WINNER
    try:
        jss.FWD_WINNER = True
        jax.clear_caches()
        j_grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(keys),
                                                 jnp.asarray(values))
    finally:
        jss.FWD_WINNER = old
        jax.clear_caches()
    monkeypatch.setattr(tss, "FWD_WINNER", True)
    t_grads = _port_grads(sizes, keys, values, feat)
    for a, b in zip(t_grads, j_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(b).max()))
    assert np.abs(np.asarray(j_grads[1])[0, 5]).max() == 0
