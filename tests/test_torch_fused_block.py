"""Port parity: the fused splat -> conv -> slice block
(``CT_BLOCK_FUSION=fused``).

``fused_block`` (the plain version on the CPU) against the JAX package's
``pallas_fused_block(..., want_gk2=True)`` in interpret mode, at the shapes
of ``tests/test_fused_block.py``: the splatted grid bit-equal, the points
and the convolved grid within 1e-5 (conv sums in another order).  The
block's VJP against the JAX package's ``_fused_block_mk`` within 1e-5, the
``gk`` cotangent included, and with a ragged ``pts_mask`` whose padded
points repeat valid points' keys.  And ``MultiHead``/``MultiHeadAdaIn`` with the
fused block equal their "ops" path with the same ``state_dict``, forward
and backward, within 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cloud_transformers_tpu.ops.pallas_splat as jps
from cloud_transformers_tpu.core import splat_slice as jss
from cloud_transformers_tpu.ops.pallas_fused_block import pallas_fused_block
from cloud_transformers_tpu_torch.convert import (
    jax_to_state_dict,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.core import grid_mapping as tgm
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.nn import grouped_conv as tgcm
from cloud_transformers_tpu_torch.nn.multihead import MultiHead
from cloud_transformers_tpu_torch.nn.multihead_adain import MultiHeadAdaIn
from cloud_transformers_tpu_torch.ops import pallas_fused_block as tfb
from cloud_transformers_tpu_torch.ops import pallas_splat as tps

# the module, which the package's ``grid_mapping`` function shadows
jgm = importlib.import_module("cloud_transformers_tpu.core.grid_mapping")
SHAPES = [((8, 8, 8), 4, 2), ((16, 16), 4, 2), ((8, 8, 8), 8, 2)]


def _inputs(sizes, f, h, b=2, k=64, seed=0):
    """Numpy inputs as the JAX test makes them; the port's weight is the
    JAX kernel converted."""
    rs = np.random.RandomState(seed)
    dim = len(sizes)
    keys = rs.uniform(0, np.array(sizes) - 1.001,
                      (b * h, k, dim)).astype(np.float32)
    mapping = tps.vertex_decomposition(torch.from_numpy(keys), sizes)
    vals = rs.randn(b * h, k, f).astype(np.float32)
    kern = (rs.randn(*((3,) * dim + (f, h * f))) * 0.1).astype(np.float32)
    bias = (rs.randn(h * f) * 0.1).astype(np.float32)
    sd = jax_to_state_dict({"params": {"kernel": kern, "bias": bias}})
    port = list(mapping) + [torch.from_numpy(vals), sd["weight"], sd["bias"]]
    jax_args = [jnp.asarray(t.numpy()) for t in mapping] + [
        jnp.asarray(vals), jnp.asarray(kern), jnp.asarray(bias)]
    return port, jax_args


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("sizes,f,h", SHAPES)
def test_fused_block_matches_jax(sizes, f, h):
    port, jargs = _inputs(sizes, f, h)
    pts, gk, gk2 = tfb.fused_block(*port, sizes, h, want_gk2=True)
    assert tfb.fused_block.launches == 0          # CPU: the plain version
    j_pts, j_gk, j_gk2 = pallas_fused_block(*jargs, sizes, f, h,
                                            want_gk2=True, interpret=True)
    np.testing.assert_array_equal(
        gk.numpy(), np.asarray(jps.kernel_to_flat(j_gk, sizes, f)))
    _close(gk2, jps.kernel_to_flat(j_gk2, sizes, f))
    _close(pts, j_pts)
    assert torch.equal(gk, tps.splat_max(*port[:5], sizes))
    # without gk2, the same points and grid
    pts_only, gk_only = tfb.fused_block(*port, sizes, h)
    assert torch.equal(pts_only, pts) and torch.equal(gk_only, gk)


@pytest.mark.parametrize("sizes,f,h", SHAPES[:2])
def test_fused_block_vjp_matches_jax(sizes, f, h):
    port, jargs = _inputs(sizes, f, h)
    x0, lane0 = jargs[:2]

    def j_loss(w_lo, w_hi, vals, kern, bias):
        pts, gk = jss._fused_block_mk(tuple(sizes), f, h, x0, lane0, w_lo,
                                      w_hi, vals, kern, bias)
        return jnp.sum(pts ** 2) + jnp.sum(jnp.tanh(gk))

    j_l, j_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4))(
        *jargs[2:])

    leaves = [t.clone().requires_grad_() for t in port[2:]]
    pts, gk = tss._FusedBlock.apply(*port[:2], *leaves, sizes, h, True)
    loss = (pts ** 2).sum() + torch.tanh(gk).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_l), rtol=1e-6)
    for t, ref in zip(leaves[:3], j_g[:3]):
        _close(t.grad, ref)
    grads = port_to_jax_tree({"weight": leaves[3].grad,
                              "bias": leaves[4].grad},
                             {"kernel": jargs[5], "bias": jargs[6]})
    _close(grads["kernel"], j_g[3])
    _close(grads["bias"], j_g[4])


@pytest.mark.parametrize("sizes,f,h", SHAPES[:2])
def test_fused_block_vjp_takes_no_gk_cotangent(sizes, f, h):
    """Only the points carry a gradient (``head_stats`` reads gk under
    no_grad): the backward gets None for gk and equals the three ops'."""
    port, _ = _inputs(sizes, f, h)
    grads = []
    for fused in (True, False):
        leaves = [t.clone().requires_grad_() for t in port[2:]]
        if fused:
            pts, _ = tss._FusedBlock.apply(*port[:2], *leaves, sizes, h,
                                           True)
        else:
            gk = tss._SplatMax.apply(*port[:2], *leaves[:3], sizes)
            gk2 = tgcm._GridConv.apply(gk, leaves[3], leaves[4], sizes, h)
            pts = tss._SliceGather.apply(*port[:2], *leaves[:2], gk2, sizes)
        (pts ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        _close(a, b.numpy(), 1e-6)


def _multihead_runs(make, call, fused_calls):
    """(outputs, gradients) of the module under "ops" and "fused" with the
    same state_dict; ``fused_calls`` collects ``want_gk2`` of each fused
    launch."""
    torch.manual_seed(0)
    mods = {}
    runs = {}
    for mode in ("ops", "fused"):
        mods[mode] = make()
    with torch.no_grad():
        for p in mods["ops"].parameters():
            p.normal_(0, 0.3)
    mods["fused"].load_state_dict(mods["ops"].state_dict())
    assert list(mods["ops"].state_dict()) == list(mods["fused"].state_dict())
    try:
        for mode, mod in mods.items():
            tgcm.set_block_fusion(mode)
            out, stats = call(mod)
            (out ** 2).sum().backward()
            with torch.no_grad():
                call(mod)
            runs[mode] = (out.detach(), stats,
                          {n: p.grad for n, p in mod.named_parameters()})
    finally:
        tgcm.set_block_fusion(None)
    assert fused_calls == [True, False]           # no gk2 under no_grad
    return runs


def _spy(monkeypatch):
    calls = []

    def spy(*a, want_gk2=False, **kw):
        calls.append(want_gk2)
        return tfb.fused_block(*a, want_gk2=want_gk2, **kw)
    monkeypatch.setattr(tss, "fused_block", spy)
    return calls


@pytest.mark.parametrize("tensor_size,dim", [(8, 3), (16, 2)])
def test_multihead_fused_equals_ops(monkeypatch, tensor_size, dim):
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 64, 16).astype(np.float32))
    pcd = torch.from_numpy(rs.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    mask = torch.from_numpy((rs.rand(2, 64) > 0.2).astype(np.float32))
    calls = _spy(monkeypatch)
    runs = _multihead_runs(
        lambda: MultiHead(16, 4, tensor_size, dim, 2).train(),
        lambda m: m(x, pcd, mask), calls)
    (o_ops, s_ops, g_ops), (o_f, s_f, g_f) = runs["ops"], runs["fused"]
    _close(o_f, o_ops.numpy())
    for k in s_ops:
        _close(s_f[k], s_ops[k].numpy())
    for n in g_ops:
        _close(g_f[n], g_ops[n].numpy())
    assert float(g_f["conv.weight"].abs().max()) > 0


def test_multihead_adain_fused_equals_ops(monkeypatch):
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(2, 64, 16).astype(np.float32))
    z = torch.from_numpy(rs.randn(2, 8).astype(np.float32))
    pcd = torch.from_numpy(rs.uniform(-1, 1, (2, 64, 3)).astype(np.float32))
    calls = _spy(monkeypatch)
    runs = _multihead_runs(
        lambda: MultiHeadAdaIn(16, 8, 4, 8, 3, 2),
        lambda m: m(x, z, pcd), calls)
    (o_ops, _, g_ops), (o_f, _, g_f) = runs["ops"], runs["fused"]
    _close(o_f, o_ops.numpy())
    # the conv bias feeds an instance norm, which takes it out again: its
    # gradient is rounding noise on both paths, held to the module's scale
    scale = max(float(g.abs().max()) for g in g_ops.values())
    assert float(g_ops["conv.bias"].abs().max()) < 1e-5 * scale
    for n in g_ops:
        np.testing.assert_allclose(g_f[n].numpy(), g_ops[n].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=n)


@pytest.mark.parametrize("sizes,f,h", SHAPES[:2])
def test_masked_fused_block_matches_jax(sizes, f, h):
    """``fused_block_mk`` with a ragged ``pts_mask`` as the KPConv protocol
    makes it (each row's padded points repeat valid points' keys; 40% and
    70% of the rows valid) against the JAX package's ``fused_block_mk``:
    the points within 1e-5 and zero at the padded points, the splatted
    grid bit-equal, the gradients of the keys, the values, the kernel and
    the bias within 1e-5, none for a padded point's values."""
    dim, b, p = len(sizes), 2, 64
    rs = np.random.RandomState(5)
    mask = np.zeros((b, p), np.float32)
    keys = rs.uniform(-1, 1, (b, p, h, dim)).astype(np.float32)
    for i, n in enumerate((int(0.4 * p), int(0.7 * p))):
        mask[i, :n] = 1
        keys[i, n:] = keys[i, rs.randint(0, n, p - n)]
    values = rs.randn(b, p, h * f).astype(np.float32)
    kern = (rs.randn(*((3,) * dim + (f, h * f))) * 0.1).astype(np.float32)
    bias = (rs.randn(h * f) * 0.1).astype(np.float32)
    cot = rs.randn(b, p, h * f).astype(np.float32)

    def j_loss(keys, values, kern, bias):
        m = jgm.grid_mapping(keys, sizes, dim)
        out, gk = jss.fused_block_mk(m, values, kern, bias, sizes, f, h,
                                     pts_mask=jnp.asarray(mask))
        return jnp.sum(out * cot) + jnp.sum(jnp.tanh(gk)), (out, gk)

    (j_l, (j_out, j_gk)), j_g = jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(keys), jnp.asarray(values), jnp.asarray(kern),
            jnp.asarray(bias))

    sd = jax_to_state_dict({"params": {"kernel": kern, "bias": bias}})
    leaves = [torch.from_numpy(keys).requires_grad_(),
              torch.from_numpy(values).requires_grad_(),
              sd["weight"].requires_grad_(), sd["bias"].requires_grad_()]
    m = tgm.grid_mapping(leaves[0], sizes, dim)
    out, gk = tss.fused_block_mk(m, leaves[1], leaves[2], leaves[3], sizes,
                                 f, h, pts_mask=torch.from_numpy(mask))
    loss = (out * torch.from_numpy(cot)).sum() + torch.tanh(gk).sum()
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(j_l), rtol=1e-6)
    _close(out.detach(), j_out)
    assert not out.detach().numpy()[mask == 0].any()
    np.testing.assert_array_equal(
        gk.detach().numpy(), np.asarray(jps.kernel_to_flat(j_gk, sizes, f)))
    for t, ref in zip(leaves[:2], j_g[:2]):
        _close(t.grad, ref)
    assert not leaves[1].grad.numpy()[mask == 0].any()
    grads = port_to_jax_tree({"weight": leaves[2].grad,
                              "bias": leaves[3].grad},
                             {"kernel": kern, "bias": bias})
    _close(grads["kernel"], j_g[2])
    _close(grads["bias"], j_g[3])
