"""Port parity: GridConvK's gradients against jax.grad of the JAX GridConvK.

(16, 16, 16) takes the JAX Pallas branch (the forward kernel on flipped,
transposed weights for d_grid and ``pallas_grid_conv_dw`` for d_weight, in
interpret mode on the CPU) and the port's autograd Function (the plain
versions on the CPU).  (8, 8, 8) and 2D 16^2 take the library conv on both
sides.  Tolerance 1e-5 of the gradient's scale: sums of thousands of terms
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cloud_transformers_tpu.core.splat_slice import (
    gridk_to_spatial as j_to_spatial,
    spatial_to_gridk as j_to_gridk,
)
from cloud_transformers_tpu.nn.grouped_conv import GridConvK as JGridConvK
from cloud_transformers_tpu.ops.pallas_grid_conv import (
    pack_w,
    pack_w_transposed,
)
from cloud_transformers_tpu_torch.convert import (
    jax_to_state_dict,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.core.splat_slice import (
    gridk_to_spatial,
    spatial_to_gridk,
)
from cloud_transformers_tpu_torch.nn.grouped_conv import GridConvK
from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc

CASES = [((16, 16, 16), 4, 2), ((8, 8, 8), 4, 2), ((16, 16), 4, 2)]


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("sizes,feat,heads", CASES)
def test_grid_conv_k_gradients_match_jax(sizes, feat, heads):
    b = 2
    rs = np.random.RandomState(0)
    gs = np.maximum(rs.randn(b, *sizes, heads * feat), 0).astype(np.float32)
    cot = rs.randn(b, *sizes, heads * feat).astype(np.float32)
    jmod = JGridConvK(feat=feat, heads=heads, sizes=sizes)
    params = jmod.init(jax.random.PRNGKey(0),
                       j_to_gridk(jnp.asarray(gs), heads, sizes, feat))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["bias"] = rs.randn(heads * feat).astype(np.float32)

    def j_loss(p, gs):
        out = jmod.apply(p, j_to_gridk(gs, heads, sizes, feat))
        return jnp.sum(j_to_spatial(out, b, sizes, feat) * cot)

    j_dp, j_dgs = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(gs))

    tmod = GridConvK(feat, heads, sizes)
    tmod.load_state_dict(jax_to_state_dict(params))
    tgs = torch.from_numpy(gs).requires_grad_()
    launches = (tgc.grid_conv3d.launches, tgc.grid_conv3d_dw.launches)
    out = tmod(spatial_to_gridk(tgs, heads, sizes, feat))
    (gridk_to_spatial(out, b, sizes, feat) * torch.from_numpy(cot)
     ).sum().backward()
    assert (tgc.grid_conv3d.launches,
            tgc.grid_conv3d_dw.launches) == launches   # CPU: plain versions

    _close(tgs.grad, j_dgs)
    grads = port_to_jax_tree(
        {n: p.grad for n, p in tmod.named_parameters()}, params["params"])
    assert set(grads) == {"kernel", "bias"}
    _close(grads["kernel"], j_dp["params"]["kernel"])
    _close(grads["bias"], j_dp["params"]["bias"])
    assert np.abs(grads["kernel"]).max() > 0


def test_plain_dw_matches_conv3d_weight_gradient():
    """The weight-gradient kernel's plain version is the gradient of the
    grouped 'same' conv3d for its weight, in the parameter layout."""
    sizes, f, h, b = (6, 5, 4), 3, 2, 2
    gen = torch.Generator().manual_seed(0)
    grid = torch.randn(b * h, 6 * 5 * 4, f, generator=gen)
    g = torch.randn(b * h, 6 * 5 * 4, f, generator=gen)
    weight = torch.randn(h * f, f, 3, 3, 3, generator=gen).requires_grad_()
    got = tgc.grid_conv3d_dw(grid, g, sizes, h)
    assert tgc.grid_conv3d_dw.launches == 0

    def cf(t):
        return t.reshape(b, h, *sizes, f).movedim(-1, 2).reshape(
            b, h * f, *sizes)
    (F.conv3d(cf(grid), weight, None, padding=1, groups=h) * cf(g)
     ).sum().backward()
    _close(got, weight.grad)


def test_transpose_weight_is_pack_w_transposed():
    """``transpose_weight`` makes, in the port's layout, the weights that
    the JAX package's ``pack_w_transposed`` packs: the forward conv run on
    them gives the input gradient."""
    sizes, f, h = (16, 16, 16), 4, 2
    rs = np.random.RandomState(1)
    kernel = rs.randn(3, 3, 3, f, h * f).astype(np.float32)   # DHWIO
    weight = jax_to_state_dict({"params": {"kernel": kernel}})["weight"]
    w_t = tgc.transpose_weight(weight, h)
    # back to DHWIO, then packed as a forward weight: the JAX transposed pack
    kernel_t = w_t.numpy().transpose(2, 3, 4, 1, 0)
    np.testing.assert_array_equal(
        np.asarray(pack_w(jnp.asarray(kernel_t), f, h, sizes)),
        np.asarray(pack_w_transposed(jnp.asarray(kernel), f, h, sizes)))
    # and it is the adjoint of the conv in its input
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2 * h, 16 ** 3, f, generator=gen)
    g = torch.randn(2 * h, 16 ** 3, f, generator=gen)
    zero = torch.zeros(h * f)
    lhs = (tgc.grid_conv3d(x, weight, zero, sizes, h) * g).sum()
    rhs = (x * tgc.grid_conv3d(g, w_t, zero, sizes, h)).sum()
    assert abs(float(lhs - rhs)) <= 1e-4 * max(1.0, abs(float(lhs)))


def test_grid_conv3d_dw_validates_inputs():
    grid = torch.zeros(4, 64, 4)
    with pytest.raises(ValueError):
        tgc.grid_conv3d_dw(grid, torch.zeros(4, 64, 3), (4, 4, 4), 2)
    with pytest.raises(ValueError):
        tgc.grid_conv3d_dw(grid, grid, (4, 4), 2)
