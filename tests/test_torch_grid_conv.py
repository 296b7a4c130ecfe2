"""Port parity: GridConvK against the JAX package's GridConvK.

(16, 16, 16) takes the JAX Pallas branch (interpret mode on the CPU) and
the port's kernel wrapper (its plain version on the CPU); (8, 8, 8) and
2D 16^2 take XLA's grouped conv and the port's F.conv{2,3}d.  Weights come
through ``convert.py``.  Tolerance 1e-5: the 27*F-term sums run in another
order.
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
from cloud_transformers_tpu_torch.convert import jax_to_state_dict
from cloud_transformers_tpu_torch.core.splat_slice import (
    gridk_to_spatial,
    spatial_to_gridk,
)
from cloud_transformers_tpu_torch.nn.grouped_conv import (
    GridConvK,
    kernel_wins,
)
from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc

CASES = [((16, 16, 16), 4, 2), ((8, 8, 8), 4, 2), ((16, 16), 4, 2)]


@pytest.mark.parametrize("sizes,feat,heads", CASES)
def test_grid_conv_k_matches_jax(sizes, feat, heads):
    b = 2
    rs = np.random.RandomState(0)
    gs = np.maximum(rs.randn(b, *sizes, heads * feat), 0).astype(np.float32)
    jmod = JGridConvK(feat=feat, heads=heads, sizes=sizes)
    jgk = j_to_gridk(jnp.asarray(gs), heads, sizes, feat)
    params = jmod.init(jax.random.PRNGKey(0), jgk)
    # non-trivial bias (the init draws it small)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["bias"] = rs.randn(heads * feat).astype(np.float32)
    ref = j_to_spatial(jmod.apply(params, jgk), b, sizes, feat)

    tmod = GridConvK(feat, heads, sizes)
    tmod.load_state_dict(jax_to_state_dict(params))
    assert kernel_wins(sizes) == (len(sizes) == 3 and sizes[0] >= 16)
    with torch.no_grad():
        out = tmod(spatial_to_gridk(torch.from_numpy(gs), heads, sizes,
                                    feat))
    got = gridk_to_spatial(out, b, sizes, feat)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_plain_grid_conv3d_matches_grouped_conv3d():
    """The kernel's plain version is the grouped 'same' conv."""
    sizes, f, h, b = (6, 5, 4), 3, 2, 2
    g = torch.Generator().manual_seed(0)
    grid = torch.randn(b * h, 6 * 5 * 4, f, generator=g)
    weight = torch.randn(h * f, f, 3, 3, 3, generator=g) * (27 * f) ** -0.5
    bias = torch.randn(h * f, generator=g)
    n = tgc.grid_conv3d.launches
    out = tgc.grid_conv3d(grid, weight, bias, sizes, h)
    assert tgc.grid_conv3d.launches == n      # CPU: no kernel launch
    x = grid.reshape(b, h, *sizes, f).movedim(-1, 2).reshape(b, h * f,
                                                             *sizes)
    ref = F.conv3d(x, weight, bias, padding=1, groups=h)
    ref = ref.reshape(b, h, f, *sizes).movedim(2, -1).reshape(b * h, -1, f)
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * scale)


def test_grid_conv3d_validates_inputs():
    grid = torch.zeros(4, 64, 4)
    with pytest.raises(ValueError):
        tgc.grid_conv3d(grid, torch.zeros(8, 4, 3, 3), torch.zeros(8),
                        (4, 4, 4), 2)
    with pytest.raises(ValueError):
        tgc.grid_conv3d(grid, torch.zeros(8, 4, 3, 3, 3), torch.zeros(8),
                        (4, 4), 2)

