"""Port parity: the 2D grid conv kernels' path (``CT_GRID_CONV=pallas``).

With the grid-conv strategy set to "pallas" on both sides, the JAX
``GridConvK`` runs ``pallas_grid_conv2d`` and, under ``jax.grad``,
``pallas_grid_conv2d_dm`` (interpret mode on the CPU), and the port's
``GridConvK`` its autograd Function (the plain versions on the CPU).  The
output and the input, weight and bias gradients agree within 1e-5 of their
scale: sums of up to 9 * F terms, and of thousands for the weight, in
another order.  Also: the switches read their environment variables as the
JAX package's do, the transposed weights are the JAX package's, and the
kernels' launch limits (F <= 32 with opt-in shared memory) and the 2D
kernels' tiling: every cell and every weight reached exactly once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cloud_transformers_tpu.nn.grouped_conv as jgc
from cloud_transformers_tpu.core.splat_slice import (
    gridk_to_spatial as j_to_spatial,
    spatial_to_gridk as j_to_gridk,
)
from cloud_transformers_tpu.ops.pallas_grid_conv import (
    pack_m2d,
    pack_m2d_transposed,
)
from cloud_transformers_tpu_torch.convert import (
    jax_to_state_dict,
    port_to_jax_tree,
)
from cloud_transformers_tpu_torch.core.splat_slice import (
    gridk_to_spatial,
    spatial_to_gridk,
)
from cloud_transformers_tpu_torch.nn import grouped_conv as tgcm
from cloud_transformers_tpu_torch.ops import pallas_grid_conv as tgc

CASES = [((16, 16), 4, 2), ((6, 5), 3, 2), ((8, 8), 16, 2)]


@pytest.fixture
def pallas_strategy():
    """The "pallas" grid-conv strategy on both sides, restored after."""
    jgc.set_grid_conv_strategy("pallas")
    tgcm.set_grid_conv_strategy("pallas")
    try:
        yield
    finally:
        jgc.set_grid_conv_strategy(None)
        tgcm.set_grid_conv_strategy(None)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("sizes,feat,heads", CASES)
def test_grid_conv_2d_pallas_matches_jax(pallas_strategy, sizes, feat,
                                         heads):
    b = 2
    rs = np.random.RandomState(0)
    gs = np.maximum(rs.randn(b, *sizes, heads * feat), 0).astype(np.float32)
    cot = rs.randn(b, *sizes, heads * feat).astype(np.float32)
    jmod = jgc.GridConvK(feat=feat, heads=heads, sizes=sizes)
    params = jmod.init(jax.random.PRNGKey(0),
                       j_to_gridk(jnp.asarray(gs), heads, sizes, feat))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["bias"] = rs.randn(heads * feat).astype(np.float32)

    def j_out(p, gs):
        out = jmod.apply(p, j_to_gridk(gs, heads, sizes, feat))
        return j_to_spatial(out, b, sizes, feat)

    j_fwd = j_out(params, jnp.asarray(gs))
    j_dp, j_dgs = jax.grad(lambda p, g: jnp.sum(j_out(p, g) * cot),
                           argnums=(0, 1))(params, jnp.asarray(gs))

    tmod = tgcm.GridConvK(feat, heads, sizes)
    tmod.load_state_dict(jax_to_state_dict(params))
    tgs = torch.from_numpy(gs).requires_grad_()
    launches = (tgc.grid_conv2d.launches, tgc.grid_conv2d_dw.launches)
    out = tmod(spatial_to_gridk(tgs, heads, sizes, feat))
    assert type(out.grad_fn).__name__ == "_GridConvBackward"
    t_fwd = gridk_to_spatial(out, b, sizes, feat)
    (t_fwd * torch.from_numpy(cot)).sum().backward()
    assert (tgc.grid_conv2d.launches,
            tgc.grid_conv2d_dw.launches) == launches   # CPU: plain versions

    _close(t_fwd.detach(), j_fwd)
    _close(tgs.grad, j_dgs)
    grads = port_to_jax_tree(
        {n: p.grad for n, p in tmod.named_parameters()}, params["params"])
    _close(grads["kernel"], j_dp["params"]["kernel"])
    _close(grads["bias"], j_dp["params"]["bias"])
    assert np.abs(grads["kernel"]).max() > 0


def test_strategies_read_the_switch_then_the_environment(monkeypatch):
    mod = tgcm.GridConvK(2, 2, (4, 4))
    mod3 = tgcm.GridConvK(2, 2, (16, 16, 16))
    gk = torch.randn(4, 16, 2, requires_grad=True)
    gk3 = torch.randn(4, 16 ** 3, 2, requires_grad=True)

    def kind(m, g):
        return type(m(g).grad_fn).__name__

    monkeypatch.delenv("CT_GRID_CONV", raising=False)
    monkeypatch.delenv("CT_BLOCK_FUSION", raising=False)
    try:
        # "auto": 2D to the library conv, 3D with X >= 16 to the kernel
        assert kind(mod, gk) != "_GridConvBackward"
        assert kind(mod3, gk3) == "_GridConvBackward"
        assert tgcm.block_fusion_strategy((4, 4)) == "ops"
        monkeypatch.setenv("CT_GRID_CONV", "pallas")
        monkeypatch.setenv("CT_BLOCK_FUSION", "fused")
        assert kind(mod, gk) == "_GridConvBackward"
        assert tgcm.block_fusion_strategy((4, 4)) == "fused"
        tgcm.set_grid_conv_strategy("xla")      # the switch wins
        tgcm.set_block_fusion("ops")
        assert kind(mod3, gk3) != "_GridConvBackward"
        assert tgcm.block_fusion_strategy((4, 4)) == "ops"
        tgcm.set_block_fusion("auto")
        assert tgcm.block_fusion_strategy((16, 16, 16)) == "ops"
        tgcm.set_grid_conv_strategy("nonsense")
        with pytest.raises(ValueError):
            mod(gk)
    finally:
        tgcm.set_grid_conv_strategy(None)
        tgcm.set_block_fusion(None)


def test_plain_dw_2d_matches_conv2d_weight_gradient():
    """The 2D weight-gradient kernel's plain version is the gradient of the
    grouped 'same' conv2d for its weight, in the parameter layout."""
    sizes, f, h, b = (6, 5), 3, 2, 2
    gen = torch.Generator().manual_seed(0)
    grid = torch.randn(b * h, 30, f, generator=gen)
    g = torch.randn(b * h, 30, f, generator=gen)
    weight = torch.randn(h * f, f, 3, 3, generator=gen).requires_grad_()
    bias = torch.randn(h * f, generator=gen)
    got = tgc.grid_conv2d_dw(grid, g, sizes, h)
    assert tgc.grid_conv2d_dw.launches == 0

    def cf(t):
        return t.reshape(b, h, *sizes, f).movedim(-1, 2).reshape(
            b, h * f, *sizes)
    out = F.conv2d(cf(grid), weight, bias, padding=1, groups=h)
    _close(cf(tgc.grid_conv2d(grid, weight.detach(), bias, sizes, h)),
           out.detach())
    (out * cf(g)).sum().backward()
    _close(got, weight.grad)


def test_transpose_weight_2d_is_pack_m2d_transposed():
    """``transpose_weight`` makes, for 2D weights, the weights that the JAX
    package's ``pack_m2d_transposed`` packs; the conv on them is the
    adjoint of the conv in its input."""
    sizes, f, h = (8, 8), 4, 2
    rs = np.random.RandomState(1)
    kernel = rs.randn(3, 3, f, h * f).astype(np.float32)          # HWIO
    weight = jax_to_state_dict({"params": {"kernel": kernel}})["weight"]
    w_t = tgc.transpose_weight(weight, h)
    kernel_t = w_t.numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(
        np.asarray(pack_m2d(jnp.asarray(kernel_t), f, h, sizes)),
        np.asarray(pack_m2d_transposed(jnp.asarray(kernel), f, h, sizes)))
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2 * h, 64, f, generator=gen)
    g = torch.randn(2 * h, 64, f, generator=gen)
    zero = torch.zeros(h * f)
    lhs = (tgc.grid_conv2d(x, weight, zero, sizes, h) * g).sum()
    rhs = (x * tgc.grid_conv2d(g, w_t, zero, sizes, h)).sum()
    assert abs(float(lhs - rhs)) <= 1e-4 * max(1.0, abs(float(lhs)))


@pytest.mark.parametrize("feat,dim,conv_smem,threads,dw_smem", [
    (32, 3, 110592, 1024, 110592),     # 8^3 x 32 under "pallas"
    (32, 2, 82944, 192, 74240),        # conv2d_tiling's 16 x 16 tile
    (16, 3, 27648, 256, 27648),
    (4, 3, 1728, 256, 27648),          # 16 cells a pass per (fi, fo)
    (21, 3, 47628, 441, 47628),        # the old static limit
])
def test_kernel_config_lifts_the_width_to_32(feat, dim, conv_smem, threads,
                                             dw_smem):
    cfg = tgc.kernel_config(feat, dim)
    assert (cfg["conv_smem"], cfg["dw_threads"], cfg["dw_smem"]) == (
        conv_smem, threads, dw_smem)
    assert max(conv_smem, dw_smem) <= tgc.MAX_SMEM


@pytest.mark.parametrize("feat", [33, 0])
def test_kernel_config_rejects_widths_the_kernels_do_not_take(feat):
    with pytest.raises(ValueError):
        tgc.kernel_config(feat, 3)


def test_grid_conv2d_validates_inputs():
    grid = torch.zeros(4, 16, 4)
    with pytest.raises(ValueError):
        tgc.grid_conv2d(grid, torch.zeros(8, 4, 3, 3, 3), torch.zeros(8),
                        (4, 4), 2)                  # a 3D weight
    with pytest.raises(ValueError):
        tgc.grid_conv2d(grid, torch.zeros(8, 4, 3, 3), torch.zeros(8),
                        (2, 2, 4), 2)               # 3D sizes
    with pytest.raises(ValueError):
        tgc.grid_conv2d_dw(grid, torch.zeros(4, 16, 3), (4, 4), 2)


# (sizes, F, rows, heads): the classifier's 2D head groups at R = 128, then
# ragged grids at every compile-time F and at run-time ones
TILING_CASES = ([((128, 128), 4, 128, 16), ((64, 64), 16, 128, 16),
                 ((16, 16), 16, 128, 16)]
                + [(sizes, f, 8, 4) for sizes in ((6, 5), (1, 7), (65, 33))
                   for f in (1, 3, 4, 8, 16, 32)])


@pytest.mark.parametrize("sizes,feat,rows,heads", TILING_CASES)
def test_conv2d_tiling_reaches_every_cell_once(sizes, feat, rows, heads):
    """The index arithmetic of ``conv2d_fwd_kernel`` and
    ``conv2d_dw_kernel`` on ``conv2d_tiling``'s numbers: each output cell
    and channel is written by one thread; each (batch member, cell) is
    summed by one (block, split) of its head; each (fo, fi, tap) of the
    weight gradient is kept by one thread of a split; every block writes
    its scratch row; threads and shared memory stay within a block's."""
    cfg = tgc.conv2d_tiling(sizes, feat, rows, heads)
    x, y = sizes
    tx, ty = cfg["tile"]
    cx = tgc.CELLS_X
    assert cfg["conv_threads"] <= 1024 and cfg["dw_threads"] <= 1024
    assert max(cfg["conv_smem"], cfg["dw_smem"]) <= tgc.MAX_SMEM
    assert tx % cx == 0 and cfg["ys"] >= ty + 2
    # forward: block (tile), thread (fo group, x run, y), cells along x
    tiles_y = -(-y // ty)
    n_tiles = -(-x // tx) * tiles_y
    assert cfg["conv_blocks"] == rows * n_tiles
    t = np.arange(cfg["conv_threads"])
    per_group = tx // cx * ty
    fo0 = t // per_group * cfg["fo"]
    xr, ly = t % per_group // ty, t % per_group % ty
    written = np.zeros((x, y, feat), int)
    for tile in range(n_tiles):
        x0, y0 = tile // tiles_y * tx, tile % tiles_y * ty
        for j in range(cx):
            for o in range(cfg["fo"]):
                cx_, cy_, co = x0 + xr * cx + j, y0 + ly, fo0 + o
                keep = (cx_ < x) & (cy_ < y) & (co < feat)
                np.add.at(written, (cx_[keep], cy_[keep], co[keep]), 1)
    assert (written == 1).all()
    if (sizes, feat) in (((128, 128), 4), ((64, 64), 16), ((16, 16), 16)):
        assert tgc._bank_conflict(cfg["ys"], tx, ty,
                                  cfg["conv_threads"]) == 1
    # weight gradient: units (batch member, tile) over NB blocks a head,
    # cells over S splits, (fo, fi, tap) over the quads
    nb, split = cfg["dw_blocks"], cfg["dw_split"]
    units = rows // heads * n_tiles
    assert cfg["partial_rows"] == nb and 1 <= nb <= units
    taken = np.zeros(units, int)
    for j in range(nb):
        taken[j::nb] += 1
    assert (taken == 1).all()
    summed = np.zeros(tx * ty, int)
    for s in range(split):
        summed[s::split] += 1
    assert (summed == 1).all()
    padded = -(-feat // 4) * 4
    na = padded // 4
    assert cfg["dw_threads"] == cfg["dw_quads"] * split == 3 * na * na * split
    kept = np.zeros((padded, padded, 9), int)
    for q in range(cfg["dw_quads"]):
        for e in range(tgc.DW_SUMS):
            kept[4 * (q % na) + e // 4 % 4, 4 * (q // na % na) + e % 4,
                 q // (na * na) * 3 + e // 16] += 1
    assert (kept == 1).all()


def test_conv2d_tiling_fills_the_card_and_caches():
    """Small grids get smaller tiles (16^2 x 16 at R = 128: 8 x 8, four
    blocks per SM), the classifier's large grids keep the default tile, and
    the tiling is computed once per shape."""
    small = tgc.conv2d_tiling((16, 16), 16, 128, 16)
    assert small["tile"] == (8, 8) and small["conv_blocks"] >= 2 * tgc.SMS
    assert tgc.conv2d_tiling((64, 64), 16, 128, 16)["tile"] == (16, 16)
    assert tgc.conv2d_tiling([128, 128], 4, 128, 16)["tile"] == (32, 32)
    hits = tgc._conv2d_tiling.cache_info().hits
    tgc.conv2d_tiling((16, 16), 16, 128, 16)["tile"] = None   # a copy
    assert tgc.conv2d_tiling((16, 16), 16, 128, 16)["tile"] == (8, 8)
    assert tgc._conv2d_tiling.cache_info().hits == hits + 2
    with pytest.raises(ValueError):
        tgc.conv2d_tiling((16, 16), 33, 128, 16)
