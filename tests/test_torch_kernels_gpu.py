"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip without
one; they import no JAX, so they run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)

``chip_smoke.py`` runs the same comparison at the models' full shapes.
"""

import pytest
import torch

from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
from cloud_transformers_tpu_torch.core import splat_slice as tss
from cloud_transformers_tpu_torch.core.splat_slice import (
    _flatten_mapping,
    _SliceGather,
)
from cloud_transformers_tpu_torch.losses import emd as temd
from cloud_transformers_tpu_torch.nn import grouped_conv as tgcm
from cloud_transformers_tpu_torch.nn.grouped_conv import GridConvK
from cloud_transformers_tpu_torch.ops import pallas_emd as tpe
from cloud_transformers_tpu_torch.ops import pallas_fused_block as tfb
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
    ref = tgc.grid_conv_plain(grid, weight, bias, sizes, h)
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
    # summed in fixed point: the same in every run
    assert torch.equal(d_grid, tps.slice_bwd(*mapping, g_pts, dense,
                                             sizes)[0])
    _close(d_grid, p_grid, 1e-5)
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
    _close(out, tgc.grid_conv_dw_plain(grid, g, sizes, h), 1e-5)
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
    wide = torch.zeros(2, 8, 33, device="cuda")
    with pytest.raises(ValueError):
        tgc.grid_conv3d_dw(wide, wide, (2, 2, 2), 2)     # F > 32


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


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,m", [(2, 4096, 4096), (1, 700, 2500),
                                   (2, 33, 5), (1, 1, 1)])
def test_top2_kernel_matches_plain(gen, b, w, m):
    """Every lane split the widths pick (4096 x 2 bidders take 16 lanes
    each, the narrow ones 32), ragged tiles, fewer targets than lanes, and
    exact duplicates: bit for bit, the kernel rounding as the plain
    version does."""
    x1 = torch.rand(b, w, 3, generator=gen, device="cuda")
    x2 = torch.rand(b, m, 3, generator=gen, device="cuda")
    x2[:, m // 2:] = x2[:, :m - m // 2]         # duplicated targets
    price = torch.rand(b, m, generator=gen, device="cuda") * 0.1
    price[:, m // 2:] = price[:, :m - m // 2]
    n = tpe.top2.launches
    got = tpe.top2(x1, x2, price)
    assert tpe.top2.launches == n + 1
    ref = tpe.top2_plain(x1, x2, price, chunk_size=1024)
    assert got[2].dtype == torch.int32
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    if m == 1:
        assert bool((got[1] == -1e9).all())


def _window_inputs(gen, b, n, w, eps):
    x1 = torch.rand(b, n, 3, generator=gen, device="cuda")
    x2 = torch.rand(b, n, 3, generator=gen, device="cuda")
    state = temd._init_state(b, n, n, "cuda")
    while temd._max_unassigned(state[0]) > 2 * w:
        state = temd._auction_round(x1, x2, eps, 2048, state, last=False)
    idx = temd._compact_unassigned(state[0][:, :n], w)
    x1w = torch.gather(x1, 1, idx.clamp(max=n - 1)[..., None]
                       .expand(-1, -1, 3)).contiguous()
    return (x1w, idx.int().contiguous(), x2, state[2], state[1].int())


@pytest.mark.gpu
@pytest.mark.parametrize("n,w,rem", [(2048, 128, 64), (2048, 128, 3),
                                     (40000, 256, 8)])
def test_auction_window_kernel_matches_plain(gen, n, w, rem):
    """Owner map and rounds used equal, prices bit for bit; the same over
    two calls; the inputs untouched.  n=40000 keeps the state in device
    memory (it does not fit in one block's shared memory)."""
    eps = 0.01
    args = _window_inputs(gen, 2, n, w, eps)
    price_in, owner_in = args[3].clone(), args[4].clone()
    count = tpe.auction_window.launches
    got = tpe.auction_window(*args, rem, eps, n, rounds_cap=64)
    assert tpe.auction_window.launches == count + 1
    ref = tpe.auction_window_plain(*args, rem, eps, n, rounds_cap=64)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert float((got[0] - ref[0]).abs().max()) <= 2e-5
    assert 1 <= int(got[2].max()) <= min(rem, 64)
    again = tpe.auction_window(*args, rem, eps, n, rounds_cap=64)
    for a, c in zip(got, again):
        assert torch.equal(a, c)
    assert torch.equal(args[3], price_in) and torch.equal(args[4], owner_in)


@pytest.mark.gpu
def test_emd_auction_on_the_card_goes_through_the_kernels(gen, monkeypatch):
    n = 4096
    x2 = torch.rand(2, n, 3, generator=gen, device="cuda")
    x1 = (x2[:, torch.randperm(n, device="cuda")]
          + 0.01 * torch.randn(2, n, 3, generator=gen, device="cuda"))
    count = tpe.top2.launches
    dist, assignment, rounds = temd.emd_auction_with_rounds(
        x1, x2, eps=0.004, iters=3000)
    assert tpe.top2.launches == count + rounds
    cpu = temd.emd_auction_with_rounds(x1.cpu(), x2.cpu(), eps=0.004,
                                       iters=3000)
    assert abs(float(dist.sum()) - float(cpu[0].sum())) \
        <= 0.02 * float(cpu[0].sum())
    monkeypatch.setattr(temd, "_WINDOW_TAIL", True)
    windows = tpe.auction_window.launches
    d_w, a_w, r_w = temd.emd_auction_with_rounds(x1, x2, eps=0.004,
                                                 iters=3000)
    assert tpe.auction_window.launches > windows and r_w < 2999
    assert all(int(torch.unique(row).numel()) == n for row in a_w)
    assert abs(float(d_w.sum()) - float(dist.sum())) \
        <= 0.02 * float(dist.sum())


@pytest.mark.gpu
def test_emd_wrappers_raise_on_the_card(gen):
    x = torch.zeros(1, 8, 3, device="cuda")
    with pytest.raises(ValueError):
        tpe.top2(x, x, torch.zeros(1, 8))            # price on the CPU
    with pytest.raises(ValueError):
        tpe.auction_window(x, torch.zeros(1, 8, device="cuda"), x,
                           torch.zeros(1, 8, device="cuda"),
                           torch.zeros(1, 8, dtype=torch.int32,
                                       device="cuda"), 1, 0.01, 8)


# --- the slice's and the bid search's plans on the card ---------------------

# the classifier's six head-group shapes, and widths off the float4 path
SLICE_SHAPES = [((128, 128), 4), ((32, 32, 32), 4), ((64, 64), 16),
                ((16, 16, 16), 16), ((16, 16), 16), ((8, 8, 8), 32)]


def _slice_inputs(gen, sizes, f, b, h, k):
    lat = torch.tanh(torch.randn(b, k, h, len(sizes), generator=gen,
                                 device="cuda"))
    mapping = [a.contiguous() for a in
               _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))]
    values = torch.randn(b * h, k, f, generator=gen, device="cuda")
    return mapping, tps.splat_max(*mapping, values, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", SLICE_SHAPES)
def test_slice_kernel_at_the_classifier_shapes(gen, sizes, f):
    """R = 128 rows of K = 2048 points, as a forward gives them: within
    1e-5 of the plain version, and two calls equal."""
    mapping, grid = _slice_inputs(gen, sizes, f, 8, 16, 2048)
    out = tps.slice_gather(*mapping, grid, sizes)
    _close(out, tps.slice_plain(*mapping, grid, sizes), 1e-5)
    assert torch.equal(out, tps.slice_gather(*mapping, grid, sizes))


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", [(16, 16), (9, 7), (8, 8, 8), (5, 6, 7)])
@pytest.mark.parametrize("f", [1, 3, 4, 5, 16, 21, 32])
def test_slice_kernel_at_ragged_shapes(gen, sizes, f):
    """K a multiple of nothing, every group width and the scalar path."""
    mapping, grid = _slice_inputs(gen, sizes, f, 2, 3, 333)
    n = tps.slice_gather.launches
    out = tps.slice_gather(*mapping, grid, sizes)
    assert tps.slice_gather.launches == n + 1
    _close(out, tps.slice_plain(*mapping, grid, sizes), 1e-5)
    assert torch.equal(out, tps.slice_gather(*mapping, grid, sizes))
    # a grid that starts off 16 bytes: the wrapper aligns it
    shifted = torch.empty(grid.numel() + 1, device="cuda")[1:].view(
        grid.shape)
    shifted.copy_(grid)
    assert torch.equal(out, tps.slice_gather(*mapping, shifted, sizes))


@pytest.mark.gpu
def test_slice_launch_refuses_a_plan_it_did_not_make(gen):
    """The entry point recomputes the plan and launches nothing when the
    caller's numbers disagree."""
    sizes, f = (16, 16), 16
    mapping, grid = _slice_inputs(gen, sizes, f, 2, 4, 300)
    plan = tps.slice_plan(8, 300, f, sizes)
    lib = tps.cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream().cuda_stream
    launch = [8, *tps._launch_args(sizes, 300, f), plan.group,
              plan.points_per_thread, plan.threads, plan.blocks,
              int(plan.vec)]
    assert len(launch) == len(tps.SLICE_PARAMS)
    assert list(tps._slice_params(8, 300, f, sizes)[0]) == launch
    at = {n: i for i, n in enumerate(tps.SLICE_PARAMS)}
    for name, wrong in (("group", plan.group * 2), ("points_per_thread", 3),
                        ("threads", 128), ("blocks", plan.blocks + 1),
                        ("vec", 0)):
        out = torch.full((8, 300, f), 7.0, device="cuda")
        bad = list(launch)
        bad[at[name]] = wrong
        params = tps.cuda_build.int_params(*bad)
        err = lib.ct_slice(*(a.data_ptr() for a in mapping), grid.data_ptr(),
                           out.data_ptr(), params[1], stream)
        torch.cuda.synchronize()
        assert err != 0 and bool((out == 7.0).all()), (name, wrong)


def _top2_equal(x1, x2, price):
    ref = tpe.top2_plain(x1, x2, price)
    for skip in (True, False):
        got = tpe._launch_top2(x1, x2, price, skip)
        assert got[2].dtype == torch.int32
        for a, r in zip(got, ref):
            assert torch.equal(a, r), skip
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,m", [(b, w, 16384) for b in (2, 1)
                                   for w in (16384, 2048, 1024, 512, 256)]
                         + [(2, 777, 3001), (1, 300, 1), (2, 513, 65)])
def test_top2_kernel_bit_equal_at_the_staged_widths(gen, b, w, m):
    """Every width of the staged schedule, a shape that is a multiple of
    nothing, one target, a chunk of the minimum length: values and indices
    bit for bit, with the square-root skip on and off."""
    x1 = torch.rand(b, w, 3, generator=gen, device="cuda") * 2 - 1
    x2 = torch.rand(b, m, 3, generator=gen, device="cuda") * 2 - 1
    price = torch.rand(b, m, generator=gen, device="cuda") * 0.1
    n = tpe.top2.launches
    tpe.top2(x1, x2, price)
    assert tpe.top2.launches == n + 1
    ref = _top2_equal(x1, x2, price)
    if m == 1:
        assert bool((ref[1] == -1e9).all()) and bool((ref[2] == 0).all())


@pytest.mark.gpu
def test_top2_kernel_bit_equal_with_duplicates_across_chunks(gen):
    """The first chunk's targets repeated in every chunk (so each twin
    lies across a chunk boundary): the second-best equals the best and
    the first occurrence wins."""
    b, w, m = 2, 1024, 16384
    chunk = tpe.top2_plan(b, w, m).chunk_len
    period = torch.arange(m, device="cuda") % chunk
    x1 = torch.rand(b, w, 3, generator=gen, device="cuda")
    x2 = torch.rand(b, chunk, 3, generator=gen, device="cuda")[:, period]
    price = (torch.rand(b, chunk, generator=gen, device="cuda")
             * 0.05)[:, period]
    ref = _top2_equal(x1, x2.contiguous(), price.contiguous())
    assert torch.equal(ref[0], ref[1]) and bool((ref[2] < chunk).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["most", "none", "auction"])
def test_top2_kernel_bit_equal_where_the_skip_takes_most_pairs_or_none(
        gen, case):
    """"most": random prices, where almost every pair is beyond the
    second-best; "none": every target on a sphere around the bidders (all
    at one point) at price 0, so every value ties with the second-best up
    to rounding and no pair may be skipped; "auction": the prices and
    bidders of a mid-auction state."""
    b, n = 2, 4096
    if case == "auction":
        x1 = torch.rand(b, n, 3, generator=gen, device="cuda")
        x2 = torch.rand(b, n, 3, generator=gen, device="cuda")
        state = temd._init_state(b, n, n, "cuda")
        for _ in range(40):
            state = temd._auction_round(x1, x2, 0.005, 2048, state,
                                        last=False)
        price = state[2]
    elif case == "most":
        x1 = torch.rand(b, n, 3, generator=gen, device="cuda")
        x2 = torch.rand(b, n, 3, generator=gen, device="cuda")
        price = torch.rand(b, n, generator=gen, device="cuda") * 0.2
    else:
        d = torch.randn(b, n, 3, generator=gen, device="cuda")
        x2 = 0.5 + 0.25 * d / d.norm(dim=-1, keepdim=True)
        x1 = torch.full((b, 256, 3), 0.5, device="cuda")
        price = torch.zeros(b, n, device="cuda")
    _top2_equal(x1, x2, price)


@pytest.mark.gpu
def test_top2_launch_refuses_a_plan_it_did_not_make(gen):
    b, w, m = 2, 700, 5000
    x1 = torch.rand(b, w, 3, generator=gen, device="cuda")
    x2 = torch.rand(b, m, 3, generator=gen, device="cuda")
    price = torch.zeros(b, m, device="cuda")
    plan = tpe.top2_plan(b, w, m)
    scratch = torch.empty(3 * (plan.chunks + 5) * b * w, device="cuda")
    stream = tpe.cuda_build.current_stream(x1.device)
    assert stream == torch.cuda.current_stream().cuda_stream
    arrived = tpe._arrival_counts(x1.device, stream,
                                  b * (plan.bidder_blocks + 1))
    lib = tpe.cuda_build.libraries()["emd"]
    launch = [b, w, m, plan.threads, plan.group, plan.bidder_blocks,
              plan.chunks, plan.chunk_len, 1]
    for i, wrong in ((3, 128), (4, 2), (5, plan.bidder_blocks + 1),
                     (6, plan.chunks + 5), (7, plan.chunk_len // 2)):
        best = torch.full((b, w), 7.0, device="cuda")
        bad = list(launch)
        bad[i] = wrong
        params = tpe.cuda_build.int_params(*bad)
        err = lib.ct_emd_top2(x1.data_ptr(), x2.data_ptr(), price.data_ptr(),
                              best.data_ptr(), best.data_ptr(),
                              best.data_ptr(), scratch.data_ptr(),
                              arrived.data_ptr(), params[1], stream)
        torch.cuda.synchronize()
        assert err != 0 and bool((best == 7.0).all()), (i, wrong)


@pytest.mark.gpu
def test_top2_searches_on_two_streams_keep_their_counts_apart(gen):
    """Merging searches (targets cut into chunks) on two streams at once:
    each stream has its own arrival counts, and both stay bit-equal."""
    b, w, m = 1, 256, 16384
    assert tpe.top2_plan(b, w, m).merge
    inputs = [(torch.rand(b, w, 3, generator=gen, device="cuda"),
               torch.rand(b, m, 3, generator=gen, device="cuda"),
               torch.rand(b, m, generator=gen, device="cuda") * 0.1)
              for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(tpe.top2(*inputs[i]))
    torch.cuda.synchronize()
    dev = inputs[0][0].device.index
    assert streams[0].cuda_stream != streams[1].cuda_stream
    assert all((dev, s.cuda_stream) in tpe._ARRIVED for s in streams)
    for i in range(2):
        ref = tpe.top2_plain(*inputs[i])
        for got in outs[i]:
            for a, r in zip(got, ref):
                assert torch.equal(a, r), i


@pytest.mark.gpu
def test_top2_in_a_cuda_graph_matches_plain(gen):
    """A merging search captured in a CUDA graph on a stream that has run
    it once, replayed twice: bit-equal both times."""
    b, w, m = 2, 512, 16384
    x1 = torch.rand(b, w, 3, generator=gen, device="cuda")
    x2 = torch.rand(b, m, 3, generator=gen, device="cuda")
    price = torch.rand(b, m, generator=gen, device="cuda") * 0.1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpe.top2(x1, x2, price)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = tpe.top2(x1, x2, price)
    ref = tpe.top2_plain(x1, x2, price)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            assert torch.equal(a, r)


# --- the switched paths' kernels ------------------------------------------

def _mapping(gen, sizes, b, h, k, f, ties=True):
    lat = torch.tanh(torch.randn(b, k, h, len(sizes), generator=gen,
                                 device="cuda"))
    if ties:
        lat[:, 1::2] = lat[:, 0::2]         # duplicated points
    mapping = [a.contiguous() for a in
               _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))]
    values = torch.randn(b * h, k, f, generator=gen, device="cuda")
    if ties:
        values[:, 1::2] = values[:, 0::2]   # exact ties
    values[-1] = -values[-1].abs()          # all-negative row
    return mapping, values


def _weights(gen, sizes, f, h):
    dim = len(sizes)
    weight = torch.randn((h * f, f) + (3,) * dim, generator=gen,
                         device="cuda") * (3 ** dim * f) ** -0.5
    bias = torch.randn(h * f, generator=gen, device="cuda") * 0.1
    return weight, bias


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f,b,h", [
    ((16, 16), 16, 2, 4), ((64, 64), 4, 2, 4), ((6, 5), 3, 2, 4),
    ((8, 8, 8), 32, 2, 4),
    # the 2D kernels' ragged tiles, each compile-time F and a run-time one
    ((65, 33), 16, 2, 4), ((1, 7), 4, 2, 4), ((1, 7), 3, 2, 4),
    ((65, 33), 8, 2, 4), ((16, 16), 32, 2, 4), ((9, 6), 5, 2, 4),
    # the classifier's 2D shapes at R = 128
    ((128, 128), 4, 8, 16), ((64, 64), 16, 8, 16), ((16, 16), 16, 8, 16)])
def test_grid_conv_kernels_match_plain(gen, sizes, f, b, h):
    """The 2D conv and its weight gradient at ragged sizes, every
    compile-time F and a run-time F, the classifier's shapes, and the 3D
    pair at 8^3 x 32 (108 KiB of weights: opt-in shared memory): within
    1e-5; the weight gradient the same in every run."""
    cells = 1
    for s in sizes:
        cells *= s
    fwd, dw = ((tgc.grid_conv2d, tgc.grid_conv2d_dw) if len(sizes) == 2
               else (tgc.grid_conv3d, tgc.grid_conv3d_dw))
    grid = torch.randn(b * h, cells, f, generator=gen, device="cuda")
    g = torch.randn(b * h, cells, f, generator=gen, device="cuda")
    weight, bias = _weights(gen, sizes, f, h)
    n = (fwd.launches, dw.launches)
    out = fwd(grid, weight, bias, sizes, h)
    d_w = dw(grid, g, sizes, h)
    assert (fwd.launches, dw.launches) == (n[0] + 1, n[1] + 1)
    _close(out, tgc.grid_conv_plain(grid, weight, bias, sizes, h), 1e-5)
    _close(d_w, tgc.grid_conv_dw_plain(grid, g, sizes, h), 1e-5)
    assert torch.equal(d_w, dw(grid, g, sizes, h))


@pytest.mark.gpu
def test_grid_conv2d_launch_refuses_a_tiling_it_did_not_make(gen):
    """The 2D entry point recomputes threads and shared memory from the
    tiling and launches nothing when the caller's numbers disagree."""
    sizes, f, h = (16, 16), 16, 4
    grid = torch.randn(2 * h, 256, f, generator=gen, device="cuda")
    weight, bias = _weights(gen, sizes, f, h)
    out = torch.full_like(grid, 7.0)
    cfg = tgc.conv2d_tiling(sizes, f, 2 * h, h)
    lib = tgc.cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.ct_grid_conv2d(grid.data_ptr(), weight.data_ptr(),
                             bias.data_ptr(), out.data_ptr(), 2 * h, h,
                             *sizes, f, *cfg["tile"], cfg["ys"],
                             cfg["conv_threads"] + 32, cfg["conv_smem"],
                             stream)
    torch.cuda.synchronize()
    assert err != 0 and bool((out == 7.0).all())


@pytest.mark.gpu
def test_grid_conv2d_function_matches_library_backward(gen):
    """GridConvK under "pallas" on a 2D grid (forward kernel on the
    transposed weights, 2D weight-gradient kernel, summed bias) against
    autograd through conv2d."""
    sizes, f, h, b = (16, 16), 16, 2, 2
    mod = GridConvK(f, h, sizes).cuda()
    with torch.no_grad():
        mod.weight.copy_(_weights(gen, sizes, f, h)[0])
        mod.bias.copy_(torch.randn(h * f, generator=gen, device="cuda"))
    gk = torch.randn(b * h, 256, f, generator=gen,
                     device="cuda").requires_grad_()
    cot = torch.randn(b * h, 256, f, generator=gen, device="cuda")
    before = (tgc.grid_conv2d.launches, tgc.grid_conv2d_dw.launches)
    tgcm.set_grid_conv_strategy("pallas")
    try:
        mod(gk).backward(cot)
    finally:
        tgcm.set_grid_conv_strategy(None)
    assert (tgc.grid_conv2d.launches - before[0],
            tgc.grid_conv2d_dw.launches - before[1]) == (2, 1)

    def cf(t):
        return t.reshape(b, h, *sizes, f).movedim(-1, 2).reshape(
            b, h * f, *sizes)
    torch.backends.cudnn.allow_tf32 = False
    x = gk.detach().clone().requires_grad_()
    w = mod.weight.detach().clone().requires_grad_()
    bias = mod.bias.detach().clone().requires_grad_()
    (torch.nn.functional.conv2d(cf(x), w, bias, padding=1, groups=h)
     * cf(cot)).sum().backward()
    for a, ref in zip((gk.grad, mod.weight.grad, mod.bias.grad),
                      (x.grad, w.grad, bias.grad)):
        _close(a, ref, 1e-5)


# the 3D kernels' ragged tiles at every compile-time F and two run-time
# ones, then the classifier's 3D shapes at R = 128
CONV3D_CASES = ([(sizes, f, 2, 4) for sizes in ((5, 7, 9), (1, 3, 17),
                                                  (9, 1, 4))
                 for f in (4, 8, 16, 32, 3, 21)]
                + [((32, 32, 32), 4, 8, 16), ((16, 16, 16), 16, 8, 16),
                   ((8, 8, 8), 32, 8, 16)])


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f,b,h", CONV3D_CASES)
def test_grid_conv3d_kernels_match_plain(gen, sizes, f, b, h):
    """The 3D conv and its weight gradient on ``conv3d_tiling``'s numbers:
    within 1e-5 of the plain versions, one launch each, the weight
    gradient bit-equal across two runs."""
    cells = sizes[0] * sizes[1] * sizes[2]
    grid = torch.randn(b * h, cells, f, generator=gen, device="cuda")
    g = torch.randn(b * h, cells, f, generator=gen, device="cuda")
    weight, bias = _weights(gen, sizes, f, h)
    n = (tgc.grid_conv3d.launches, tgc.grid_conv3d_dw.launches)
    out = tgc.grid_conv3d(grid, weight, bias, sizes, h)
    d_w = tgc.grid_conv3d_dw(grid, g, sizes, h)
    assert (tgc.grid_conv3d.launches, tgc.grid_conv3d_dw.launches) == (
        n[0] + 1, n[1] + 1)
    _close(out, tgc.grid_conv_plain(grid, weight, bias, sizes, h), 1e-5)
    _close(d_w, tgc.grid_conv_dw_plain(grid, g, sizes, h), 1e-5)
    assert torch.equal(d_w, tgc.grid_conv3d_dw(grid, g, sizes, h))


@pytest.mark.gpu
def test_grid_conv3d_launch_refuses_a_tiling_it_did_not_make(gen):
    """The 3D entry points recompute threads and shared memory from the
    tiling and launch nothing (not even the weight packing) when the
    caller's numbers disagree."""
    sizes, f, h = (8, 8, 8), 32, 4
    grid = torch.randn(2 * h, 512, f, generator=gen, device="cuda")
    weight, bias = _weights(gen, sizes, f, h)
    cfg = tgc.conv3d_tiling(sizes, f, 2 * h, h)
    out = torch.full_like(grid, 7.0)
    wpack = torch.full((cfg["pack_floats"],), 7.0, device="cuda")
    partial = torch.full((cfg["partial_rows"] * h * f * f * 27,), 7.0,
                         device="cuda")
    d_w = torch.full_like(weight, 7.0)
    lib = tgc.cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream().cuda_stream
    errs = [
        lib.ct_grid_conv3d(grid.data_ptr(), weight.data_ptr(),
                           bias.data_ptr(), out.data_ptr(), wpack.data_ptr(),
                           2 * h, h, *sizes, f, *cfg["tile"], cfg["zs"],
                           cfg["conv_threads"] + 32, cfg["conv_smem"],
                           stream),
        lib.ct_grid_conv3d(grid.data_ptr(), weight.data_ptr(),
                           bias.data_ptr(), out.data_ptr(), wpack.data_ptr(),
                           2 * h, h, *sizes, f, *cfg["tile"], cfg["zs"],
                           cfg["conv_threads"], cfg["conv_smem"] + 4,
                           stream),
        lib.ct_grid_conv3d_dw(grid.data_ptr(), grid.data_ptr(),
                              partial.data_ptr(), d_w.data_ptr(), 2 * h, h,
                              *sizes, f, *cfg["dw_tile"], cfg["dw_zs"],
                              cfg["dw_gz"], cfg["dw_slice_quads"],
                              cfg["partial_rows"],
                              cfg["dw_threads"] + 1, cfg["dw_smem"], stream)]
    torch.cuda.synchronize()
    assert all(err != 0 for err in errs)
    for t in (out, wpack, partial, d_w):
        assert bool((t == 7.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((8, 8, 8), 32), ((5, 7, 9), 3)])
def test_grid_conv3d_function_matches_library_backward(gen, sizes, f):
    """GridConvK under "pallas" on a 3D grid (forward kernel on the
    transposed weights for the input gradient, 3D weight-gradient kernel,
    summed bias) against autograd through conv3d."""
    h, b = 2, 2
    cells = sizes[0] * sizes[1] * sizes[2]
    mod = GridConvK(f, h, sizes).cuda()
    with torch.no_grad():
        mod.weight.copy_(_weights(gen, sizes, f, h)[0])
        mod.bias.copy_(torch.randn(h * f, generator=gen, device="cuda"))
    gk = torch.randn(b * h, cells, f, generator=gen,
                     device="cuda").requires_grad_()
    cot = torch.randn(b * h, cells, f, generator=gen, device="cuda")
    before = (tgc.grid_conv3d.launches, tgc.grid_conv3d_dw.launches)
    tgcm.set_grid_conv_strategy("pallas")
    try:
        mod(gk).backward(cot)
    finally:
        tgcm.set_grid_conv_strategy(None)
    assert (tgc.grid_conv3d.launches - before[0],
            tgc.grid_conv3d_dw.launches - before[1]) == (2, 1)

    def cf(t):
        return t.reshape(b, h, *sizes, f).movedim(-1, 2).reshape(
            b, h * f, *sizes)
    torch.backends.cudnn.allow_tf32 = False
    x = gk.detach().clone().requires_grad_()
    w = mod.weight.detach().clone().requires_grad_()
    bias = mod.bias.detach().clone().requires_grad_()
    (torch.nn.functional.conv3d(cf(x), w, bias, padding=1, groups=h)
     * cf(cot)).sum().backward()
    for a, ref in zip((gk.grad, mod.weight.grad, mod.bias.grad),
                      (x.grad, w.grad, bias.grad)):
        _close(a, ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((16, 16), 8), ((16, 16, 16), 4),
                                     ((8, 8, 8), 32), ((8, 8, 8), 5)])
def test_winner_splat_and_routing_match_plain(gen, sizes, f):
    """The winner-tracking splat: the grid bit-equal to splat_max's, the
    map equal to the plain version's, exact-tie duplicates going to the
    lower index; the routing pass alone bit-equal to the two-pass
    backward's."""
    mapping, values = _mapping(gen, sizes, 2, 4, 256, f)
    n = tps.splat_max_winner.launches
    grid, winner = tps.splat_max_winner(*mapping, values, sizes)
    assert tps.splat_max_winner.launches == n + 1
    assert torch.equal(grid, tps.splat_max(*mapping, values, sizes))
    assert winner.dtype == torch.int32
    assert torch.equal(winner, tps.splat_winner_plain(*mapping, values, grid,
                                                      sizes))
    assert (winner[grid == 0] == tps.NO_WINNER).all()
    assert not (winner % 2 == 1)[winner != tps.NO_WINNER].any()
    again = tps.splat_max_winner(*mapping, values, sizes)
    assert torch.equal(again[0], grid) and torch.equal(again[1], winner)

    g = torch.randn(grid.shape, generator=gen, device="cuda")
    n = tps.splat_route.launches
    routed = tps.splat_route(*mapping, values, winner, g, sizes)
    assert tps.splat_route.launches == n + 1
    two_pass = tps.splat_max_bwd(*mapping, values, grid, g, sizes)
    plain = tps.splat_route_plain(*mapping, values, winner, g, sizes)
    for a, b, p in zip(routed, two_pass, plain):
        assert torch.equal(a, b)
        _close(a, p, 1e-6)
    assert not routed[2][:, 1::2].any() and routed[2][:, 0::2].any()


@pytest.mark.gpu
def test_fwd_winner_step_goes_through_the_routed_backward(gen, monkeypatch):
    """FWD_WINNER on the card: a splat under a gradient launches the
    winner splat and the routing pass, not the two-pass backward, and its
    gradients equal the two-pass path's bit for bit (the grid's cotangent
    is fixed: the slice backward's float atomics would vary it from run to
    run); under no_grad it launches the plain splat."""
    sizes, b, h, k, f = (16, 16, 16), 2, 4, 256, 4
    keys = torch.tanh(torch.randn(b, k, h, 3, generator=gen, device="cuda"))
    keys[:, 1::2] = keys[:, 0::2]
    values = torch.randn(b, k, h * f, generator=gen, device="cuda")
    cot = torch.randn(b * h, 16 ** 3, f, generator=gen, device="cuda")
    grads = {}
    for fw in (False, True):
        monkeypatch.setattr(tss, "FWD_WINNER", fw)
        kk, vv = keys.clone().requires_grad_(), values.clone().requires_grad_()
        counts = [w.launches for w in (tps.splat_max, tps.splat_max_winner,
                                       tps.splat_route, tps.splat_max_bwd)]
        m = grid_mapping(kk, sizes, 3)
        gk = tss.splat_max_mapping_k(m, vv, sizes)
        (gk * cot).sum().backward()
        used = [w.launches - c for w, c in zip(
            (tps.splat_max, tps.splat_max_winner, tps.splat_route,
             tps.splat_max_bwd), counts)]
        assert used == ([0, 1, 1, 0] if fw else [1, 0, 0, 1])
        grads[fw] = (kk.grad, vv.grad)
        with torch.no_grad():
            tss.splat_max_mapping_k(m, vv, sizes)
        assert tps.splat_max_winner.launches == counts[1] + used[1]
    for a, c in zip(grads[False], grads[True]):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((16, 16), 16), ((64, 64), 16),
                                     ((128, 128), 4), ((8, 8, 8), 32),
                                     ((16, 16, 16), 16), ((6, 5, 7), 3)])
@pytest.mark.parametrize("want_gk2", [False, True])
def test_fused_block_kernel_matches_plain(gen, sizes, f, want_gk2):
    """The fused block on its clusters at the head groups' sizes and a
    ragged one: gk bit-equal to splat_max's, the points and gk2 within 1e-5
    of the plain composition."""
    h = 4
    mapping, values = _mapping(gen, sizes, 2, h, 512, f, ties=False)
    weight, bias = _weights(gen, sizes, f, h)
    n = tfb.fused_block.launches
    got = tfb.fused_block(*mapping, values, weight, bias, sizes, h,
                          want_gk2=want_gk2)
    assert tfb.fused_block.launches == n + 1
    ref = tfb.fused_block_plain(*mapping, values, weight, bias, sizes, h,
                                want_gk2=True)
    assert len(got) == (3 if want_gk2 else 2)
    assert torch.equal(got[1], tps.splat_max(*mapping, values, sizes))
    assert torch.equal(got[1], ref[1])
    _close(got[0], ref[0], 1e-5)
    if want_gk2:
        _close(got[2], ref[2], 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("tensor_size,dim", [(8, 3), (16, 2)])
def test_fused_multihead_backward_matches_ops_on_the_card(gen, tensor_size,
                                                          dim):
    """MultiHead with the fused block against the "ops" path with the same
    weights, forward and backward, on the card."""
    from cloud_transformers_tpu_torch.nn.multihead import MultiHead
    torch.manual_seed(0)
    mod = MultiHead(32, 8, tensor_size, dim, 4).cuda().train()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0, 0.3, generator=gen)
    x = torch.randn(2, 512, 32, generator=gen, device="cuda")
    pcd = torch.rand(2, 512, 3, generator=gen, device="cuda") * 2 - 1
    runs = {}
    n = tfb.fused_block.launches
    try:
        for mode in ("ops", "fused"):
            tgcm.set_block_fusion(mode)
            mod.zero_grad()
            out, _ = mod(x, pcd)
            (out ** 2).sum().backward()
            runs[mode] = (out.detach(), {name: p.grad.clone()
                                        for name, p in mod.named_parameters()})
    finally:
        tgcm.set_block_fusion(None)
    assert tfb.fused_block.launches == n + 1
    _close(runs["fused"][0], runs["ops"][0], 1e-5)
    scale = max(float(g.abs().max()) for g in runs["ops"][1].values())
    for name, ref in runs["ops"][1].items():
        err = float((runs["fused"][1][name] - ref).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.gpu
def test_switched_wrappers_validate_inputs(gen):
    mapping, values = _mapping(gen, (4, 4), 1, 2, 8, 4, ties=False)
    weight, bias = _weights(gen, (4, 4), 4, 2)
    with pytest.raises(ValueError):
        tfb.fused_block(*mapping, values, weight.cpu(), bias, (4, 4), 2)
    with pytest.raises(ValueError):
        tps.splat_route(*mapping, values,
                        torch.zeros(2, 16, 4, device="cuda"),   # float map
                        torch.zeros(2, 16, 4, device="cuda"), (4, 4))
    wide = torch.zeros(2, 16, 33, device="cuda")
    with pytest.raises(ValueError):
        tgc.grid_conv2d(wide, torch.zeros(66, 33, 3, 3, device="cuda"),
                        torch.zeros(66, device="cuda"), (4, 4), 2)


# --- the fused block on clusters and the point-major splat backward -------

RAGGED_SIZES = [(16, 16), (9, 7), (8, 8, 8), (5, 6, 7)]
RAGGED_F = [1, 3, 4, 5, 8, 16, 21, 32]


def _fused_check(gen, sizes, f, b, h, k, ties=False):
    """One fused block with and without gk2 against the plain composition:
    gk bit-equal to splat_max's, the points and gk2 within 1e-5, and a
    second run bit-equal to the first."""
    mapping, values = _mapping(gen, sizes, b, h, k, f, ties=ties)
    weight, bias = _weights(gen, sizes, f, h)
    ref = tfb.fused_block_plain(*mapping, values, weight, bias, sizes, h,
                                want_gk2=True)
    for want in (False, True):
        n = tfb.fused_block.launches
        got = tfb.fused_block(*mapping, values, weight, bias, sizes, h,
                              want_gk2=want)
        assert tfb.fused_block.launches == n + 1
        assert torch.equal(got[1], ref[1])
        assert torch.equal(got[1], tps.splat_max(*mapping, values, sizes))
        _close(got[0], ref[0], 1e-5)
        if want:
            _close(got[2], ref[2], 1e-5)
        again = tfb.fused_block(*mapping, values, weight, bias, sizes, h,
                                want_gk2=want)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
    return tfb.fused_block_plan(b * h, k, f, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", RAGGED_SIZES)
@pytest.mark.parametrize("f", RAGGED_F)
def test_fused_block_cluster_at_ragged_shapes(gen, sizes, f):
    """Ragged slabs (X a multiple of nothing), every lane group, the scalar
    path, duplicated points, and 2D mappings' zero-weight slots."""
    plan = _fused_check(gen, sizes, f, 2, 3, 334, ties=True)
    assert plan.path == "cluster"


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f,b,h,k", [
    ((32, 32, 32), 4, 1, 4, 2000),    # few rows: a 16-CTA cluster
    ((64, 64), 16, 1, 2, 1500),
    ((8, 8, 8), 32, 2, 16, 16384),    # the completion decoder's rows
    ((128, 128), 32, 1, 2, 700)])     # no cluster fits: device memory
def test_fused_block_cluster_sizes_and_the_device_memory_path(
        gen, sizes, f, b, h, k):
    plan = _fused_check(gen, sizes, f, b, h, k)
    assert plan.path == ("device_memory" if f == 32 and sizes[0] == 128
                         else "cluster")
    if sizes == (32, 32, 32):
        assert plan.cluster == 16


@pytest.mark.gpu
def test_fused_block_launch_refuses_a_plan_it_did_not_make(gen):
    sizes, f, h = (16, 16, 16), 16, 4
    mapping, values = _mapping(gen, sizes, 2, h, 300, f, ties=False)
    weight, bias = _weights(gen, sizes, f, h)
    good = list(tfb._fused_params(8, h, 300, f, sizes, True)[0])
    assert len(good) == len(tfb.FUSED_PARAMS)
    at = {n: i for i, n in enumerate(tfb.FUSED_PARAMS)}
    lib = tfb.cuda_build.libraries()["fused_block"]
    stream = torch.cuda.current_stream().cuda_stream
    for name, wrong in (("cluster", good[at["cluster"]] * 2),
                        ("slab", good[at["slab"]] + 1), ("threads", 256),
                        ("smem", good[at["smem"]] - 16),
                        ("blocks", good[at["blocks"]] + 1), ("group", 8),
                        ("feat", 33)):
        outs = [torch.full((8, n, f), 7.0, device="cuda")
                for n in (300, 16 ** 3, 16 ** 3)]
        bad = list(good)
        bad[at[name]] = wrong
        params = tfb.cuda_build.int_params(*bad)
        err = lib.ct_fused_block(
            *(a.data_ptr() for a in (*mapping, values, weight, bias)),
            *(o.data_ptr() for o in outs), params[1], stream)
        torch.cuda.synchronize()
        assert err != 0 and all(bool((o == 7.0).all()) for o in outs), name


def _graph_replays(fn):
    """``fn()``'s outputs from a CUDA graph of one call, replayed twice,
    after a warm-up on the capture stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = fn()
    runs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        runs.append([t.clone() for t in got])
    return runs


@pytest.mark.gpu
def test_fused_block_and_splat_backward_in_a_cuda_graph(gen):
    sizes, f, h = (16, 16, 16), 16, 4
    mapping, values = _mapping(gen, sizes, 2, h, 512, f)
    weight, bias = _weights(gen, sizes, f, h)
    ref = tfb.fused_block(*mapping, values, weight, bias, sizes, h,
                          want_gk2=True)
    for run in _graph_replays(lambda: tfb.fused_block(
            *mapping, values, weight, bias, sizes, h, want_gk2=True)):
        assert all(torch.equal(a, b) for a, b in zip(run, ref))
    grid = ref[1]
    g = torch.randn(grid.shape, generator=gen, device="cuda")
    ref = tps.splat_max_bwd(*mapping, values, grid, g, sizes,
                            return_winner=True)
    for run in _graph_replays(lambda: tps.splat_max_bwd(
            *mapping, values, grid, g, sizes, return_winner=True)):
        assert all(torch.equal(a, b) for a, b in zip(run, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", RAGGED_SIZES)
@pytest.mark.parametrize("f", RAGGED_F)
def test_splat_backward_at_ragged_shapes(gen, sizes, f):
    """Both passes at every lane group and on the scalar path: the winner
    map equal to the plain one, ties routed to the lower index, the
    gradients within 1e-6, the routing pass alone bit-equal to the two-pass
    backward, two runs bit-equal, 2D slots 2 and 3 at zero."""
    mapping, values = _mapping(gen, sizes, 2, 3, 334, f)
    grid = tps.splat_max(*mapping, values, sizes)
    g = torch.randn(grid.shape, generator=gen, device="cuda")
    n = tps.splat_max_bwd.launches
    got = tps.splat_max_bwd(*mapping, values, grid, g, sizes,
                            return_winner=True)
    assert tps.splat_max_bwd.launches == n + 1
    winner = got[3]
    assert torch.equal(winner, tps.splat_winner_plain(*mapping, values, grid,
                                                      sizes))
    assert not (winner % 2 == 1)[winner != tps.NO_WINNER].any()
    plain = tps.splat_max_bwd_plain(*mapping, values, grid, g, sizes)
    assert torch.equal(got[2] != 0, plain[2] != 0)
    for a, p in zip(got, plain):
        _close(a, p, 1e-6)
    again = tps.splat_max_bwd(*mapping, values, grid, g, sizes,
                              return_winner=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    routed = tps.splat_route(*mapping, values, winner, g, sizes)
    assert all(torch.equal(a, b) for a, b in zip(routed, got[:3]))
    assert not got[2][:, 1::2].any()
    if len(sizes) == 2:
        assert not got[0][..., 2:].any() and not got[1][..., 2:].any()


@pytest.mark.gpu
def test_splat_backward_launch_refuses_a_plan_it_did_not_make(gen):
    sizes, f = (16, 16), 16
    mapping, values = _mapping(gen, sizes, 2, 4, 300, f)
    grid = tps.splat_max(*mapping, values, sizes)
    g = torch.randn(grid.shape, generator=gen, device="cuda")
    good = list(tps._splat_bwd_params(8, 300, f, sizes)[0])
    at = {n: i for i, n in enumerate(tps.BWD_PARAMS)}
    lib = tps.cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream().cuda_stream
    for name, wrong in (("group", 8), ("points_per_thread", 2),
                        ("threads", 128), ("blocks", good[at["blocks"]] + 1),
                        ("vec", 0), ("winner_group", 8),
                        ("winner_blocks", good[at["winner_blocks"]] - 1),
                        ("winner_features", 1 - good[at["winner_features"]])):
        bad = list(good)
        bad[at[name]] = wrong
        params = tps.cuda_build.int_params(*bad)
        winner = torch.full(grid.shape, 7, dtype=torch.int32, device="cuda")
        outs = [torch.full((8, 300, n), 7.0, device="cuda")
                for n in (4, 4, f)]
        err = lib.ct_splat_max_bwd(
            *(a.data_ptr() for a in (*mapping, values, grid, g, winner)),
            *(o.data_ptr() for o in outs), params[1], stream)
        err2 = lib.ct_splat_route(
            *(a.data_ptr() for a in (*mapping, values, winner, g)),
            *(o.data_ptr() for o in outs), params[1], stream)
        torch.cuda.synchronize()
        assert err != 0 and err2 != 0, name
        assert bool((winner == 7).all()), name
        assert all(bool((o == 7.0).all()) for o in outs), name


# --- the point-major splat and the winner-tracking splat -------------------

def _splat_both(gen, mapping, values, sizes):
    """splat_max and splat_max_winner on one input: the grid bit-equal to
    the plain splat's, the map equal to the plain map and to the two-pass
    backward's, each kernel bit-equal over two runs, and the winner splat
    moving its own counter only.  -> (grid, winner)."""
    grid = tps.splat_max(*mapping, values, sizes)
    assert torch.equal(grid, tps.splat_max_plain(*mapping, values, sizes))
    assert torch.equal(grid, tps.splat_max(*mapping, values, sizes))
    wrappers = (tps.splat_max, tps.splat_max_bwd, tps.splat_max_winner)
    counts = [w.launches for w in wrappers]
    w_grid, winner = tps.splat_max_winner(*mapping, values, sizes)
    assert [w.launches for w in wrappers] == [counts[0], counts[1],
                                              counts[2] + 1]
    assert torch.equal(w_grid, grid) and winner.dtype == torch.int32
    assert torch.equal(winner, tps.splat_winner_plain(*mapping, values, grid,
                                                      sizes))
    two_pass = tps.splat_max_bwd(*mapping, values, grid,
                                 torch.zeros_like(grid), sizes,
                                 return_winner=True)[3]
    assert torch.equal(winner, two_pass)
    again = tps.splat_max_winner(*mapping, values, sizes)
    assert torch.equal(again[0], grid) and torch.equal(again[1], winner)
    return grid, winner


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(8, 2048), (2, 16384)])
@pytest.mark.parametrize("sizes,f", SLICE_SHAPES)
def test_splat_kernels_at_the_model_shapes(gen, sizes, f, b, k):
    """The classifier's rows (B = 8 x 16 heads x 2048 points) and the
    completion decoder's (B = 2 x 16 x 16384) at every head group."""
    mapping, values = _mapping(gen, sizes, b, 16, k, f, ties=False)
    _splat_both(gen, mapping, values, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((128, 128), 4), ((16, 16, 16), 16)])
def test_splat_kernels_over_two_scans(gen, sizes, f):
    """3000 points a row and one chunk: each block lists its points in two
    scans, and the winner splat leaves the winners to the winner pass."""
    mapping, values = _mapping(gen, sizes, 8, 16, 3000, f)
    plan = tps.splat_plan(128, 3000, f, sizes)
    assert plan.chunks == 1 and plan.chunk > tps.SPLAT_SCAN_POINTS
    assert not tps.winners_in_splat(plan)
    _splat_both(gen, mapping, values, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", RAGGED_SIZES)
@pytest.mark.parametrize("f", RAGGED_F)
@pytest.mark.parametrize("k", [38, 3002])
def test_splat_kernels_at_ragged_shapes(gen, sizes, f, k):
    """One chunk a row (38 points: the slab written whole into an
    unfilled grid, the winners recorded by the splat kernel) and several
    (3002: raised by atomics into a zero-filled one, the winners by the
    winner pass), every lane group, rows of G * F words that are no
    multiple of 4, exact ties going to the lower index, values that start
    off 16 bytes."""
    mapping, values = _mapping(gen, sizes, 2, 3, k, f)
    plan = tps.splat_plan(6, k, f, sizes)
    assert (plan.chunks > 1) == (k == 3002)
    assert tps.winners_in_splat(plan) == (k == 38)
    n = tps.splat_max.launches
    grid, winner = _splat_both(gen, mapping, values, sizes)
    assert tps.splat_max.launches == n + 2
    assert not grid[-1].any()
    assert not (winner % 2 == 1)[winner != tps.NO_WINNER].any()
    shifted = torch.empty(values.numel() + 1, device="cuda")[1:].view(
        values.shape)
    shifted.copy_(values)
    assert torch.equal(tps.splat_max(*mapping, shifted, sizes), grid)
    assert torch.equal(tps.splat_max_winner(*mapping, shifted, sizes)[1],
                       winner)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((8, 8, 8), 32), ((16, 16), 16),
                                     ((8, 8, 8), 5)])
def test_splat_precheck_is_exact_on_a_dense_grid(gen, sizes, f):
    """16384 points a row on a small grid (128-256 contributions a cell),
    duplicated points and values rounded to a few levels, so that many
    contributions equal the cell's maximum and most skip their atomic after
    reading the word in shared memory, and many chunks a row raise the
    grid: the grid bit-equal to the plain splat in every one of five runs,
    and the winner map to the plain map."""
    mapping, values = _mapping(gen, sizes, 1, 4, 16384, f)
    values = (values * 2).round() / 2
    assert tps.splat_plan(4, 16384, f, sizes).chunks > 8
    ref = tps.splat_max_plain(*mapping, values, sizes)
    assert bool((ref[:-1] > 0).float().mean() > 0.9)
    for _ in range(5):
        assert torch.equal(tps.splat_max(*mapping, values, sizes), ref)
    _splat_both(gen, mapping, values, sizes)


@pytest.mark.gpu
def test_splat_launch_refuses_a_plan_it_did_not_make(gen):
    """Both entry points recompute the splat's plan (and the winner splat
    the winner pass's too) and launch nothing, writing nothing, where the
    caller's numbers disagree: with one chunk a row and with several."""
    sizes, f = (16, 16), 16
    lib = tps.cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream().cuda_stream
    at = {n: i for i, n in enumerate(tps.SPLAT_PARAMS)}
    for k in (200, 3000):
        mapping, values = _mapping(gen, sizes, 2, 4, k, f)
        assert (tps.splat_plan(8, k, f, sizes).chunks > 1) == (k == 3000)
        good = list(tps._splat_params(8, k, f, sizes)[0])
        bwd = tps._splat_bwd_params(8, k, f, sizes)[1]
        other = tps._splat_bwd_params(8, k - 1, f, sizes)[1]
        cases = [(name, good[at[name]] + step, bwd) for name, step in (
            ("group", good[at["group"]]), ("threads", -128), ("slabs", 1),
            ("slab_words", -4), ("chunks", 1), ("chunk", 1), ("blocks", 1))]
        cases.append(("another shape's winner pass", None, other))
        for name, wrong, bwd_params in cases:
            bad = list(good)
            if wrong is not None:
                bad[at[name]] = wrong
            params = tps.cuda_build.int_params(*bad)
            grid = torch.full((8, 256, f), 7.0, device="cuda")
            winner = torch.full(grid.shape, 7, dtype=torch.int32,
                                device="cuda")
            ptrs = [a.data_ptr() for a in (*mapping, values, grid)]
            errs = [lib.ct_splat_max_winner(*ptrs, winner.data_ptr(),
                                            params[1], bwd_params, stream)]
            if wrong is not None:
                errs.append(lib.ct_splat_max(*ptrs, params[1], stream))
            torch.cuda.synchronize()
            assert all(e != 0 for e in errs), (k, name)
            assert bool((grid == 7.0).all()), (k, name)
            assert bool((winner == 7).all()), (k, name)


@pytest.mark.gpu
def test_splat_refuses_the_index_limit_on_the_card(gen):
    """R * G * F at 2^31 raises before anything is allocated."""
    mapping, values = _mapping(gen, (64, 64), 1, 2, 4, 2 ** 18,
                               ties=False)
    with pytest.raises(ValueError):
        tps.splat_max(*mapping, values, (64, 64))
    with pytest.raises(ValueError):
        tps.splat_max_winner(*mapping, values, (64, 64))


@pytest.mark.gpu
def test_splat_kernels_in_a_cuda_graph(gen):
    sizes, f = (16, 16, 16), 16
    mapping, values = _mapping(gen, sizes, 2, 4, 2048, f)
    ref = tps.splat_max(*mapping, values, sizes)
    for run in _graph_replays(lambda: (tps.splat_max(*mapping, values,
                                                     sizes),)):
        assert torch.equal(run[0], ref)
    ref = tps.splat_max_winner(*mapping, values, sizes)
    for run in _graph_replays(lambda: tps.splat_max_winner(
            *mapping, values, sizes)):
        assert all(torch.equal(a, b) for a, b in zip(run, ref))


# --- the slice backward -----------------------------------------------------

def _slice_bwd_check(mapping, g_pts, grid, sizes, runs=5):
    """slice_bwd against its plain version: d_grid within 1e-5 of the plain
    version on the CPU and the same in each of ``runs`` runs, d_w within
    1e-6 of the plain version on the card, a 2D mapping's slots 2 and 3 at
    zero, one launch a call.  -> d_grid."""
    cpu = tps.slice_bwd_plain(*(a.cpu() for a in (*mapping, g_pts, grid)),
                              sizes)
    n = tps.slice_bwd.launches
    first = tps.slice_bwd(*mapping, g_pts, grid, sizes)
    assert tps.slice_bwd.launches == n + 1
    _close(first[0].cpu(), cpu[0], 1e-5)
    p_grid, p_lo, p_hi = tps.slice_bwd_plain(*mapping, g_pts, grid, sizes)
    _close(first[1], p_lo, 1e-6)
    _close(first[2], p_hi, 1e-6)
    if len(sizes) == 2:
        assert not first[1][..., 2:].any() and not first[2][..., 2:].any()
    for _ in range(runs - 1):
        again = tps.slice_bwd(*mapping, g_pts, grid, sizes)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    return first[0]


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(8, 2048), (2, 16384)])
@pytest.mark.parametrize("sizes,f", SLICE_SHAPES)
def test_slice_bwd_at_the_model_shapes(gen, sizes, f, b, k):
    """The classifier's rows (B = 8 x 16 heads x 2048 points) and the
    completion decoder's (B = 2 x 16 x 16384) at every head group, on a
    grid of the forward's kind."""
    mapping, values = _mapping(gen, sizes, b, 16, k, f, ties=False)
    grid = tps.splat_max(*mapping, values, sizes)
    g_pts = torch.randn(values.shape, generator=gen, device="cuda")
    _slice_bwd_check(mapping, g_pts, grid, sizes)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", RAGGED_SIZES)
@pytest.mark.parametrize("f", [1, 3, 4, 5, 16, 21, 32])
@pytest.mark.parametrize("k", [38, 3002])
def test_slice_bwd_at_ragged_shapes(gen, sizes, f, k):
    """Every lane group and the scalar path, one scan and four, duplicated
    points, cotangents and a grid that start off 16 bytes."""
    mapping, values = _mapping(gen, sizes, 2, 3, k, f)
    grid = torch.randn(6, tps.kernel_grid_dims(sizes)[2], f, generator=gen,
                       device="cuda")
    d_grid = _slice_bwd_check(mapping, values, grid, sizes, runs=2)
    shifted = [torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape)
               for t in (values, grid)]
    for s, t in zip(shifted, (values, grid)):
        s.copy_(t)
    got = tps.slice_bwd(*mapping, *shifted, sizes)
    assert torch.equal(got[0], d_grid)
    _close(got[1], tps.slice_bwd_plain(*mapping, values, grid, sizes)[1],
           1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes,f", [((8, 8, 8), 32), ((16, 16), 16),
                                     ((8, 8, 8), 5)])
def test_slice_bwd_on_crowded_cells(gen, sizes, f):
    """16384 points a row on a small grid (128-256 contributions a cell)
    and every point of one row on one cell: many terms a word, bins of a
    whole scan."""
    mapping, values = _mapping(gen, sizes, 1, 4, 16384, f)
    for a in mapping:
        a[-1] = a[-1, :1]                  # the last row: one point, copied
    grid = torch.randn(4, tps.kernel_grid_dims(sizes)[2], f, generator=gen,
                       device="cuda")
    d_grid = _slice_bwd_check(mapping, values, grid, sizes)
    assert bool((d_grid[-1].abs().sum(-1) > 0).sum() == 2 ** len(sizes))


@pytest.mark.gpu
def test_slice_bwd_launch_refuses_a_plan_it_did_not_make(gen):
    """The entry point recomputes the plan and launches nothing, writing
    nothing, where the caller's numbers disagree."""
    sizes, f, k = (16, 16, 16), 16, 300
    mapping, values = _mapping(gen, sizes, 2, 4, k, f)
    grid = torch.randn(8, 4096, f, generator=gen, device="cuda")
    good = list(tps._slice_bwd_params(8, k, f, sizes)[0])
    at = {n: i for i, n in enumerate(tps.SLICE_BWD_PARAMS)}
    lib = tps.cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream().cuda_stream
    for name, step in (("group", 4), ("threads", -128), ("slab_words", 4),
                       ("slabs", 1), ("blocks", 1), ("points_per_thread", 2),
                       ("dw_blocks", -1), ("vec", -1)):
        bad = list(good)
        bad[at[name]] += step
        params = tps.cuda_build.int_params(*bad)
        outs = [torch.full(shape, 7.0, device="cuda")
                for shape in ((8, 4096, f), (8, k, 4), (8, k, 4))]
        most = torch.full((4096,), 7, dtype=torch.int32, device="cuda")
        err = lib.ct_slice_bwd(
            *(a.data_ptr() for a in (*mapping, values, grid)),
            *(o.data_ptr() for o in outs), most.data_ptr(), params[1],
            stream)
        torch.cuda.synchronize()
        assert err != 0, name
        assert all(bool((o == 7.0).all()) for o in outs), name
        assert bool((most == 7).all()), name


@pytest.mark.gpu
def test_slice_bwd_refuses_the_index_limit_on_the_card(gen):
    """R * G * F at 2^31 (2^19 rows of 4096 cells) raises before anything
    is allocated or copied: the cotangents and the grid are expanded
    views."""
    mapping, _ = _mapping(gen, (64, 64), 2 ** 15, 16, 1, 1, ties=False)
    one = torch.zeros(1, 1, 1, device="cuda")
    n = tps.slice_bwd.launches
    with pytest.raises(ValueError):
        tps.slice_bwd(*mapping, one.expand(2 ** 19, 1, 1),
                      one.expand(2 ** 19, 4096, 1), (64, 64))
    assert tps.slice_bwd.launches == n


@pytest.mark.gpu
def test_slice_bwd_in_a_cuda_graph(gen):
    sizes, f = (16, 16, 16), 16
    mapping, values = _mapping(gen, sizes, 2, 4, 2048, f)
    grid = tps.splat_max(*mapping, values, sizes)
    ref = tps.slice_bwd(*mapping, values, grid, sizes)
    for run in _graph_replays(lambda: tps.slice_bwd(*mapping, values, grid,
                                                    sizes)):
        assert all(torch.equal(a, b) for a, b in zip(run, ref))
