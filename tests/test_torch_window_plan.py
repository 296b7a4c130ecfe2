"""Launch arithmetic of the auction window's cluster kernel, and its order of
work, on the CPU.

The kernel runs only on a CUDA card (``tests/test_torch_kernels_gpu.py``);
what decides which CTA owns which targets and lanes is Python
(``auction_window_plan``), mirrored here in numpy from the index arithmetic
of ``auction_window_kernel`` and ``window_bid`` in ``csrc/emd.cu``.  The
kernel's order of work (per-slice top twos merged order-free, a 64-bit key
max per target, eviction by an owner check) is mirrored in torch by
``auction_window_cluster_order`` and held bit-equal to
``auction_window_plain``.  No JAX.
"""

import ctypes

import numpy as np
import pytest
import torch

from cloud_transformers_tpu_torch.ops import pallas_emd as tpe

SMEM = 232448


def _cover(plan, count, per):
    """How often the CTAs of a row own each of ``count`` items, ``per`` a
    CTA (``slice_len`` targets or ``lanes_per_cta`` lanes), as the kernel
    cuts them: [r * per, min(count, (r + 1) * per))."""
    owned = np.zeros(count, np.int64)
    for r in range(plan.cluster):
        k0 = r * per
        nk = max(0, min(count, k0 + per) - k0)
        owned[k0:k0 + nk] += 1
    return owned


@pytest.mark.parametrize("w", [1, 5, 128, 512, 777])
@pytest.mark.parametrize("m", [16384, 2048, 3001, 40000, 7, 1])
def test_window_plan_covers_every_target_and_lane_once(w, m):
    """Slices cover every target once for M a multiple of the cluster, a
    multiple of nothing and M below it; the own lanes cover every lane."""
    plan = tpe.auction_window_plan(2, w, m)
    assert plan.cluster == tpe.WINDOW_CLUSTER == 16
    assert plan.threads == tpe.WINDOW_THREADS
    assert plan.ctas == 2 * plan.cluster
    assert (_cover(plan, m, plan.slice_len) == 1).all()
    assert (_cover(plan, w, plan.lanes_per_cta) == 1).all()
    # no CTA is given more than a fair share of either
    assert plan.slice_len == -(-m // 16) and plan.lanes_per_cta == -(-w // 16)


def _lane_bytes(w):
    """The kernel's lane arrays: part int4 [W], act [W], jr, la, bi, inc
    [WL], two lists [2][WL], two counts and C + 1 offsets."""
    wl = -(-w // 16)
    return 16 * w + 4 * w + 4 * 4 * wl + 2 * 4 * wl + 4 * (2 + 16 + 1)


@pytest.mark.parametrize("w", [1, 128, 512, 2048, 8192])
@pytest.mark.parametrize("m", [1, 2048, 16384, 40000, 76000, 77000, 100000,
                               1 << 20])
def test_window_plan_shared_memory(w, m):
    """Within one CTA's 232448 bytes; the state goes to device memory
    exactly where lanes and slice do not fit together."""
    plan = tpe.auction_window_plan(1, w, m)
    lane = _lane_bytes(w)
    state = 44 * plan.slice_len    # float4 x 2, a 64-bit key, the owner
    assert plan.lane_bytes == lane and plan.state_bytes == state
    assert plan.state_in_smem == (lane + state <= SMEM)
    assert plan.smem_bytes <= SMEM
    assert plan.smem_bytes == lane + state * plan.state_in_smem
    assert plan.scratch_bytes == (0 if plan.state_in_smem
                                  else plan.cluster * state)
    # the models' window (W = 512) at N = 16384: 1024 targets a CTA
    if (w, m) == (512, 16384):
        assert plan.state_in_smem and plan.slice_len == 1024


def test_window_plan_forced_to_device_memory_and_refusals():
    plan = tpe.auction_window_plan(2, 256, 40000, state_in_smem=False)
    assert not plan.state_in_smem
    assert plan.smem_bytes == plan.lane_bytes
    assert plan.scratch_bytes == 2 * 16 * 44 * 2500
    assert tpe.auction_window_plan(2, 256, 40000).state_in_smem
    with pytest.raises(ValueError):
        tpe.auction_window_plan(1, 512, 1 << 20, state_in_smem=True)
    widest = max(w for w in range(10000, 12000) if _lane_bytes(w) <= SMEM)
    assert tpe.auction_window_plan(1, widest, 16).smem_bytes <= SMEM
    with pytest.raises(ValueError):
        tpe.auction_window_plan(1, widest + 1, 16)
    with pytest.raises(ValueError):
        tpe.auction_window_plan(1, 0, 16)


def _held(arr, addr):
    return list((ctypes.c_int * len(arr)).from_address(addr))


@pytest.mark.parametrize("b,w,m", [(2, 512, 16384), (1, 1, 3001),
                                   (1, 256, 100000)])
@pytest.mark.parametrize("in_smem", [None, False])
def test_window_entry_integers_follow_the_plan(b, w, m, in_smem):
    """``ct_emd_auction_window`` takes B, W, M and the plan as one cached
    array that the cache keeps alive."""
    plan, (arr, addr) = tpe._window_params(b, w, m, in_smem)
    assert plan == tpe.auction_window_plan(b, w, m, in_smem)
    assert _held(arr, addr) == [b, w, m, plan.cluster, plan.threads,
                                plan.slice_len, plan.lanes_per_cta,
                                plan.smem_bytes, int(plan.state_in_smem)]
    assert tpe._window_params(b, w, m, in_smem)[1][0] is arr
    assert tpe.auction_window_plan(b, w, m, in_smem) is plan


def _bid_cover(total, nk, threads=tpe.WINDOW_THREADS):
    """How often ``window_bid`` reads each (active lane, target of the
    slice) pair into a partial that is written, and how often it writes
    each lane's partial: groups of G threads hold four lanes, G as the
    kernel picks it (the fewest passes over the lane sets times targets a
    lane, the smaller G on a tie), a group's threads split the targets by
    their index mod G."""
    sets = -(-total // 4)
    g = min((8, 16, 32), key=lambda t: -(-sets // (threads // t))
            * -(-nk // t))
    groups = threads // g
    pairs = np.zeros((total, nk), np.int64)
    writes = np.zeros(total, np.int64)
    for s0 in range(0, sets, groups):
        for grp in range(groups):
            s = s0 + grp
            if s >= sets:
                continue
            for q in range(4):
                if s * 4 + q >= total:
                    continue
                writes[s * 4 + q] += 1
                for sub in range(g):
                    pairs[s * 4 + q, sub::g] += 1
    return pairs, writes, g


@pytest.mark.parametrize("total", [1, 3, 5, 127, 128, 256, 257, 512])
@pytest.mark.parametrize("nk", [0, 1, 1024, 1000])
def test_window_bid_reads_every_pair_once(total, nk):
    pairs, writes, g = _bid_cover(total, nk)
    assert (pairs == 1).all() and (writes == 1).all()
    if nk == 1024:
        # at M = 16384: 512 lanes take two passes of G = 8 (the first of
        # the three equal costs), 257 lanes five of 32 rather than two of 8
        # with one set in the second, a few lanes one pass of 32
        assert g == {512: 8, 257: 32, 256: 8, 128: 16, 127: 16}.get(
            total, 32)


def _window_state(rs, b, n, w, pad=0, shuffle=False, dup=False, own=0.6):
    """A window as the tail gives one: ``w - pad`` points of each row that
    own no target (the window's lanes), ``pad`` padding lanes (id n),
    targets owned by points outside the window (each by one), prices in
    [0, 0.05).  ``shuffle`` leaves the lanes unsorted; ``dup`` makes the
    second half of the targets copies of the first (tied increments)."""
    x1 = rs.rand(b, n, 3).astype(np.float32)
    x2 = rs.rand(b, n, 3).astype(np.float32)
    if dup:
        x2[:, n // 2:] = x2[:, :n - n // 2]
    price = (rs.rand(b, n) * 0.05).astype(np.float32)
    owner = np.full((b, n), -1, np.int32)
    j_real = np.full((b, w), n, np.int32)
    for row in range(b):
        ids = rs.permutation(n)
        inside, outside = ids[:w - pad], ids[w - pad:]
        k = min(int(own * n), outside.size)
        owner[row, rs.choice(n, k, replace=False)] = outside[:k]
        lanes = np.concatenate([np.sort(inside), np.full(pad, n)])
        j_real[row] = rs.permutation(lanes) if shuffle else lanes
    x1w = np.take_along_axis(x1, np.minimum(j_real, n - 1)[..., None], 1)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (x1w, j_real, x2, price, owner)]


@pytest.mark.parametrize("rem", [1, 3, 64])
@pytest.mark.parametrize("case", ["sorted", "unsorted_padded", "duplicated"])
def test_cluster_order_equals_plain(case, rem):
    """The kernel's order of work gives the plain version's owners, rounds
    and prices bit for bit: tied increments (duplicated targets), lanes
    unsorted with padding, 1, 3 and 64 rounds."""
    rs = np.random.RandomState({"sorted": 0, "unsorted_padded": 1,
                                "duplicated": 2}[case])
    n, w = 200, 48
    args = _window_state(rs, 2, n, w, pad=7 if case != "sorted" else 0,
                         shuffle=case == "unsorted_padded",
                         dup=case == "duplicated")
    eps = 0.01
    want = tpe.auction_window_plain(*args, rem, eps, n, rounds_cap=64)
    got = tpe.auction_window_cluster_order(*args, rem, eps, n,
                                           rounds_cap=64)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert int(got[2].max()) == min(rem, int(got[2].max()))
    assert int(got[2].min()) >= 1
    # the window did work: prices rose and window points took targets
    assert bool((got[0] > args[3]).any())
    ids = args[1][args[1] < n]
    assert bool(torch.isin(got[1], ids).any())
    if rem == 64:
        # every window lane ends with a target of its own
        for row in range(2):
            lanes = args[1][row][args[1][row] < n]
            assert bool(torch.isin(lanes, got[1][row]).all())


def test_cluster_order_with_few_targets_and_a_lone_lane():
    """M below the cluster (empty slices) and a window of one lane."""
    rs = np.random.RandomState(3)
    for n, w, pad in [(9, 4, 1), (5, 1, 0)]:
        args = _window_state(rs, 1, n, w, pad=pad, own=0.4)
        want = tpe.auction_window_plain(*args, 64, 0.01, n)
        got = tpe.auction_window_cluster_order(*args, 64, 0.01, n)
        for g, r in zip(got, want):
            assert torch.equal(g, r)
