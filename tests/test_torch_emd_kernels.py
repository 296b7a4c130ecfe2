"""Port parity: the plain versions of the auction's two kernels against the
JAX package.

``top2_plain`` (what ``top2`` runs on a CPU tensor) is held to
``pallas_top2`` in interpret mode and to the XLA scan ``_top2_values``: the
argmax equal, first occurrence on exact duplicates, and the values within
2e-5 of the float64 value and within 4e-5 of JAX's.  The expanded square
``|a|^2 + |b|^2 - 2 <a, b>`` loses about 1e-6 in float32 and the square root
of a small distance multiplies that: each side is measured up to 1.7e-5 from
the float64 value, in another direction when the cross term comes from a
matrix product (JAX) or from rounded multiplies and adds (the port), so the
two may be twice that apart.  The auction's eps is 4e-3.
``auction_window_plain`` is held to ``pallas_auction_window`` in interpret
mode from the mid-auction state of ``tests/test_losses.py``: owner map,
derived assignment and rounds used equal, prices within 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.losses import emd as jemd
from cloud_transformers_tpu.ops import pallas_emd as jpe
from cloud_transformers_tpu_torch.losses import emd as temd
from cloud_transformers_tpu_torch.ops import pallas_emd as tpe

TOL = 2e-5         # against float64, and for prices
TOL_PAIR = 4e-5    # two float32 implementations against each other


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _hold_top2(x1, x2, price):
    got = tpe.top2(_t(x1), _t(x2), _t(price))
    assert got[2].dtype == torch.int32
    d = np.sqrt(((x1[:, :, None].astype(np.float64)
                  - x2[:, None].astype(np.float64)) ** 2).sum(-1))
    exact = np.sort(3.0 - d - price[:, None], -1)
    np.testing.assert_allclose(got[0].numpy(), exact[..., -1], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), exact[..., -2], rtol=0,
                               atol=TOL)
    for ref in (jpe.pallas_top2(jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(price), interpret=True),
                jemd._top2_values(jnp.asarray(x1), jnp.asarray(x2),
                                  jnp.asarray(price), 2048)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=0, atol=TOL_PAIR)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=0, atol=TOL_PAIR)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    return got


@pytest.mark.parametrize("b,w,m", [(2, 256, 1024), (2, 300, 1000),
                                   (1, 256, 256)])
def test_top2_plain_matches_jax(b, w, m):
    rs = np.random.RandomState(0)
    x1 = rs.rand(b, w, 3).astype(np.float32)
    x2 = rs.rand(b, m, 3).astype(np.float32)
    price = (rs.rand(b, m) * 0.1).astype(np.float32)
    n = tpe.top2.launches
    _hold_top2(x1, x2, price)
    assert tpe.top2.launches == n      # a CPU tensor launches no kernel


def test_top2_plain_duplicated_targets():
    rs = np.random.RandomState(1)
    x1 = rs.rand(1, 256, 3).astype(np.float32)
    half = rs.rand(1, 300, 3).astype(np.float32)
    x2 = np.concatenate([half, half], 1)        # exact duplicates
    best, better, best_i = _hold_top2(x1, x2, np.zeros((1, 600), np.float32))
    assert torch.equal(best, better)            # the duplicate ties the best
    assert int(best_i.max()) < 300              # the first occurrence


def test_top2_plain_chunks_and_single_target():
    """The chunked loop gives the same as one chunk, with a ragged last
    chunk; one target leaves -1e9 as the second-best."""
    g = torch.Generator().manual_seed(0)
    x1 = torch.rand(2, 64, 3, generator=g)
    x2 = torch.rand(2, 333, 3, generator=g)
    price = torch.rand(2, 333, generator=g) * 0.1
    whole = tpe.top2_plain(x1, x2, price, chunk_size=4096)
    for a, b in zip(whole, tpe.top2_plain(x1, x2, price, chunk_size=100)):
        assert torch.equal(a, b)
    one = tpe.top2(x1, x2[:, :1], price[:, :1])
    assert bool((one[1] == -1e9).all()) and bool((one[2] == 0).all())


def test_top2_split_fills_the_card():
    """The bid search's split of the work over blocks (targets cut into
    chunks across blocks) puts at least one block on every SM at the
    staged widths, and one chunk where there are too few targets."""
    for b, w in ((2, 16384), (1, 16384), (1, 2048), (1, 256)):
        assert tpe.top2_plan(b, w, 16384).blocks >= tpe.SMS
    assert tpe.top2_plan(1, 256, 16384).chunks > 1
    assert tpe.top2_plan(1, 1, 1).chunks == 1
    assert tpe.top2_plan(2, 33, 5).chunks == 1


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        tpe.top2(x, x.double(), torch.zeros(1, 4))
    with pytest.raises(ValueError):
        tpe.top2(x, x, torch.zeros(1, 5))
    with pytest.raises(ValueError):
        tpe.auction_window(x, torch.zeros(1, 4), x, torch.zeros(1, 4),
                           torch.zeros(1, 4, dtype=torch.int32), 1, 0.01, 4)


def _mid_state(rs, b, n, eps, full_rounds=6):
    x1 = jnp.asarray(rs.rand(b, n, 3), jnp.float32)
    x2 = jnp.asarray(rs.rand(b, n, 3), jnp.float32)
    state = (jnp.full((b, n), -1, jnp.int32), jnp.full((b, n), -1, jnp.int32),
             jnp.zeros((b, n), jnp.float32))
    for _ in range(full_rounds):
        state = jemd._auction_round(x1, x2, eps, 2048, state, last=False)
    return x1, x2, state


@pytest.mark.parametrize("rem,cap", [(5, 5), (3, 8), (64, 64)])
def test_auction_window_plain_matches_pallas(rem, cap):
    b, n, w, eps = 2, 512, 128, 0.02
    x1, x2, (assignment, inv, price) = _mid_state(
        np.random.RandomState(0), b, n, eps)
    idx = jemd._compact_unassigned(assignment, w)
    j_real = jnp.where(idx < n, idx, n).astype(jnp.int32)
    x1w = jnp.take_along_axis(x1, jnp.minimum(idx, n - 1)[..., None], 1)
    m_tile = jpe._window_m_tile(w, n)
    prb, invb, used = jpe.pallas_auction_window(
        x1w, j_real, jpe.pack_targets(x2, m_tile),
        jpe.pack_col(price, m_tile), jpe.pack_col(inv, m_tile, fill=-1),
        rem, eps, n=n, rounds_cap=cap, interpret=True)
    want_inv = np.asarray(jpe.unpack_col(invb, n))

    n_launch = tpe.auction_window.launches
    price_in, owner_in = _t(price), _t(inv)
    got_price, got_owner, got_used = tpe.auction_window(
        _t(x1w), _t(j_real), _t(x2), price_in, owner_in, rem, eps, n,
        rounds_cap=cap)
    assert tpe.auction_window.launches == n_launch
    assert torch.equal(price_in, _t(price))     # the inputs are left alone
    np.testing.assert_array_equal(got_owner.numpy(), want_inv)
    np.testing.assert_array_equal(got_used.numpy(), np.asarray(used))
    assert int(got_used.max()) <= min(rem, cap)
    np.testing.assert_allclose(got_price.numpy(),
                               np.asarray(jpe.unpack_col(prb, n)), atol=TOL)
    np.testing.assert_array_equal(
        temd._assignment_from_inv(got_owner.long(), n)[:, :n].numpy(),
        np.asarray(jemd._assignment_from_inv(jnp.asarray(want_inv), n)))


def test_auction_window_cluster_order_matches_pallas():
    """The card kernel's order of work (per-slice top twos merged
    order-free, a 64-bit key max per target, eviction by an owner check)
    against the JAX kernel: owners and rounds equal, prices within TOL."""
    b, n, w, eps, rem = 2, 512, 128, 0.02, 64
    x1, x2, (assignment, inv, price) = _mid_state(
        np.random.RandomState(1), b, n, eps)
    idx = jemd._compact_unassigned(assignment, w)
    j_real = jnp.where(idx < n, idx, n).astype(jnp.int32)
    x1w = jnp.take_along_axis(x1, jnp.minimum(idx, n - 1)[..., None], 1)
    m_tile = jpe._window_m_tile(w, n)
    prb, invb, used = jpe.pallas_auction_window(
        x1w, j_real, jpe.pack_targets(x2, m_tile),
        jpe.pack_col(price, m_tile), jpe.pack_col(inv, m_tile, fill=-1),
        rem, eps, n=n, rounds_cap=rem, interpret=True)
    got_price, got_owner, got_used = tpe.auction_window_cluster_order(
        _t(x1w), _t(j_real), _t(x2), _t(price), _t(inv), rem, eps, n,
        rounds_cap=rem)
    np.testing.assert_array_equal(got_owner.numpy(),
                                  np.asarray(jpe.unpack_col(invb, n)))
    np.testing.assert_array_equal(got_used.numpy(), np.asarray(used))
    assert int(got_used.min()) >= 2
    np.testing.assert_allclose(got_price.numpy(),
                               np.asarray(jpe.unpack_col(prb, n)), atol=TOL)


def test_auction_window_plain_counts_bids_and_stops():
    """No valid lane: no round runs.  ``return_bids`` counts the active
    lanes over the rounds."""
    b, n, w, eps = 1, 256, 64, 0.02
    x1, x2, (assignment, inv, price) = _mid_state(
        np.random.RandomState(2), b, n, eps, full_rounds=3)
    idx = _t(jemd._compact_unassigned(assignment, w)).long()
    x1w = torch.gather(_t(x1), 1, idx.clamp(max=n - 1)[..., None]
                       .expand(-1, -1, 3))
    args = (_t(x2), _t(price), _t(inv))
    *_, used, bids = tpe.auction_window_plain(
        x1w, idx.int(), *args, 10, eps, n, return_bids=True)
    assert int(used) >= 1 and bids >= int((idx < n).sum())
    idle = torch.full_like(idx, n).int()
    price2, owner2, used2 = tpe.auction_window(x1w, idle, *args, 10, eps, n)
    assert int(used2) == 0 and torch.equal(price2, args[1]) \
        and torch.equal(owner2, args[2])
