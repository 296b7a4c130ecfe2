"""Port parity: the auction EMD of ``losses/emd.py`` against the JAX package.

On the CPU the port's bid search is ``top2_plain`` and JAX's the XLA scan,
so the two auctions see bid values that differ by float32 rounding.  One
round from a shared state is held equal (assignment and owner map) with
prices within 2e-5 (an increment is the difference of two bid values, each
up to 1.7e-5 from its float64 value on either side, see
``test_torch_emd_kernels.py``; 4.8e-6 measured); whole auctions are held
on what the algorithm promises: distances consistent with the assignment,
a near one-to-one matching, and ``loss_emd`` within 1% of JAX's (at these
seeds the assignments are in fact equal).  The gradient goes to ``xyz1``
only and equals ``2 (x1 - x2[a])``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_transformers_tpu.losses import emd as jemd
from cloud_transformers_tpu_torch.losses import emd as temd


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _clouds(seed, b, n, noise=0.02):
    rs = np.random.RandomState(seed)
    x2 = rs.rand(b, n, 3).astype(np.float32)
    perm = np.stack([rs.permutation(n) for _ in range(b)])
    x1 = np.take_along_axis(x2, perm[..., None], 1) \
        + noise * rs.randn(b, n, 3).astype(np.float32)
    return x1.astype(np.float32), x2


def _jax_state(x1, x2, eps, rounds):
    b, n, _ = x1.shape
    state = (jnp.full((b, n), -1, jnp.int32), jnp.full((b, n), -1, jnp.int32),
             jnp.zeros((b, n), jnp.float32))
    for _ in range(rounds):
        state = jemd._auction_round(jnp.asarray(x1), jnp.asarray(x2), eps,
                                    2048, state, last=False)
    return state


def _port_state(jstate):
    """A JAX state (assignment, owner, price) as the port keeps it: int64,
    the assignment with its spare column."""
    assignment, inv, price = (np.asarray(a) for a in jstate)
    b, n = assignment.shape
    padded = np.concatenate([assignment, np.zeros((b, 1), assignment.dtype)],
                            1)
    return (_t(padded).long(), _t(inv).long(), _t(price))


def test_compact_unassigned_matches_jax():
    rs = np.random.RandomState(0)
    assignment = np.where(rs.rand(3, 200) < 0.3, -1,
                          rs.randint(0, 200, (3, 200))).astype(np.int32)
    assignment[2] = 5                      # a row with nothing unassigned
    for cap in (16, 64, 256):
        want = jemd._compact_unassigned(jnp.asarray(assignment), cap)
        got = temd._compact_unassigned(_t(assignment).long(), cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap,last", [(None, False), (None, True),
                                      (64, False), (16, False)])
def test_one_auction_round_matches_jax(cap, last):
    """One round from a shared mid-auction state: full width with ``last``
    both ways, and compacted (the last round always runs at full width)."""
    b, n, eps = 2, 256, 0.01
    x1, x2 = _clouds(3, b, n, noise=0.1)
    jstate = _jax_state(x1, x2, eps, 3)
    assert int((np.asarray(jstate[0]) < 0).sum()) > 0
    idx = None if cap is None else jemd._compact_unassigned(jstate[0], cap)
    want = jemd._auction_round(jnp.asarray(x1), jnp.asarray(x2), eps, 2048,
                               jstate, last=last, idx=idx)
    got = temd._auction_round(
        _t(x1), _t(x2), eps, 2048, _port_state(jstate), last=last,
        idx=None if idx is None else _t(idx).long())
    np.testing.assert_array_equal(got[0][:, :n].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("n,noise", [(256, 0.02), (2048, 0.02),
                                     (2048, 0.005)])
def test_whole_auction_matches_jax(n, noise):
    """n=2048 runs the staged phases (caps 256 and up).  With the small
    noise the auction converges inside the 50 rounds and ends early."""
    b = 2
    x1, x2 = _clouds(0, b, n, noise)
    jd, ja, jr = jemd.emd_auction_with_rounds(
        jnp.asarray(x1), jnp.asarray(x2), eps=0.005, iters=50)
    t1 = _t(x1).requires_grad_()
    t2 = _t(x2).requires_grad_()
    dist, assignment, rounds = temd.emd_auction_with_rounds(
        t1, t2, eps=0.005, iters=50)
    assert rounds == int(jr)
    a = assignment.numpy()
    assert a.min() >= 0 and a.max() < n
    # dist is consistent with the assignment
    matched = np.take_along_axis(x2, a[..., None], 1)
    np.testing.assert_allclose(dist.detach().numpy(),
                               ((x1 - matched) ** 2).sum(-1), atol=1e-6)
    # near one to one: the forced last round may double up a few targets
    for row in a:
        assert len(set(row.tolist())) >= 0.98 * n
    loss = torch.sqrt(dist + 1e-12).mean()
    want = float(jnp.mean(jnp.sqrt(jd + 1e-12)))
    assert abs(float(loss.detach()) - want) <= 0.01 * want
    assert (a == np.asarray(ja)).mean() > 0.98
    # gradient: to xyz1 only, 2 (x1 - x2[a]) through the fixed assignment
    dist.sum().backward()
    assert t2.grad is None
    np.testing.assert_allclose(t1.grad.numpy(), 2 * (x1 - matched),
                               atol=1e-6)


def test_loss_emd_and_emd_auction():
    x1, x2 = _clouds(1, 1, 128)
    dist, assignment = temd.emd_auction(_t(x1), _t(x2))
    assert dist.shape == (1, 128) and assignment.dtype == torch.int64
    np.testing.assert_allclose(
        float(temd.loss_emd(_t(x1), _t(x2))),
        float(jemd.loss_emd(jnp.asarray(x1), jnp.asarray(x2))), rtol=1e-5)
    # iters=1: only the forced round runs
    _, _, rounds = temd.emd_auction_with_rounds(_t(x1), _t(x2), iters=1)
    assert rounds == 1
    with pytest.raises(ValueError):
        temd.emd_auction(_t(x1), _t(x2)[:, :64])


def test_window_tail_converges_like_the_staged_tail(monkeypatch):
    """The window tail on (n=1024 with ``_WINDOW_MIN_N`` lowered): it ends
    inside the budget with a one-to-one assignment whose cost is within 2%
    of the staged path's, and of JAX's staged path."""
    b, n = 2, 1024
    x1, x2 = _clouds(5, b, n)
    d_s, a_s, r_s = temd.emd_auction_with_rounds(_t(x1), _t(x2), eps=0.005,
                                                 iters=3000)
    monkeypatch.setattr(temd, "_WINDOW_TAIL", True)
    monkeypatch.setattr(temd, "_WINDOW_MIN_N", 512)
    d_w, a_w, r_w = temd.emd_auction_with_rounds(_t(x1), _t(x2), eps=0.005,
                                                 iters=3000)
    assert r_w < 2999 and r_s < 2999
    for row in a_w.numpy():
        assert len(set(row.tolist())) == n
    assert abs(float(d_w.sum()) - float(d_s.sum())) < 0.02 * float(d_s.sum())
    jd, _, _ = jemd.emd_auction_with_rounds(jnp.asarray(x1), jnp.asarray(x2),
                                            eps=0.005, iters=3000)
    assert abs(float(d_w.sum()) - float(jd.sum())) < 0.02 * float(jd.sum())


def test_window_tail_respects_the_round_budget(monkeypatch):
    monkeypatch.setattr(temd, "_WINDOW_TAIL", True)
    monkeypatch.setattr(temd, "_WINDOW_MIN_N", 512)
    x1, x2 = _clouds(6, 1, 1024, noise=0.2)
    _, assignment, rounds = temd.emd_auction_with_rounds(
        _t(x1), _t(x2), eps=0.001, iters=12)
    assert rounds <= 12
    assert assignment.min() >= 0 and assignment.max() < 1024
