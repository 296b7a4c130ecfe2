"""Approximate Earth Mover's Distance by the auction algorithm.

Counterpart of ``cloud_transformers_tpu/losses/emd.py``.  The same
algorithm: rounds of {bid -> resolve conflicts -> assign with eviction}, a
last round that gives every point still unassigned its bid target (possibly
not one to one), then distances through the fixed assignment.

* bid value ``3 - |x1_j - x2_k| - price_k`` (clouds assumed within [0, 1]),
  bid increment ``best - second best + eps``;
* per target the highest increment wins, ties to the lowest bidder index;
* rounds run at staged widths: all N points bid while many are unassigned,
  then only the first ``cap`` unassigned ones, ``cap`` = N/8, N/16, N/32,
  N/64 (those of at least 256), each phase ending once the unassigned count
  is at most the next cap, the whole once every point is assigned or
  ``iters - 1`` rounds are spent;
* the gradient goes to ``xyz1`` only, through the fixed assignment.

Where JAX drops an out-of-range scatter (``mode="drop"``) the state here has
one more column that takes those writes: ``assignment`` is ``[B, N + 1]``
inside the loop.  The assignment and the prices are updated in place.
Each round's exit test reads the unassigned count on the host, which is one
wait for the device per round; the JAX ``while_loop`` does the same test on
the device.

The bid search of every round goes to the ``top2`` kernel on a CUDA tensor
and to its plain version on a CPU tensor.

Under a points axis (``parallel/mesh.py``) the auction raises: it matches
whole clouds one to one, and a rank holds a block of each.
"""

import torch

from cloud_transformers_tpu_torch.ops.pallas_emd import (
    auction_window,
    top2,
    top2_plain,
)

_NEG = -1e9

# On a CUDA tensor, rounds of at least this many bidders go to the top2
# kernel and narrower ones to the plain version.  On an NVIDIA H100 80GB
# HBM3 (700 W limit) the kernel is the faster of the two at every width the
# staged schedule has, B = 2 and B = 1, W = 16384 down to 256, both in a
# loop of launches and in device time (PERF.md, kernel #11, from
# chip_smoke.py), so every round takes it.
_KERNEL_BID_MIN_WIDTH = 1

# The fused window tail (ops/pallas_emd.py auction_window): once at most
# 2 * _WINDOW_W points are unassigned, the tail runs as windows of up to
# _WINDOW_ROUNDS rounds per kernel call.  Off by default, as in the JAX
# package; PERF.md has the card's numbers for both tails.
_WINDOW_TAIL = False
_WINDOW_W = 512
_WINDOW_ROUNDS = 64
_WINDOW_MIN_N = 4096


def _top2_dispatch(x1w, x2, price, chunk_size):
    if not x1w.is_cuda or x1w.shape[1] < _KERNEL_BID_MIN_WIDTH:
        return top2_plain(x1w, x2, price, chunk_size)
    return top2(x1w, x2, price)


def _compact_unassigned(assignment, cap):
    """First ``cap`` unassigned point ids per batch row, in rising order
    (``n`` beyond them).  ``assignment`` is ``[B, N]``."""
    b, n = assignment.shape
    unass = assignment < 0
    pos = torch.cumsum(unass, 1) - 1               # rank among unassigned
    dest = torch.where(unass & (pos < cap), pos, cap)
    j_ids = torch.arange(n, device=assignment.device).expand(b, n)
    idx = torch.full((b, cap + 1), n, dtype=torch.int64,
                     device=assignment.device)
    return idx.scatter_reduce_(1, dest, j_ids, "amin")[:, :cap]


def _init_state(b, n, m, device):
    """(assignment [B, N + 1] with its spare column, owner of each target
    [B, M], price [B, M]): nothing assigned, prices 0."""
    assignment = torch.full((b, n + 1), -1, dtype=torch.int64, device=device)
    assignment[:, n] = 0
    return (assignment,
            torch.full((b, m), -1, dtype=torch.int64, device=device),
            torch.zeros(b, m, dtype=torch.float32, device=device))


def _auction_round(x1, x2, eps, chunk_size, state, last, idx=None):
    """One auction round: bid, resolve winners, assign with eviction.

    ``idx`` [B, W] selects which points bid this round (``n`` = an idle
    lane); None means all N points bid.  ``state`` is ``_init_state``'s
    triple; its assignment and prices are updated in place."""
    assignment, assignment_inv, price = state
    b, n, _ = x1.shape
    m = x2.shape[1]
    asg = assignment[:, :n]

    if idx is None:
        bid = asg < 0                              # [B, N] am-I-bidding
        x1w = x1
        j_real = torch.arange(n, device=x1.device).expand(b, n)
    else:
        bid = idx < n                              # [B, W]
        idxc = idx.clamp(max=n - 1)
        x1w = torch.gather(x1, 1, idxc[..., None].expand(-1, -1, 3))
        j_real = idx                               # n on an idle lane

    best, better, best_i = _top2_dispatch(x1w, x2, price, chunk_size)
    best_i = best_i.long()
    bid_inc = best - better + eps                  # > 0

    # winner per target among bidders: max increment, ties -> lowest j
    inc_cand = torch.where(bid, bid_inc, bid_inc.new_tensor(_NEG))
    seg_max = price.new_full((b, m), _NEG).scatter_reduce_(
        1, best_i, inc_cand, "amax")
    is_top = bid & (bid_inc >= seg_max.gather(1, best_i))
    seg_argj = torch.full((b, m), n, dtype=torch.int64,
                          device=x1.device).scatter_reduce_(
        1, best_i, torch.where(is_top, j_real, n), "amin")
    winner = is_top & (j_real == seg_argj.gather(1, best_i))

    if last:
        # final round: every unassigned point takes its bid target,
        # conflicts allowed; only the assignment matters downstream
        asg.copy_(torch.where(bid, best_i, asg))
        return assignment, assignment_inv, price

    # evict previous owners of contested targets, then assign the winners;
    # a lane without a winner writes the spare column
    prev_owner = assignment_inv.gather(1, best_i)
    evict = winner & (prev_owner >= 0)
    assignment.scatter_(1, torch.where(evict, prev_owner, n), -1)
    assignment.scatter_(1, torch.where(winner, j_real, n), best_i)
    # seg_argj holds the winner of every target that has one
    assignment_inv = torch.where(seg_argj < n, seg_argj, assignment_inv)
    # one winner per target: the other addends are exact zeros
    price.scatter_add_(1, best_i, torch.where(winner, bid_inc,
                                              torch.zeros_like(bid_inc)))
    return assignment, assignment_inv, price


def _assignment_from_inv(inv, n):
    """The point -> target assignment ``[B, N + 1]`` from the target ->
    owner map, which is all the window kernel keeps (one to one on its
    entries >= 0)."""
    b, m = inv.shape
    k_ids = torch.arange(m, device=inv.device).expand(b, m)
    assignment = torch.full((b, n + 1), -1, dtype=torch.int64,
                            device=inv.device)
    assignment.scatter_(1, torch.where(inv >= 0, inv, n), k_ids)
    assignment[:, n] = 0
    return assignment


def _max_unassigned(assignment):
    """The largest unassigned count of a row, on the host."""
    return int((assignment[:, :-1] < 0).sum(1).max())


def _window_tail(x1, x2, eps, rounds, state, iters):
    """The tail as windows: compact once, run up to ``_WINDOW_ROUNDS``
    rounds in one ``auction_window`` call, until every point is assigned or
    the round budget is out.  Bidders assigned inside a window stop bidding
    there; points evicted by an owner outside it enter the next window."""
    b, n, _ = x1.shape
    _, inv, price = state
    inv = inv.to(torch.int32)
    while rounds < iters - 1 and int((inv < 0).sum(1).max()) > 0:
        idx = _compact_unassigned(_assignment_from_inv(inv, n)[:, :n],
                                  _WINDOW_W)
        x1w = torch.gather(x1, 1, idx.clamp(max=n - 1)[..., None]
                           .expand(-1, -1, 3))
        price, inv, used = auction_window(
            x1w, idx.to(torch.int32).contiguous(), x2, price, inv,
            iters - 1 - rounds, eps, n, rounds_cap=_WINDOW_ROUNDS)
        rounds += int(used.max())
    inv = inv.long()
    return rounds, (_assignment_from_inv(inv, n), inv, price)


def emd_auction_with_rounds(xyz1, xyz2, eps=0.005, iters=50,
                            chunk_size=2048):
    """``emd_auction`` that also reports the auction rounds used (the loop
    ends early once every point is assigned)."""
    if xyz1.shape != xyz2.shape:
        raise ValueError("EMD requires equal-size clouds")
    # imported here: the parallel package imports the losses
    from cloud_transformers_tpu_torch.parallel.mesh import points_mesh
    if points_mesh() is not None:
        raise ValueError("the EMD auction matches whole clouds and cannot "
                         "run under a points axis; train on the Chamfer "
                         "distance there")
    b, n, _ = xyz1.shape
    x1 = xyz1.detach().float()
    x2 = xyz2.detach().float()
    state = _init_state(b, n, n, x1.device)

    rounds = 0
    if iters > 1:
        caps = [c for c in (n // 8, n // 16, n // 32, n // 64) if c >= 256]
        use_window = _WINDOW_TAIL and n >= _WINDOW_MIN_N
        if use_window:
            head_caps = [c for c in caps if c > 2 * _WINDOW_W]
            widths = [None] + head_caps
            exits = head_caps + [2 * _WINDOW_W]
        else:
            widths = [None] + caps
            exits = caps + [0]
        with torch.no_grad():
            for cap, until in zip(widths, exits):
                while (rounds < iters - 1
                       and _max_unassigned(state[0]) > until):
                    idx = (None if cap is None else
                           _compact_unassigned(state[0][:, :n], cap))
                    state = _auction_round(x1, x2, eps, chunk_size, state,
                                           last=False, idx=idx)
                    rounds += 1
            if use_window:
                rounds, state = _window_tail(x1, x2, eps, rounds, state,
                                             iters)
    with torch.no_grad():
        state = _auction_round(x1, x2, eps, chunk_size, state, last=True)
    assignment = state[0][:, :n]

    matched = torch.gather(x2, 1, assignment[..., None].expand(-1, -1, 3))
    dist = ((xyz1 - matched) ** 2).sum(-1)
    return dist, assignment, rounds + 1


def emd_auction(xyz1, xyz2, eps=0.005, iters=50, chunk_size=2048):
    """Auction-assignment EMD.

    xyz1 [B, N, 3] is the predicted cloud (it gets the gradient), xyz2
    [B, N, 3] the ground truth (it gets none).  -> (dist [B, N]: squared
    distance to the matched point, differentiable in xyz1 through the fixed
    assignment; assignment [B, N] int64: the matched index into xyz2)."""
    dist, assignment, _ = emd_auction_with_rounds(xyz1, xyz2, eps, iters,
                                                  chunk_size)
    return dist, assignment


def loss_emd(pred, gt, eps=0.005, iters=50, chunk_size=2048):
    """mean(sqrt(dist)), the completion trainer's loss."""
    dist, _ = emd_auction(pred, gt, eps, iters, chunk_size)
    return torch.sqrt(dist + 1e-12).mean()
