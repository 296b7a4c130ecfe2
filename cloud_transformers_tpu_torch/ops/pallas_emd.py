"""The auction's bid search and its fused window of rounds, with their kernels.

Counterpart of ``cloud_transformers_tpu/ops/pallas_emd.py`` (``pallas_top2``,
``pallas_auction_window``).  The arrays are flat: bidders ``[B, W, 3]``,
targets ``[B, M, 3]``, prices ``[B, M]`` float32, owners ``[B, M]`` int32.
The TPU kernels' ``[.., 8]`` lane padding, their packed target blocks and
their far-away dummy targets exist for that chip's block rules and are not
copied.

    value[j, k] = 3 - sqrt(max(|x1_j|^2 + |x2_k|^2 - 2 <x1_j, x2_k>, 0))
                    - price_k

``top2`` gives, per bidder, the best and second-best value over the targets
and the first target that reaches the best.  ``auction_window`` runs up to
``rounds_cap`` whole auction rounds for a fixed window of bidders.

Each wrapper runs its CUDA kernel (``csrc/emd.cu``) on a CUDA tensor and its
plain PyTorch version on a CPU tensor; nothing falls back.  The wrappers
count their kernel launches in ``<wrapper>.launches``.  The plain versions
round every multiply, add and subtract on its own, in the kernels' order, so
on one device the two agree bit for bit.
"""

import collections
import functools

import torch

from cloud_transformers_tpu_torch.ops import cuda_build

_NEG = -1e9          # "no second-best"; the same in losses/emd.py
_BIG_J = 2 ** 30     # "no bidder" in a per-target lowest-id search
# what one block may have of dynamic shared memory on an H100
_SMEM_BYTES = 232448
# the top2 kernel's block: threads, bidders a lane group, the fewest
# targets a chunk takes (csrc: kTop2Threads, kTop2Bidders)
TOP2_THREADS = 256
TOP2_BIDDERS = 4
TOP2_MIN_CHUNK = 64
# streaming multiprocessors of an H100 SXM; a search should have about two
# blocks of 8 warps on each (256 blocks), and its lane groups should have
# TOP2_FILL_LANES lanes in all before the targets are cut into chunks
SMS = 132
TOP2_FILL_BLOCKS = 256
TOP2_FILL_LANES = TOP2_FILL_BLOCKS * TOP2_THREADS
# the search skips the square root of a pair that cannot enter its
# bidder's top two (exact: bit-equal either way) where a lane has at least
# TOP2_SKIP_MIN targets of a chunk, enough for the threshold to pay
TOP2_SKIP_MIN = 32
Top2Plan = collections.namedtuple("Top2Plan", (
    "threads", "group", "bidders_per_block", "bidder_blocks", "chunks",
    "chunk_len", "blocks", "merge", "skip", "scratch_floats"))
# the window kernel: CTAs of a batch row's cluster, threads a CTA (csrc:
# kWindowCluster, kWindowThreads); shared memory per window lane (a
# partial top two and a list slot), per own lane (id, target, bid target,
# increment, two list slots), per target of a slice (packed target, skip
# terms with the price, bid key, owner), and a few counts and offsets
WINDOW_CLUSTER = 16
WINDOW_THREADS = 512
WINDOW_LANE_BYTES = 20
WINDOW_OWN_LANE_BYTES = 24
WINDOW_TARGET_BYTES = 44
WINDOW_FIXED_BYTES = 4 * (2 + WINDOW_CLUSTER + 1)
WindowPlan = collections.namedtuple("WindowPlan", (
    "cluster", "threads", "slice_len", "lanes_per_cta", "lane_bytes",
    "state_bytes", "state_in_smem", "smem_bytes", "scratch_bytes", "ctas"))


def _sq_norm(x):
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] \
        + x[..., 2] * x[..., 2]


def _values(x1, x1_sq, x2, price):
    """[B, W, C] bid values of bidders against one chunk of targets."""
    cross = (x1[:, :, None, 0] * x2[:, None, :, 0]
             + x1[:, :, None, 1] * x2[:, None, :, 1]
             + x1[:, :, None, 2] * x2[:, None, :, 2])
    d_sq = (x1_sq[:, :, None] + _sq_norm(x2)[:, None, :]) - 2.0 * cross
    return (3.0 - torch.sqrt(d_sq.clamp_min(0.0))) - price[:, None, :]


def top2_plain(x1, x2, price, chunk_size=2048):
    """Plain version of ``top2``: a loop over chunks of targets, each
    chunk's top-2 merged into the running one.  First-occurrence argmax:
    ``max`` returns the first of equal maxima inside a chunk, and a later
    chunk replaces the index only with a strictly greater value."""
    b, w, _ = x1.shape
    m = x2.shape[1]
    x1_sq = _sq_norm(x1)
    best = x1.new_full((b, w), _NEG)
    better = x1.new_full((b, w), _NEG)
    best_i = torch.zeros(b, w, dtype=torch.int64, device=x1.device)
    for k0 in range(0, m, chunk_size):
        value = _values(x1, x1_sq, x2[:, k0:k0 + chunk_size],
                        price[:, k0:k0 + chunk_size])
        c1, a1 = value.max(-1)
        c2 = value.scatter(-1, a1[..., None], _NEG).max(-1).values
        better = torch.maximum(torch.minimum(best, c1),
                               torch.maximum(better, c2))
        best_i = torch.where(c1 > best, k0 + a1, best_i)
        best = torch.maximum(best, c1)
    return best, better, best_i.to(torch.int32)


def top2_merge(parts):
    """Plain version of the kernel's merge of chunked partial results:
    ``parts`` is a list of (best, better, best_i) over disjoint sets of
    targets, in any order (best_i the global target index).  best = max,
    the lower index on equal best, better = max(min(best_1, best_2),
    max(better_1, better_2)); commutative and associative, so the result
    does not depend on the order or the chunking."""
    best, better, best_i = parts[0]
    for ob, obt, oi in parts[1:]:
        better = torch.maximum(torch.minimum(best, ob),
                               torch.maximum(better, obt))
        take = (ob > best) | ((ob == best) & (oi < best_i))
        best_i = torch.where(take, oi, best_i)
        best = torch.maximum(best, ob)
    return best, better, best_i


def _check(name, t, dtype, shape, device):
    if t.dtype is not dtype or t.shape != shape or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def top2_plan(b, w, m):
    """Launch arithmetic of the bid search (``csrc/emd.cu``) for ``b`` rows
    of ``w`` bidders against ``m`` targets.  A group of ``group``
    neighbouring lanes holds ``TOP2_BIDDERS`` bidders in all its lanes and
    its lanes split the targets, so a block of ``threads`` holds
    ``bidders_per_block`` = threads / group * TOP2_BIDDERS consecutive
    bidders; ``bidder_blocks`` blocks cover a row's bidders.  ``group`` is
    the smallest power of two from 8 to 32 that gives the bidder groups
    ``TOP2_FILL_LANES`` lanes; where that is not enough the targets are cut
    into ``chunks`` chunks of ``chunk_len`` (the last one ragged), one
    block each, until there are ``TOP2_FILL_BLOCKS`` blocks (fewer where a
    chunk would hold fewer than ``TOP2_MIN_CHUNK`` targets).  With more
    than one chunk the last block of a row of blocks to finish merges the
    chunks' partial results.  ``skip``: whether the search skips the
    square root of pairs that cannot enter a top two (where a lane has
    ``TOP2_SKIP_MIN`` targets of a chunk or more).  ``scratch_floats``: the
    partial results.
    Cached per shape, as are the entry point's integers built from it."""
    return _top2_plan(b, w, m)


@functools.lru_cache(maxsize=None)
def _top2_plan(b, w, m):
    if b < 1 or w < 1 or m < 1:
        raise ValueError(f"top2 needs B, W, M >= 1, got {(b, w, m)}")
    sets = b * -(-w // TOP2_BIDDERS)
    group = 8
    while group < 32 and sets * group < TOP2_FILL_LANES:
        group *= 2
    per_block = TOP2_THREADS // group * TOP2_BIDDERS
    bidder_blocks = -(-w // per_block)
    rows = b * bidder_blocks
    want = min(-(-TOP2_FILL_BLOCKS // rows), max(1, m // TOP2_MIN_CHUNK))
    chunk_len = -(-m // want)
    chunks = -(-m // chunk_len)
    partial = 3 * chunks * b * w if chunks > 1 else 0
    return Top2Plan(
        threads=TOP2_THREADS, group=group, bidders_per_block=per_block,
        bidder_blocks=bidder_blocks, chunks=chunks, chunk_len=chunk_len,
        blocks=rows * chunks, merge=chunks > 1,
        skip=chunk_len >= TOP2_SKIP_MIN * group, scratch_floats=partial)


def top2(x1, x2, price):
    """Bid search: x1 [B, W, 3], x2 [B, M, 3], price [B, M] float32 ->
    (best [B, W], better [B, W] float32, best_i [B, W] int32)."""
    b, w, _ = x1.shape
    m = x2.shape[1]
    dev = x1.device
    _check("x1", x1, torch.float32, (b, w, 3), dev)
    _check("x2", x2, torch.float32, (b, m, 3), dev)
    _check("price", price, torch.float32, (b, m), dev)
    if m < 1:
        raise ValueError("top2 needs at least one target")
    if not x1.is_cuda:
        return top2_plain(x1, x2, price)
    out = _launch_top2(x1, x2, price)
    top2.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _top2_params(b, w, m, skip):
    """(plan, ``ct_emd_top2``'s integers for one shape as
    ``cuda_build.int_params``); ``skip`` None takes the plan's.  The cache
    keeps the array alive."""
    plan = _top2_plan(b, w, m)
    return plan, cuda_build.int_params(
        b, w, m, plan.threads, plan.group, plan.bidder_blocks, plan.chunks,
        plan.chunk_len, int(plan.skip if skip is None else skip))


def _launch_top2(x1, x2, price, skip=None):
    """The kernel behind ``top2`` on checked CUDA inputs, with the square-
    root skip as the plan has it (``skip=None``) or forced on or off (the
    card tests hold both to the plain version); counts nothing."""
    b, w, _ = x1.shape
    m = x2.shape[1]
    dev = x1.device
    if w == 0:
        return (x1.new_empty(b, 0), x1.new_empty(b, 0),
                x1.new_empty(b, 0, dtype=torch.int32))
    x1, x2, price = x1.contiguous(), x2.contiguous(), price.contiguous()
    plan, (_, params) = _top2_params(b, w, m, skip)
    best = torch.empty((b, w), dtype=torch.float32, device=dev)
    better = torch.empty((b, w), dtype=torch.float32, device=dev)
    best_i = torch.empty((b, w), dtype=torch.int32, device=dev)
    stream = cuda_build.current_stream(dev)
    scratch = arrived = None
    if plan.merge:
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                              device=dev)
        arrived = _arrival_counts(dev, stream, b * plan.bidder_blocks)
    err = cuda_build.libraries()["emd"].ct_emd_top2(
        x1.data_ptr(), x2.data_ptr(), price.data_ptr(), best.data_ptr(),
        better.data_ptr(), best_i.data_ptr(),
        scratch.data_ptr() if plan.merge else None,
        arrived.data_ptr() if plan.merge else None, params, stream)
    cuda_build.check(err, "top2")
    return best, better, best_i


# arrival counts by (device index, raw stream handle)
_ARRIVED = {}


def _arrival_counts(dev, stream, n):
    """The search's arrival counts for launches on ``stream`` (a raw
    handle) of ``dev``: at least ``n`` int32 zeros, kept between calls.
    The kernel sets each count it uses back to 0, so the launches of one
    stream, which run in order, share them; each stream has its own, so
    that searches on two streams cannot meet in one count.  A CUDA graph
    keeps the counts of the stream it was captured on, which must have
    run a search before the capture (allocating them is not captured)."""
    key = (dev.index, stream)
    have = _ARRIVED.get(key)
    if have is None or have.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "top2: this stream has no arrival counts to capture; run "
                "top2 at this shape on the capture stream before capturing")
        have = torch.zeros(max(n, 1 << 16), dtype=torch.int32, device=dev)
        _ARRIVED[key] = have
    return have


top2.launches = 0


def auction_window_plain(x1w, j_real, x2, price, owner, rem, eps, n,
                         rounds_cap=64, return_bids=False):
    """Plain version of ``auction_window``: the rounds one by one, all rows
    together, a row that is done (or out of budget) masked out.  With
    ``return_bids`` a fourth result counts the bids made: active lanes
    summed over the rounds, which is the work the window needed."""
    b, w, _ = x1w.shape
    m = x2.shape[1]
    dev = x1w.device
    price = price.clone()
    owner = owner.to(torch.int64)
    j = j_real.to(torch.int64)
    valid = j < n
    la = torch.full((b, w), -1, dtype=torch.int64, device=dev)
    done = ~valid.any(1)
    used = torch.zeros(b, dtype=torch.int64, device=dev)
    bids = torch.zeros((), dtype=torch.int64, device=dev)
    for r in range(rounds_cap):
        run = ~done & (r < rem)
        if not bool(run.any()):
            break
        active = (la < 0) & valid & run[:, None]
        bids += active.sum()
        best, better, best_i = top2_plain(x1w, x2, price)
        best_i = best_i.to(torch.int64)
        inc = (best - better) + eps
        inc_m = torch.where(active, inc, inc.new_tensor(_NEG))
        seg_max = price.new_full((b, m), _NEG).scatter_reduce_(
            1, best_i, inc_m, "amax", include_self=True)
        is_top = active & (inc_m >= seg_max.gather(1, best_i))
        seg_argj = torch.full((b, m), _BIG_J, dtype=torch.int64,
                              device=dev).scatter_reduce_(
            1, best_i, torch.where(is_top, j, _BIG_J), "amin",
            include_self=True)
        winner = is_top & (j == seg_argj.gather(1, best_i))
        prev = owner.gather(1, best_i)
        # one winner per target: the other addends are exact zeros
        price.scatter_add_(1, best_i, torch.where(winner, inc,
                                                  torch.zeros_like(inc)))
        owner = torch.where(seg_argj < _BIG_J, seg_argj, owner)
        evicted = torch.where(winner & (prev >= 0), prev, -1)
        ev_lane = ((evicted[:, :, None] == j[:, None, :])
                   & (evicted >= 0)[:, :, None]).any(1)
        la = torch.where(winner, best_i, la)
        la = torch.where(ev_lane, -1, la)
        used += run
        done = done | ~((la < 0) & valid).any(1) | (r + 1 >= rem)
    out = (price, owner.to(torch.int32), used.to(torch.int32))
    return out + (int(bids),) if return_bids else out


def auction_window_plan(b, w, m, state_in_smem=None):
    """Launch arithmetic of the window kernel (``csrc/emd.cu``) for ``b``
    rows of a ``w``-lane window over ``m`` targets: a cluster of
    ``cluster`` CTAs of ``threads`` a row (``ctas`` in all); CTA r owns the
    targets [r * slice_len, (r + 1) * slice_len) and the lanes
    [r * lanes_per_cta, (r + 1) * lanes_per_cta), both cut at the end (a
    CTA may own none).  ``lane_bytes`` of shared memory a CTA for the lane
    arrays, ``state_bytes`` for its slice's state, which goes to shared
    memory where both fit in one CTA's 232448 bytes (``state_in_smem``;
    False forces device memory, the card tests' way to reach it), else to
    ``scratch_bytes`` of device memory.  Raises where the lane arrays alone
    do not fit.  Cached per shape, as are the entry point's integers."""
    return _window_plan(b, w, m, state_in_smem)


@functools.lru_cache(maxsize=None)
def _window_plan(b, w, m, state_in_smem):
    if b < 1 or w < 1 or m < 1:
        raise ValueError(f"auction_window needs B, W, M >= 1, got "
                         f"{(b, w, m)}")
    c = WINDOW_CLUSTER
    slice_len = -(-m // c)
    lanes = -(-w // c)
    lane_bytes = (WINDOW_LANE_BYTES * w + WINDOW_OWN_LANE_BYTES * lanes
                  + WINDOW_FIXED_BYTES)
    state_bytes = WINDOW_TARGET_BYTES * slice_len
    if lane_bytes > _SMEM_BYTES:
        raise ValueError(f"auction_window: a window of {w} lanes does not "
                         "fit in a CTA's shared memory")
    fits = lane_bytes + state_bytes <= _SMEM_BYTES
    if state_in_smem is None:
        state_in_smem = fits
    elif state_in_smem and not fits:
        raise ValueError("auction_window: the state does not fit in shared "
                         "memory")
    state_in_smem = bool(state_in_smem)
    return WindowPlan(
        cluster=c, threads=WINDOW_THREADS, slice_len=slice_len,
        lanes_per_cta=lanes, lane_bytes=lane_bytes, state_bytes=state_bytes,
        state_in_smem=state_in_smem,
        smem_bytes=lane_bytes + state_bytes * state_in_smem,
        scratch_bytes=0 if state_in_smem else b * c * state_bytes,
        ctas=b * c)


def auction_window_cluster_order(x1w, j_real, x2, price, owner, rem, eps, n,
                                 rounds_cap=64):
    """Plain mirror of the window kernel's order of work, a row at a time:
    each round every slice of ``auction_window_plan``'s cluster gives the
    active lanes' top two (``top2_plain``), merged order-free
    (``top2_merge``); per target the largest 64-bit key (the increment's
    bits over 2^32 - 1 - point id) wins; a winner adds its increment and
    takes the target; an assigned lane whose target has another owner now
    bids again.  Equal to ``auction_window_plain`` where the window's lanes
    own no target when it starts (the unassigned points, as the window
    tail gives them)."""
    b, w, _ = x1w.shape
    m = x2.shape[1]
    plan = auction_window_plan(b, w, m)
    cuts = [(k0, min(m, k0 + plan.slice_len))
            for k0 in range(0, m, plan.slice_len)]
    price = price.clone()
    owner = owner.clone()
    used = torch.zeros(b, dtype=torch.int32, device=x1w.device)
    for row in range(b):
        p, o, j = price[row], owner[row], j_real[row].to(torch.int64)
        valid = j < n
        la = torch.full((w,), -1, dtype=torch.int64, device=x1w.device)
        for _ in range(min(rounds_cap, rem)):
            lanes = torch.nonzero((la < 0) & valid)[:, 0]
            if lanes.numel() == 0:
                break
            x = x1w[row, lanes][None]
            parts = []
            for k0, k1 in cuts:
                best, better, idx = top2_plain(x, x2[row, k0:k1][None],
                                               p[k0:k1][None])
                parts.append((best, better, idx + k0))
            best, better, idx = (t[0] for t in top2_merge(parts))
            idx = idx.to(torch.int64)
            inc = (best - better) + eps
            key = ((inc.view(torch.int32).to(torch.int64) << 32)
                   | (0xFFFFFFFF - j[lanes]))
            stands = torch.zeros(m, dtype=torch.int64,
                                 device=x1w.device).scatter_reduce_(
                0, idx, key, "amax")
            won = stands[idx] == key
            t = idx[won]
            p[t] = p[t] + inc[won]
            o[t] = j[lanes][won].to(o.dtype)
            la[lanes[won]] = t
            la = torch.where((la >= 0) & (o[la.clamp(min=0)] != j), -1, la)
            used[row] += 1
    return price, owner, used


def auction_window(x1w, j_real, x2, price, owner, rem, eps, n,
                   rounds_cap=64):
    """Up to ``rounds_cap`` auction rounds for a fixed window of bidders.

    x1w [B, W, 3] the window's coordinates (padding lanes arbitrary),
    j_real [B, W] int32 the lanes' original point ids with ``n`` for a
    padding lane, x2 [B, M, 3], price [B, M] float32, owner [B, M] int32
    (-1 = free), ``rem`` the rounds left of the auction's budget, ``eps``
    the bid slack.  A lane that wins a target stops bidding, a lane whose
    target is taken by another lane of the window bids again, an owner
    outside the window that loses its target waits for a later window.
    The window's lanes own no target when it starts (they are points still
    unassigned).

    -> (price', owner', used [B] int32: rounds each row ran).  The inputs
    are left as they were."""
    b, w, _ = x1w.shape
    m = x2.shape[1]
    dev = x1w.device
    _check("x1w", x1w, torch.float32, (b, w, 3), dev)
    _check("j_real", j_real, torch.int32, (b, w), dev)
    _check("x2", x2, torch.float32, (b, m, 3), dev)
    _check("price", price, torch.float32, (b, m), dev)
    _check("owner", owner, torch.int32, (b, m), dev)
    rem, rounds_cap, eps = int(rem), int(rounds_cap), float(eps)
    if not x1w.is_cuda:
        return auction_window_plain(x1w, j_real, x2, price, owner, rem, eps,
                                    n, rounds_cap)
    out = _launch_window(x1w, j_real, x2, price, owner, rem, eps, n,
                         rounds_cap)
    auction_window.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _window_params(b, w, m, state_in_smem):
    """(plan, ``ct_emd_auction_window``'s integers for one shape as
    ``cuda_build.int_params``); ``state_in_smem`` None takes the plan's."""
    plan = _window_plan(b, w, m, state_in_smem)
    return plan, cuda_build.int_params(
        b, w, m, plan.cluster, plan.threads, plan.slice_len,
        plan.lanes_per_cta, plan.smem_bytes, int(plan.state_in_smem))


def _launch_window(x1w, j_real, x2, price, owner, rem, eps, n, rounds_cap,
                   state_in_smem=None, params=None):
    """The kernel behind ``auction_window`` on checked CUDA inputs, with the
    state where the plan puts it (``state_in_smem=None``) or forced to
    device memory (False); ``params`` replaces the entry point's integers
    (the card tests hand it a plan it must refuse).  Counts nothing."""
    b, w, _ = x1w.shape
    m = x2.shape[1]
    dev = x1w.device
    if w == 0:
        return (price.clone(), owner.clone(),
                torch.zeros(b, dtype=torch.int32, device=dev))
    plan, (_, ints) = _window_params(b, w, m, state_in_smem)
    x1w, j_real, x2 = x1w.contiguous(), j_real.contiguous(), x2.contiguous()
    price, owner = price.contiguous(), owner.contiguous()
    price_out = torch.empty_like(price)
    owner_out = torch.empty_like(owner)
    used = torch.empty(b, dtype=torch.int32, device=dev)
    scratch = (None if plan.state_in_smem else
               torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev))
    err = cuda_build.libraries()["emd"].ct_emd_auction_window(
        x1w.data_ptr(), j_real.data_ptr(), x2.data_ptr(), price.data_ptr(),
        owner.data_ptr(), price_out.data_ptr(), owner_out.data_ptr(),
        used.data_ptr(), None if scratch is None else scratch.data_ptr(),
        ints if params is None else params, int(n), rem, rounds_cap, eps,
        cuda_build.current_stream(dev))
    cuda_build.check(err, "auction_window")
    return price_out, owner_out, used


auction_window.launches = 0
