"""Train-mode BatchNorm over channel-last rows, with an optional ReLU, and
its backward, with their kernels.

No counterpart in the JAX package, which leaves BatchNorm to XLA: these
are the kernels of ``nn/norm.BatchNorm``'s channel-last path on the card
(``csrc/batch_norm.cu``).  A tensor ``[..., C]`` is taken as ``N`` rows of
``C`` channels at one row stride, its channels contiguous, so a column
slice of a wider tensor (the key and value halves of a head group's
projection) needs no copy.

``bn_stats`` gives the batch's mean and ``rstd = rsqrt(var + eps)`` (var
the biased variance) and moves the running statistics where asked;
``bn_apply`` gives ``(x - mean) * (rstd * scale) + bias``, then the ReLU
where asked; ``bn_backward`` gives ``dx``, ``d_scale`` and ``d_bias``, with
the statistics' own gradient where ``train`` (mean and rstd the batch's),
without it where they were constants (eval mode).  They take CUDA
tensors alone (``nn/norm.BatchNorm`` sends every other tensor to its plain
ops); ``bn_stats_plain``, ``bn_apply_plain`` and ``bn_backward_plain`` are
their plain PyTorch versions, the yardstick of the tests and of
``chip_smoke.py``.  Launches are counted in ``<wrapper>.launches`` (one a
call: two kernels for ``bn_stats``, one for ``bn_apply``, three for
``bn_backward``).  The blocks come from ``bn_plan``; the workspace between
a pass and its finishing kernel is ``[3 or 2, row blocks, C]`` floats from
``torch.empty``.  Sums are taken in a fixed order with no atomics, so two
runs give the same bits.
"""

import functools

import torch

from cloud_transformers_tpu_torch.ops import cuda_build

# rows a thread a chunk, most chunks a block, most threads and most
# channels a block (csrc: kRows, kChunks, kThreads, kTile)
BN_ROWS = 16
BN_CHUNKS = 8
BN_THREADS = 256
BN_TILE = 128
# blocks a launch aims at before a block takes more than one chunk: about
# four on each of an H100's 132 SMs
BN_BLOCKS = 4 * 132


def _ceil(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def bn_plan(n, c, vec):
    """Launch arithmetic of the kernels for ``n`` rows of ``c`` channels,
    ``vec`` (1 or 4) channels a load: ``lanes`` threads across a channel
    tile of ``lanes * vec`` channels (at most ``BN_TILE``), ``rows_lanes``
    threads down it; a chunk is ``rows_lanes * BN_ROWS`` rows.  The apply
    kernels' blocks take a chunk each: ``apply_blocks`` x
    ``channel_tiles``.  The reductions' take ``chunks`` (``block_rows``
    rows), as many as keep ``BN_BLOCKS`` blocks, up to ``BN_CHUNKS``:
    ``row_blocks`` x ``channel_tiles``, and the workspace of the
    statistics' partial sums (``workspace_bytes``: three floats a row block
    and channel; the backward's takes two)."""
    lanes = min(_ceil(c, vec), BN_TILE // vec)
    rows_lanes = BN_THREADS // lanes
    tiles = _ceil(c, lanes * vec)
    units = _ceil(n, rows_lanes * BN_ROWS)
    chunks = max(1, min(BN_CHUNKS, units * tiles // BN_BLOCKS))
    row_blocks = _ceil(units, chunks)
    return {"vec": vec, "lanes": lanes, "rows_lanes": rows_lanes,
            "threads": lanes * rows_lanes, "apply_blocks": units,
            "chunks": chunks,
            "block_rows": rows_lanes * BN_ROWS * chunks,
            "row_blocks": row_blocks, "channel_tiles": tiles,
            "workspace_bytes": 4 * 3 * row_blocks * c}


def rows_of(x):
    """(N, C, row stride) of ``x [..., C]`` whose channels are contiguous
    and whose rows lie at one stride, else None."""
    if x.dim() == 0 or (x.shape[-1] > 1 and x.stride(-1) != 1):
        return None
    c = x.shape[-1]
    n = x.numel() // max(c, 1)
    sizes, strides = x.shape[:-1], x.stride()[:-1]
    ld = None
    for size, stride in zip(reversed(sizes), reversed(strides)):
        if size == 1:
            continue
        if ld is None:
            ld, step = stride, stride * size
        elif stride != step:
            return None
        else:
            step = stride * size
    if ld is None or n == 1:
        ld = c
    return (n, c, ld) if ld >= c else None


def _vec(c, lds, tensors):
    """4 where C, the row strides and the pointers allow float4 loads."""
    ok = c % 4 == 0 and all(ld % 4 == 0 for ld in lds) and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if ok else 1


def _check(x, *others):
    if not x.is_cuda:
        raise ValueError(f"the BatchNorm kernels take a CUDA tensor, got "
                         f"one on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the BatchNorm kernels take float32, got {x.dtype}")
    for t in others:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("the BatchNorm kernels take float32 tensors on "
                             f"one device, got {t.dtype} on {t.device} "
                             f"beside {x.device}")
    for t in others:
        if t.dim() == 1 and t.stride(0) != 1:
            raise ValueError("a per-channel tensor with stride "
                             f"{t.stride(0)}")
    shape = rows_of(x)
    if shape is None:
        raise ValueError("the BatchNorm kernels take [..., C] with unit "
                         "channel stride and rows at one stride, got "
                         f"shape {tuple(x.shape)} stride {x.stride()}")
    c = shape[1]
    for t in others:
        if t.dim() == 1 and t.numel() != c:
            raise ValueError(f"a per-channel tensor of {t.numel()} for "
                             f"{c} channels")
    return shape


# --- plain versions ---------------------------------------------------------

def bn_stats_plain(x, run_mean, run_var, eps, momentum, update):
    """Plain version of ``bn_stats``: the JAX package's two passes."""
    x2 = x.reshape(-1, x.shape[-1])
    mean = x2.mean(0)
    var = (x2 - mean).square().mean(0)
    if update:
        n = x2.shape[0]
        with torch.no_grad():
            run_mean.lerp_(mean, momentum)
            run_var.lerp_(var * (n / max(n - 1, 1)), momentum)
    return mean, torch.rsqrt(var + eps)


def bn_apply_plain(x, mean, rstd, scale, bias, relu):
    """Plain version of ``bn_apply``."""
    y = (x - mean) * (rstd * scale) + bias
    return torch.relu(y) if relu else y


def bn_backward_plain(x, dy, mean, rstd, scale, bias, relu, train):
    """Plain version of ``bn_backward``: (dx, d_scale, d_bias)."""
    c = x.shape[-1]
    x2, g = x.reshape(-1, c), dy.reshape(-1, c)
    xc = x2 - mean
    if relu:
        g = torch.where(xc * (rstd * scale) + bias <= 0, 0.0, g)
    s1, s2 = g.sum(0), (g * xc).sum(0)
    n = x2.shape[0]
    k1 = s1 / n if train else torch.zeros_like(s1)
    k2 = s2 * rstd * rstd / n if train else torch.zeros_like(s2)
    dx = (rstd * scale) * (g - k1 - xc * k2)
    return dx.reshape(x.shape), s2 * rstd, s1


# --- kernels ----------------------------------------------------------------

def _lib():
    return cuda_build.libraries()["batch_norm"]


def bn_stats(x, run_mean, run_var, eps, momentum, update):
    """(mean [C], rstd [C]) of ``x [..., C]`` over its rows; where
    ``update``, ``run_mean`` and ``run_var`` move towards the mean and the
    unbiased variance by ``momentum``, in place."""
    n, c, ld = _check(x, run_mean, run_var)
    plan = bn_plan(n, c, _vec(c, (ld,), (x,)))
    part = torch.empty(3 * plan["row_blocks"] * c, dtype=torch.float32,
                       device=x.device)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    err = _lib().ct_bn_stats(
        x.data_ptr(), part.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        run_mean.data_ptr(), run_var.data_ptr(), n, c, ld, plan["vec"],
        plan["lanes"], plan["rows_lanes"], plan["chunks"], plan["row_blocks"],
        eps, momentum, n / max(n - 1, 1), int(update),
        cuda_build.current_stream(x.device))
    cuda_build.check(err, "bn_stats")
    bn_stats.launches += 1
    return mean, rstd


def bn_apply(x, mean, rstd, scale, bias, relu):
    """``(x - mean) * (rstd * scale) + bias`` over the channels of ``x
    [..., C]``, then the ReLU where ``relu``: a new contiguous tensor of
    ``x``'s shape."""
    n, c, ld = _check(x, mean, rstd, scale, bias)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    plan = bn_plan(n, c, _vec(c, (ld,), (x,)))
    err = _lib().ct_bn_apply(
        x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), n, c, ld, plan["vec"], plan["lanes"],
        plan["rows_lanes"], plan["apply_blocks"], int(relu),
        cuda_build.current_stream(x.device))
    cuda_build.check(err, "bn_apply")
    bn_apply.launches += 1
    return y


def bn_backward(x, dy, mean, rstd, scale, bias, relu, train):
    """Gradients of ``bn_apply(x, mean, rstd, scale, bias, relu)`` for the
    cotangent ``dy``: (dx of ``x``'s shape, d_scale, d_bias); where
    ``train``, mean and rstd are ``x``'s own batch statistics and dx takes
    their gradient too."""
    n, c, ldx = _check(x, mean, rstd, scale, bias, dy)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} for x {tuple(x.shape)}")
    _, _, ldy = _check(dy)
    dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    plan = bn_plan(n, c, _vec(c, (ldx, ldy), (x, dy)))
    part = torch.empty(2 * plan["row_blocks"] * c, dtype=torch.float32,
                       device=x.device)
    out = torch.empty(4 * c, dtype=torch.float32, device=x.device)
    coef, d_scale, d_bias = out[:2 * c], out[2 * c:3 * c], out[3 * c:]
    err = _lib().ct_bn_backward(
        x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), part.data_ptr(), coef.data_ptr(),
        dx.data_ptr(), d_scale.data_ptr(), d_bias.data_ptr(), n, c, ldx, ldy,
        plan["vec"], plan["lanes"], plan["rows_lanes"], plan["chunks"],
        plan["row_blocks"], plan["apply_blocks"], int(relu), int(train),
        cuda_build.current_stream(x.device))
    cuda_build.check(err, "bn_backward")
    bn_backward.launches += 1
    return dx, d_scale, d_bias


bn_stats.launches = 0
bn_apply.launches = 0
bn_backward.launches = 0
