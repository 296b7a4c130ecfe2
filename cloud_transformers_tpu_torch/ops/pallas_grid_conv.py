"""Grouped 'same' 3x3x3 and 3x3 grid convolutions on flat grids and their
weight gradients, with their kernels.

Counterpart of ``cloud_transformers_tpu/ops/pallas_grid_conv.py``
(``pallas_grid_conv`` and ``pallas_grid_conv_dw``, 3D; ``pallas_grid_conv2d``
and ``pallas_grid_conv2d_dm``, 2D; ``pack_w_transposed`` and
``pack_m2d_transposed``).  Grids are flat ``[R = B*H, G, F]`` with cells in
row-major (x, y[, z]) order; row r belongs to head ``r % H``.  The weight is
the grouped conv weight in PyTorch's layout ``[H*F (out), F (in), 3, 3(, 3)]``
(the JAX param ``[3, 3(, 3), F, H*F]`` after ``convert.py``), the bias
``[H*F]``.  The TPU kernels' banded matrices (``pack_m2d``) and packed
im2col weights (``pack_w``) exist for its matrix unit and are not copied.

``grid_conv3d``/``grid_conv2d`` and ``grid_conv3d_dw``/``grid_conv2d_dw`` run
their CUDA kernels (``csrc/grid_conv.cu``) on a CUDA tensor and their plain
PyTorch versions on a CPU tensor; nothing falls back.  Launches are counted
in ``<wrapper>.launches``.  The 2D kernels' tiles, threads, shared memory
and blocks come from ``conv2d_tiling``.  The conv's input gradient is the
forward kernel itself on the cotangent with ``transpose_weight``'s weights
and a zero bias (``grid_conv_vjp``); the autograd Function around it is in
``nn/grouped_conv.py``.
"""

import collections
import functools
import itertools

import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.ops import cuda_build

# shared memory one block of an H100 may opt in to (227 KB)
MAX_SMEM = 232448
# the widest head the kernels take: F * F threads of the 3D weight
# gradient's first pass, at most 1024 a block
MAX_FEAT = 32
# streaming multiprocessors of an H100 SXM: the 2D tilings aim at about two
# forward blocks and three weight-gradient blocks per SM
SMS = 132
# the 2D kernels' compile-time widths (any other F runs the run-time
# variant, its channels padded to a multiple of 4)
STATIC_FEAT = (4, 8, 16, 32)
# output cells a 2D forward thread keeps along x (csrc: kCX)
CELLS_X = 4
# sums a 2D weight-gradient thread keeps (4 fo x 4 fi x 3 dy) and the most
# threads of its block (csrc: kDwSums, kDwThreads)
DW_SUMS = 48
DW_THREADS = 256


def _check_feat(feat):
    if not 0 < feat <= MAX_FEAT:
        raise ValueError(f"the grid conv kernels take 1 <= F <= {MAX_FEAT}, "
                         f"got {feat}")


def _ceil(a, b):
    return -(-a // b)


def _bank_conflict(ys, tx, ty, threads):
    """Worst bank conflict (distinct words in one bank) of a warp's input
    loads in the 2D forward, halo row stride ``ys``: thread t of its fo
    group reads word (t // ty) * CELLS_X * ys + t % ty."""
    per_group = (tx // CELLS_X) * ty
    worst = 0
    for w0 in range(0, threads, 32):
        words = {(t % per_group) // ty * CELLS_X * ys + (t % per_group) % ty
                 for t in range(w0, min(w0 + 32, threads))}
        worst = max(worst, max(collections.Counter(
            word % 32 for word in words).values()))
    return worst


def _default_tile(feat):
    """The 2D kernels' (TX, TY) before any cut: 32 x 32 at F <= 4, 32 x 16
    at F <= 8, 16 x 16 above."""
    return (32, 32) if feat <= 4 else (32, 16) if feat <= 8 else (16, 16)


def conv2d_tiling(sizes, feat, rows, heads):
    """Launch arithmetic of the 2D conv kernels (``csrc/grid_conv.cu``) for
    ``rows`` = B * heads grids of ``sizes`` = (X, Y) with ``feat`` channels.

    Forward: one block per (row, tile of ``tile`` = (TX, TY) output cells);
    ``conv_threads`` = TX / CELLS_X * TY * ``groups`` (groups of ``fo``
    output channels), ``conv_smem`` bytes (weights [9][F][F padded to 4] and
    the halo [F][TX + 2][``ys``]), ``conv_blocks`` in all.  Weight gradient:
    ``dw_blocks`` blocks per head over the (batch member, tile) units,
    ``dw_threads`` = ``dw_quads`` * ``dw_split``, ``dw_smem`` bytes, and
    ``partial_rows`` = ``dw_blocks`` scratch rows of H * F * F * 9 floats.
    The default tile (``_default_tile``) is cut to the grid, then halved
    until the forward has about two blocks per SM.  Cached per shape: the
    wrappers call it at every launch."""
    return dict(_conv2d_tiling(tuple(sizes), feat, rows, heads))


@functools.lru_cache(maxsize=None)
def _conv2d_tiling(sizes, feat, rows, heads):
    _check_feat(feat)
    x, y = sizes
    padded = _ceil(feat, 4) * 4
    fo = min(feat, 8) if feat in STATIC_FEAT else 4
    groups = padded // fo
    tx, ty = _default_tile(feat)
    tx = min(tx, _ceil(x, CELLS_X) * CELLS_X)
    ty = min(ty, y)

    def n_tiles(tx, ty):
        return _ceil(x, tx) * _ceil(y, ty)
    while rows * n_tiles(tx, ty) < 2 * SMS and max(tx, ty) > 8:
        if tx >= ty:
            tx = _ceil(tx // 2, CELLS_X) * CELLS_X
        else:
            ty = _ceil(ty, 2)
    threads = tx // CELLS_X * ty * groups
    ys = min(range(ty + 2, ty + 34),
             key=lambda ys: (_bank_conflict(ys, tx, ty, threads), ys))
    quads = (padded // 4) ** 2 * 3
    split = max(1, DW_THREADS // quads)
    units = rows // heads * n_tiles(tx, ty)
    per_block = _ceil(units, _ceil(3 * SMS, heads))
    cfg = {
        "tile": (tx, ty), "fo": fo, "groups": groups, "ys": ys,
        "conv_threads": threads,
        "conv_smem": 4 * (9 * feat * padded + feat * (tx + 2) * ys),
        "conv_blocks": rows * n_tiles(tx, ty),
        "dw_quads": quads, "dw_split": split, "dw_threads": quads * split,
        "dw_smem": 4 * max((tx * ty + (tx + 2) * (ty + 2)) * padded,
                           quads * split * DW_SUMS),
        "dw_blocks": _ceil(units, per_block),
    }
    cfg["partial_rows"] = cfg["dw_blocks"]
    assert threads <= 512 and cfg["dw_threads"] <= DW_THREADS
    assert max(cfg["conv_smem"], cfg["dw_smem"]) <= MAX_SMEM
    return cfg


def kernel_config(feat, dim):
    """Launch shape of the kernels for heads of ``feat`` features on
    ``dim``-D grids: {"conv_smem": bytes of the forward's shared memory,
    "dw_split": S, "dw_threads": threads of the weight gradient's blocks,
    "dw_smem": bytes}; in 2D those of ``conv2d_tiling``'s default tile (a
    grid it need not cut).  Raises for an F the kernels do not take
    (F > 32)."""
    _check_feat(feat)
    if dim == 2:
        cfg = conv2d_tiling(_default_tile(feat), feat, 2 * SMS, 1)
        return {k: cfg[k] for k in ("conv_smem", "dw_split", "dw_threads",
                                    "dw_smem")}
    taps = 3 ** dim
    # threads = F * F * S, each keeping ``taps`` sums that meet in shared
    # memory: 256 threads up to F = 16, F * F above
    split = max(1, 256 // (feat * feat))
    threads = feat * feat * split
    cfg = {"conv_smem": taps * feat * feat * 4, "dw_split": split,
           "dw_threads": threads, "dw_smem": threads * taps * 4}
    assert max(cfg["conv_smem"], cfg["dw_smem"]) <= MAX_SMEM
    return cfg


def _check(grid, sizes, heads, **others):
    """Raise unless ``grid`` is float32 [R, prod(sizes), F] for 2D or 3D
    ``sizes``, with R a multiple of ``heads``, and every other tensor
    (``weight``, ``bias``, or a cotangent ``g`` of the grid's shape) is
    float32 of its shape on the same device."""
    if len(sizes) not in (2, 3):
        raise ValueError(f"the grid conv kernels take 2D or 3D sizes, got "
                         f"{sizes}")
    r, _, f = grid.shape
    cells = 1
    for s in sizes:
        cells *= s
    shapes = {"grid": (r, cells, f), "g": (r, cells, f),
              "weight": (heads * f, f) + (3,) * len(sizes),
              "bias": (heads * f,)}
    for name, t in dict(grid=grid, **others).items():
        if (t.dtype != torch.float32 or tuple(t.shape) != shapes[name]
                or t.device != grid.device):
            raise ValueError(f"{name}: expected float32 {shapes[name]} on "
                             f"{grid.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if r % heads:
        raise ValueError(f"rows {r} not a multiple of heads {heads}")


def _taps(sizes):
    """(tap index, offsets per axis) in the weight's tap order."""
    return enumerate(itertools.product(range(3), repeat=len(sizes)))


def _shifted(padded, offs, sizes):
    """The window of a grid padded by one cell on each side that lines up
    with the output cells for tap offsets ``offs``."""
    return padded[(slice(None), slice(None))
                  + tuple(slice(o, o + s) for o, s in zip(offs, sizes))]


def _padded(grid, sizes, heads):
    r, _, f = grid.shape
    return F.pad(grid.reshape((r // heads, heads) + tuple(sizes) + (f,)),
                 (0, 0) + (1, 1) * len(sizes))


def grid_conv_plain(grid, weight, bias, sizes, heads):
    """Plain version of both convs: the 3^dim taps as per-head [F, F]
    products over a zero-padded copy of the grid."""
    r, _, f = grid.shape
    g = _padded(grid, sizes, heads)
    w = weight.reshape(heads, f, f, -1)                  # [h, fo, fi, tap]
    acc = torch.zeros((r // heads, heads) + tuple(sizes) + (f,),
                      dtype=grid.dtype, device=grid.device)
    for tap, offs in _taps(sizes):
        acc += torch.einsum("bh...i,hoi->bh...o", _shifted(g, offs, sizes),
                            w[..., tap])
    out = acc + bias.reshape((1, heads) + (1,) * len(sizes) + (f,))
    return out.reshape(r, -1, f)


def _conv(wrapper, entry, grid, weight, bias, sizes, heads):
    _check(grid, sizes, heads, weight=weight, bias=bias)
    if not grid.is_cuda:
        return grid_conv_plain(grid, weight, bias, sizes, heads)
    r, _, f = grid.shape
    if len(sizes) == 2:
        cfg = conv2d_tiling(sizes, f, r, heads)
        launch = (*cfg["tile"], cfg["ys"], cfg["conv_threads"],
                  cfg["conv_smem"])
    else:
        kernel_config(f, len(sizes))
        launch = ()
    args = [a.contiguous() for a in (grid, weight, bias)]
    out = torch.empty_like(args[0])
    lib = cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = getattr(lib, entry)(*(a.data_ptr() for a in args), out.data_ptr(),
                              r, heads, *sizes, f, *launch, stream)
    cuda_build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return out


def _need_dim(sizes, dim, what):
    if len(sizes) != dim:
        raise ValueError(f"{what} takes {dim}D sizes, got {sizes}")


def grid_conv3d(grid, weight, bias, sizes, heads):
    """Grouped 'same' 3x3x3 conv + bias: [R, G, F] -> [R, G, F] f32."""
    _need_dim(sizes, 3, "grid_conv3d")
    return _conv(grid_conv3d, "ct_grid_conv3d", grid, weight, bias, sizes,
                 heads)


def grid_conv2d(grid, weight, bias, sizes, heads):
    """Grouped 'same' 3x3 conv + bias: [R, G, F] -> [R, G, F] f32."""
    _need_dim(sizes, 2, "grid_conv2d")
    return _conv(grid_conv2d, "ct_grid_conv2d", grid, weight, bias, sizes,
                 heads)


grid_conv3d.launches = 0
grid_conv2d.launches = 0


def grid_conv(grid, weight, bias, sizes, heads):
    """The conv kernel of the grid's dimension."""
    return (grid_conv2d if len(sizes) == 2 else grid_conv3d)(
        grid, weight, bias, sizes, heads)


def transpose_weight(weight, heads):
    """Weights of the transposed conv, which maps the output's cotangent to
    the input's: per head, (out, in) swapped and the tap axes flipped.
    [H*F, F, 3, 3(, 3)] -> the same shape."""
    f = weight.shape[1]
    taps = tuple(weight.shape[2:])
    w = weight.reshape((heads, f, f) + taps).transpose(1, 2)
    w = w.flip(tuple(range(3, 3 + len(taps))))
    return w.reshape(weight.shape).contiguous()


# --- weight gradient --------------------------------------------------------

def grid_conv_dw_plain(grid, g, sizes, heads):
    """Plain version of both weight gradients: per tap, the [F, F] product
    of the cotangent with the shifted, zero-padded grid, summed over cells
    and batch members."""
    r, _, f = grid.shape
    gp = _padded(grid, sizes, heads)
    gs = g.reshape((r // heads, heads) + tuple(sizes) + (f,))
    taps = [torch.einsum("bh...i,bh...o->hoi", _shifted(gp, offs, sizes), gs)
            for _, offs in _taps(sizes)]
    return torch.stack(taps, -1).reshape((heads * f, f) + (3,) * len(sizes))


def _dw(wrapper, entry, grid, g, sizes, heads):
    _check(grid, sizes, heads, g=g)
    if not grid.is_cuda:
        return grid_conv_dw_plain(grid, g, sizes, heads)
    r, _, f = grid.shape
    if len(sizes) == 2:
        # one scratch row per block of a head
        cfg = conv2d_tiling(sizes, f, r, heads)
        rows = cfg["partial_rows"]
        launch = (*cfg["tile"], rows, cfg["dw_threads"], cfg["dw_smem"])
    else:
        # one scratch row per block of the first pass: (batch member, x
        # plane)
        rows = (r // heads) * sizes[0]
        launch = (kernel_config(f, len(sizes))["dw_split"],)
    args = [a.contiguous() for a in (grid, g)]
    partial = torch.empty(rows, heads, f, f, 3 ** len(sizes),
                          dtype=torch.float32, device=grid.device)
    d_weight = torch.empty((heads * f, f) + (3,) * len(sizes),
                           dtype=torch.float32, device=grid.device)
    lib = cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = getattr(lib, entry)(*(a.data_ptr() for a in args),
                              partial.data_ptr(), d_weight.data_ptr(), r,
                              heads, *sizes, f, *launch, stream)
    cuda_build.check(err, wrapper.__name__)
    wrapper.launches += 1
    return d_weight


def grid_conv3d_dw(grid, g, sizes, heads):
    """Weight gradient of ``grid_conv3d`` for the output cotangent ``g``
    [R, G, F]: ``dW[h*F + fo, fi, dx, dy, dz] = sum over b and cells of
    grid[b*H + h, cell + tap, fi] * g[b*H + h, cell, fo]``, taps outside the
    grid adding nothing.  -> [H*F, F, 3, 3, 3] f32, the parameter layout."""
    _need_dim(sizes, 3, "grid_conv3d_dw")
    return _dw(grid_conv3d_dw, "ct_grid_conv3d_dw", grid, g, sizes, heads)


def grid_conv2d_dw(grid, g, sizes, heads):
    """Weight gradient of ``grid_conv2d``, as ``grid_conv3d_dw`` with 9
    taps.  -> [H*F, F, 3, 3] f32, the parameter layout."""
    _need_dim(sizes, 2, "grid_conv2d_dw")
    return _dw(grid_conv2d_dw, "ct_grid_conv2d_dw", grid, g, sizes, heads)


grid_conv3d_dw.launches = 0
grid_conv2d_dw.launches = 0


def grid_conv_vjp(grid, weight, g, sizes, heads):
    """Gradients of ``grid_conv`` for the output cotangent ``g``:
    (d_grid, d_weight, d_bias).  d_grid is the forward kernel on ``g`` with
    the transposed weights and a zero bias, d_weight the weight-gradient
    kernel, d_bias a plain sum of ``g``, outside any kernel as in the JAX
    package."""
    f = grid.shape[-1]
    g = g.contiguous()
    d_grid = grid_conv(g, transpose_weight(weight, heads),
                       weight.new_zeros(weight.shape[0]), sizes, heads)
    d_weight = (grid_conv2d_dw if len(sizes) == 2 else grid_conv3d_dw)(
        grid, g, sizes, heads)
    d_bias = g.reshape(-1, heads, g.shape[1], f).sum((0, 2)).reshape(-1)
    return d_grid, d_weight, d_bias
