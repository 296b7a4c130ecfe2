"""Splat-max and Slice on flat per-(batch, head) grids, forward and backward,
with their kernels.

Counterpart of ``cloud_transformers_tpu/ops/pallas_splat.py``
(``pallas_splat`` op='max', ``pallas_slice``, ``pallas_splat_bwd`` in winner
mode, ``pallas_slice_bwd``).  Grids are flat ``[R = B*H, G, F]`` with cells
in row-major (x, y[, z]) order and F contiguous (the JAX package's
``kernel_to_flat`` layout); the TPU's ``[R, X*F_pad, lanes]`` layout exists
for its vector unit and is not copied.

Point mappings are the JAX package's: ``x0``/``lane0`` ``[R, K]`` int32 base
cell (lane = y, or y*Z + z), ``w_lo``/``w_hi`` ``[R, K, 4]`` f32 vertex
weights for rows x0 and x0+1 at lane offsets ``lane_offsets(sizes)``
(2D carries zero weights in slots 2 and 3).

Each wrapper runs its CUDA kernel (``csrc/splat_slice.cu``) on a CUDA tensor
and its plain PyTorch version on a CPU tensor; nothing falls back.  The
wrappers count their kernel launches in ``<wrapper>.launches`` (one per
wrapper call that reaches the card, whatever number of passes it takes).
The autograd Functions that join forward and backward are in
``core/splat_slice.py``.
"""

import torch

from cloud_transformers_tpu_torch.ops import cuda_build

# the winner map's "no point won this cell": larger than any point index
NO_WINNER = 2 ** 31 - 1


def vertex_decomposition(keys_scaled, sizes):
    """Per-point base cell + per-vertex weights.

    keys_scaled [..., dim] continuous grid coords in [0, size_d - 1] ->
    (x0 [...], lane0 [...] int32, w_lo [..., 4], w_hi [..., 4] f32), with
    the same f32 operation order as the JAX package."""
    dim = len(sizes)
    floored = torch.floor(keys_scaled)
    frac = keys_scaled - floored
    base = floored.to(torch.int32)
    fx = frac[..., 0]
    fy = frac[..., 1]
    x0 = base[..., 0]
    if dim == 2:
        lane0 = base[..., 1]
        zeros = torch.zeros_like(fx)
        w_lo = torch.stack([(1 - fx) * (1 - fy), (1 - fx) * fy,
                            zeros, zeros], -1)
        w_hi = torch.stack([fx * (1 - fy), fx * fy, zeros, zeros], -1)
    else:
        fz = frac[..., 2]
        lane0 = base[..., 1] * sizes[2] + base[..., 2]
        w_lo = torch.stack([
            (1 - fx) * (1 - fy) * (1 - fz),
            (1 - fx) * (1 - fy) * fz,
            (1 - fx) * fy * (1 - fz),
            (1 - fx) * fy * fz,
        ], -1)
        w_hi = torch.stack([
            fx * (1 - fy) * (1 - fz),
            fx * (1 - fy) * fz,
            fx * fy * (1 - fz),
            fx * fy * fz,
        ], -1)
    return x0, lane0.to(torch.int32), w_lo, w_hi


def kernel_grid_dims(sizes):
    """-> (x_dim, lane_extent, cells) of the flat grid layout."""
    lane_extent = 1
    for s in sizes[1:]:
        lane_extent *= int(s)
    return int(sizes[0]), lane_extent, int(sizes[0]) * lane_extent


def lane_offsets(sizes):
    """Lane offsets of the 4 weight slots (2D: last two carry 0 weight)."""
    if len(sizes) == 2:
        return (0, 1, 0, 1)
    return (0, 1, sizes[2], sizes[2] + 1)


def vertex_index_weights(x0, lane0, w_lo, w_hi, sizes):
    """-> (flat cell index [..., 8] int64, weights [..., 8]), lo row first."""
    _, lane_extent, _ = kernel_grid_dims(sizes)
    offs = torch.tensor(lane_offsets(sizes), dtype=torch.int64,
                        device=x0.device)
    lo = (x0.long() * lane_extent + lane0.long())[..., None] + offs
    return (torch.cat([lo, lo + lane_extent], -1),
            torch.cat([w_lo, w_hi], -1))


def _check_mapping(x0, lane0, w_lo, w_hi, sizes, *data):
    """Raise unless the mapping is [R, K] int32 / [R, K, 4] float32 and
    every ``(name, tensor, shape)`` of ``data`` (values, grids, cotangents)
    is float32 of that shape, all on one device."""
    if len(sizes) not in (2, 3):
        raise ValueError(f"sizes must be 2D or 3D, got {sizes}")
    r, k = x0.shape
    dev = x0.device
    for n, t, dtype, shape in (
            ("x0", x0, torch.int32, (r, k)),
            ("lane0", lane0, torch.int32, (r, k)),
            ("w_lo", w_lo, torch.float32, (r, k, 4)),
            ("w_hi", w_hi, torch.float32, (r, k, 4)),
            *((name, t, torch.float32, shape) for name, t, shape in data)):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{n}: expected {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch_args(sizes, k, f):
    _, lane_extent, cells = kernel_grid_dims(sizes)
    offs = lane_offsets(sizes)
    n_vert = 2 if len(sizes) == 2 else 4
    return [k, f, cells, lane_extent, offs[2], offs[3], n_vert]


# --- splat-max ------------------------------------------------------------

def splat_max_plain(x0, lane0, w_lo, w_hi, values, sizes):
    """Plain version: expand the 8 weighted copies and scatter-max them into
    a zero grid (``w * v`` in f32, exactly as the kernel and JAX)."""
    r, k, f = values.shape
    idx, w = vertex_index_weights(x0, lane0, w_lo, w_hi, sizes)  # [R, K, 8]
    pre = w[..., None] * values[:, :, None, :]                   # [R,K,8,F]
    grid = torch.zeros(r, kernel_grid_dims(sizes)[2], f,
                       dtype=values.dtype, device=values.device)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f)
    return grid.scatter_reduce_(1, index, pre.reshape(r, k * 8, f), "amax",
                                include_self=True)


def splat_max(x0, lane0, w_lo, w_hi, values, sizes):
    """grid[r, cell, f] = max(0, max over the (k, v) mapping to cell of
    w[r, k, v] * values[r, k, f]).  -> [R, G, F] f32."""
    r, k = x0.shape
    _check_mapping(x0, lane0, w_lo, w_hi, sizes,
                   ("values", values, (r, k, values.shape[-1])))
    if not values.is_cuda:
        return splat_max_plain(x0, lane0, w_lo, w_hi, values, sizes)
    r, k, f = values.shape
    args = [a.contiguous() for a in (x0, lane0, w_lo, w_hi, values)]
    grid = torch.zeros(r, kernel_grid_dims(sizes)[2], f,
                       dtype=torch.float32, device=values.device)
    lib = cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.ct_splat_max(*(a.data_ptr() for a in args), grid.data_ptr(),
                           r, *_launch_args(sizes, k, f), stream)
    cuda_build.check(err, "splat_max")
    splat_max.launches += 1
    return grid


splat_max.launches = 0


# --- slice ------------------------------------------------------------------

def slice_plain(x0, lane0, w_lo, w_hi, grid, sizes):
    """Plain version: gather the 8 vertex rows and sum them weighted."""
    r, k = x0.shape
    f = grid.shape[-1]
    idx, w = vertex_index_weights(x0, lane0, w_lo, w_hi, sizes)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f)
    gathered = torch.gather(grid, 1, index).reshape(r, k, 8, f)
    return (gathered * w[..., None]).sum(2)


def slice_gather(x0, lane0, w_lo, w_hi, grid, sizes):
    """out[r, k, f] = sum over v of w[r, k, v] * grid[r, idx(r, k, v), f].
    -> [R, K, F] f32."""
    r, k = x0.shape
    f = grid.shape[-1]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes,
                   ("grid", grid, (r, kernel_grid_dims(sizes)[2], f)))
    if not grid.is_cuda:
        return slice_plain(x0, lane0, w_lo, w_hi, grid, sizes)
    args = [a.contiguous() for a in (x0, lane0, w_lo, w_hi, grid)]
    out = torch.empty(r, k, f, dtype=torch.float32, device=grid.device)
    lib = cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = lib.ct_slice(*(a.data_ptr() for a in args), out.data_ptr(),
                       r, *_launch_args(sizes, k, f), stream)
    cuda_build.check(err, "slice_gather")
    slice_gather.launches += 1
    return out


slice_gather.launches = 0


# --- splat-max backward -----------------------------------------------------

def _expanded(x0, lane0, w_lo, w_hi, sizes, f):
    """-> (scatter/gather index [R, K*8, F] int64, weights [R, K, 8])."""
    r, k = x0.shape
    idx, w = vertex_index_weights(x0, lane0, w_lo, w_hi, sizes)
    return idx.reshape(r, k * 8, 1).expand(r, k * 8, f), w


def _matches(x0, lane0, w_lo, w_hi, values, grid, sizes):
    """-> (index [R, K*8, F], weights [R, K, 8], match [R, K, 8, F], point
    [1, K, 1, 1]): ``match`` marks the contributions ``w * v`` (one f32
    multiply) that equal ``grid`` at a cell with ``grid > 0``."""
    r, k, f = values.shape
    index, w = _expanded(x0, lane0, w_lo, w_hi, sizes, f)
    contrib = w[..., None] * values[:, :, None, :]               # [R,K,8,F]
    gmax = torch.gather(grid, 1, index).reshape(r, k, 8, f)
    point = torch.arange(k, device=values.device).reshape(1, k, 1, 1)
    return index, w, (contrib == gmax) & (gmax > 0), point


def _winner(index, match, point, shape):
    """int64 winner map: the lowest matching point index per (cell,
    feature), ``NO_WINNER`` where nothing matches."""
    winner = torch.full(shape, NO_WINNER, dtype=torch.int64,
                        device=match.device)
    return winner.scatter_reduce_(
        1, index, torch.where(match, point, NO_WINNER).reshape(index.shape),
        "amin", include_self=True)


def splat_winner_plain(x0, lane0, w_lo, w_hi, values, grid, sizes):
    """Winner map [R, G, F] int32: the lowest point index k whose
    contribution equals ``grid`` at a cell with ``grid > 0``; ``NO_WINNER``
    where there is none."""
    index, _, match, point = _matches(x0, lane0, w_lo, w_hi, values, grid,
                                      sizes)
    return _winner(index, match, point, grid.shape).to(torch.int32)


def splat_max_bwd_plain(x0, lane0, w_lo, w_hi, values, grid, g, sizes):
    """Plain version: the winner map by a scatter-min of the point index,
    then ``dcon = g`` for the winning contribution of each (cell, feature)
    and 0 for every other one (ties do not share)."""
    index, w, match, point = _matches(x0, lane0, w_lo, w_hi, values, grid,
                                      sizes)
    winner = _winner(index, match, point, grid.shape)
    # the match too: a 2D point's zero-weight slots share cells with its
    # real ones, and must not inherit their win
    win = match & (torch.gather(winner, 1, index).reshape(match.shape)
                   == point)
    dcon = torch.where(win, torch.gather(g, 1, index).reshape(match.shape),
                       0.0)
    d_w = (dcon * values[:, :, None, :]).sum(-1)                 # [R, K, 8]
    d_values = (dcon * w[..., None]).sum(2)                      # [R, K, F]
    return (d_w[..., :4].contiguous(), d_w[..., 4:].contiguous(), d_values)


def splat_max_bwd(x0, lane0, w_lo, w_hi, values, grid, g, sizes,
                  return_winner=False):
    """Backward of ``splat_max``: the cotangent ``g`` [R, G, F] goes to the
    lowest-indexed winner of each (cell, feature).
    -> (d_w_lo [R, K, 4], d_w_hi [R, K, 4], d_values [R, K, F]), and the
    int32 winner map [R, G, F] after them with ``return_winner``."""
    r, k = x0.shape
    f = values.shape[-1]
    cells = kernel_grid_dims(sizes)[2]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, ("values", values, (r, k, f)),
                   ("grid", grid, (r, cells, f)), ("g", g, (r, cells, f)))
    if not values.is_cuda:
        out = splat_max_bwd_plain(x0, lane0, w_lo, w_hi, values, grid, g,
                                  sizes)
        if return_winner:
            out += (splat_winner_plain(x0, lane0, w_lo, w_hi, values, grid,
                                       sizes),)
        return out
    args = [a.contiguous() for a in (x0, lane0, w_lo, w_hi, values, grid, g)]
    dev = values.device
    winner = torch.full((r, cells, f), NO_WINNER, dtype=torch.int32,
                        device=dev)
    d_w_lo = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_w_hi = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_values = torch.empty(r, k, f, dtype=torch.float32, device=dev)
    lib = cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ct_splat_max_bwd(
        *(a.data_ptr() for a in args), winner.data_ptr(), d_w_lo.data_ptr(),
        d_w_hi.data_ptr(), d_values.data_ptr(), r,
        *_launch_args(sizes, k, f), stream)
    cuda_build.check(err, "splat_max_bwd")
    splat_max_bwd.launches += 1
    out = (d_w_lo, d_w_hi, d_values)
    return out + (winner,) if return_winner else out


splat_max_bwd.launches = 0


# --- slice backward ---------------------------------------------------------

def slice_bwd_plain(x0, lane0, w_lo, w_hi, g_pts, grid, sizes):
    """Plain version: scatter-add the weighted point cotangents, and gather
    the vertex rows for the weight gradient."""
    r, k, f = g_pts.shape
    index, w = _expanded(x0, lane0, w_lo, w_hi, sizes, f)
    d_grid = torch.zeros_like(grid).scatter_add_(
        1, index, (w[..., None] * g_pts[:, :, None, :]).reshape(r, k * 8, f))
    gathered = torch.gather(grid, 1, index).reshape(r, k, 8, f)
    d_w = (gathered * g_pts[:, :, None, :]).sum(-1)              # [R, K, 8]
    if len(sizes) == 2:
        # slots 2 and 3 of a 2D mapping are constants, not vertices
        d_w = d_w * d_w.new_tensor([1, 1, 0, 0, 1, 1, 0, 0])
    return d_grid, d_w[..., :4].contiguous(), d_w[..., 4:].contiguous()


def slice_bwd(x0, lane0, w_lo, w_hi, g_pts, grid, sizes):
    """Backward of ``slice_gather`` for the point cotangent ``g_pts``
    [R, K, F]: ``d_grid[r, idx(r,k,v), f] += w[r,k,v] * g_pts[r,k,f]`` and
    ``d_w[r,k,v] = sum_f grid[r, idx(r,k,v), f] * g_pts[r,k,f]``.
    -> (d_grid [R, G, F], d_w_lo [R, K, 4], d_w_hi [R, K, 4]).  On the card
    d_grid is summed with float atomics, in an order that varies by run."""
    r, k = x0.shape
    f = grid.shape[-1]
    cells = kernel_grid_dims(sizes)[2]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, ("g_pts", g_pts, (r, k, f)),
                   ("grid", grid, (r, cells, f)))
    if not grid.is_cuda:
        return slice_bwd_plain(x0, lane0, w_lo, w_hi, g_pts, grid, sizes)
    args = [a.contiguous() for a in (x0, lane0, w_lo, w_hi, g_pts, grid)]
    dev = grid.device
    d_grid = torch.zeros(r, cells, f, dtype=torch.float32, device=dev)
    d_w_lo = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    d_w_hi = torch.empty(r, k, 4, dtype=torch.float32, device=dev)
    lib = cuda_build.libraries()["splat_slice"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ct_slice_bwd(
        *(a.data_ptr() for a in args), d_grid.data_ptr(), d_w_lo.data_ptr(),
        d_w_hi.data_ptr(), r, *_launch_args(sizes, k, f), stream)
    cuda_build.check(err, "slice_bwd")
    slice_bwd.launches += 1
    return d_grid, d_w_lo, d_w_hi


slice_bwd.launches = 0
