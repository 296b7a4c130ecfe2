"""Splat-max and Slice on flat per-(batch, head) grids, with their kernels.

Counterpart of ``cloud_transformers_tpu/ops/pallas_splat.py``, reduced to
what the forward pass needs.  Grids are flat ``[R = B*H, G, F]`` with cells
in row-major (x, y[, z]) order and F contiguous (the JAX package's
``kernel_to_flat`` layout); the TPU's ``[R, X*F_pad, lanes]`` layout exists
for its vector unit and is not copied.

Point mappings are the JAX package's: ``x0``/``lane0`` ``[R, K]`` int32 base
cell (lane = y, or y*Z + z), ``w_lo``/``w_hi`` ``[R, K, 4]`` f32 vertex
weights for rows x0 and x0+1 at lane offsets ``lane_offsets(sizes)``
(2D carries zero weights in slots 2 and 3).

Each wrapper runs its CUDA kernel (``csrc/splat_slice.cu``) on a CUDA tensor
and its plain PyTorch version on a CPU tensor; nothing falls back.  The
wrappers count their kernel launches in ``<wrapper>.launches``.
"""

import torch

from cloud_transformers_tpu_torch.ops import cuda_build


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


def _check_mapping(x0, lane0, w_lo, w_hi, sizes, name, data, data_shape):
    """Raise unless the mapping is [R, K] int32 / [R, K, 4] float32 and
    ``data`` (values or grid) is float32 ``data_shape``, all on one device."""
    if len(sizes) not in (2, 3):
        raise ValueError(f"sizes must be 2D or 3D, got {sizes}")
    r, k = x0.shape
    dev = x0.device
    for n, t, dtype, shape in (
            ("x0", x0, torch.int32, (r, k)),
            ("lane0", lane0, torch.int32, (r, k)),
            ("w_lo", w_lo, torch.float32, (r, k, 4)),
            ("w_hi", w_hi, torch.float32, (r, k, 4)),
            (name, data, torch.float32, data_shape)):
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
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, "values", values,
                   (r, k, values.shape[-1]))
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
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, "grid", grid,
                   (r, kernel_grid_dims(sizes)[2], f))
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
