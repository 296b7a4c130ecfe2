"""Grouped 'same' 3x3x3 grid convolution on flat grids and its weight
gradient, with their kernels.

Counterpart of ``cloud_transformers_tpu/ops/pallas_grid_conv.py``
(``pallas_grid_conv`` and ``pallas_grid_conv_dw``, 3D, and
``pack_w_transposed``).  Grids are flat ``[R = B*H, G, F]`` with cells in
row-major (x, y, z) order; row r belongs to head ``r % H``.  The weight is
the grouped conv weight in PyTorch's layout ``[H*F (out), F (in), 3, 3, 3]``
(the JAX param ``[3, 3, 3, F, H*F]`` after ``convert.py``), the bias
``[H*F]``.

``grid_conv3d`` and ``grid_conv3d_dw`` run their CUDA kernels
(``csrc/grid_conv.cu``) on a CUDA tensor and their plain PyTorch versions on
a CPU tensor; nothing falls back.  Launches are counted in
``<wrapper>.launches``.  The conv's input gradient is ``grid_conv3d`` itself
on the cotangent with ``transpose_weight``'s weights and a zero bias; the
autograd Function that joins the three is in ``nn/grouped_conv.py``.
"""

import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.ops import cuda_build

# shared memory the kernel stages its head's weights in without opting in
_MAX_STATIC_SMEM = 48 * 1024


def _check(grid, sizes, heads, **others):
    """Raise unless ``grid`` is float32 [R, X*Y*Z, F] with R a multiple of
    ``heads`` and every other tensor (``weight``, ``bias``, or a cotangent
    ``g`` of the grid's shape) is float32 of its shape on the same device."""
    if len(sizes) != 3:
        raise ValueError(f"the grid conv kernels take 3D sizes, got {sizes}")
    r, _, f = grid.shape
    x, y, z = sizes
    shapes = {"grid": (r, x * y * z, f), "g": (r, x * y * z, f),
              "weight": (heads * f, f, 3, 3, 3), "bias": (heads * f,)}
    for name, t in dict(grid=grid, **others).items():
        if (t.dtype != torch.float32 or tuple(t.shape) != shapes[name]
                or t.device != grid.device):
            raise ValueError(f"{name}: expected float32 {shapes[name]} on "
                             f"{grid.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if r % heads:
        raise ValueError(f"rows {r} not a multiple of heads {heads}")


def grid_conv3d_plain(grid, weight, bias, sizes, heads):
    """Plain version: the 27 taps as per-head [F, F] products over a
    zero-padded copy of the grid."""
    r, _, f = grid.shape
    x, y, z = sizes
    b = r // heads
    g = F.pad(grid.reshape(b, heads, x, y, z, f), (0, 0, 1, 1, 1, 1, 1, 1))
    w = weight.reshape(heads, f, f, 27)                  # [h, fo, fi, tap]
    out = bias.reshape(1, heads, 1, 1, 1, f).expand(b, heads, x, y, z, f)
    acc = torch.zeros(b, heads, x, y, z, f, dtype=grid.dtype,
                      device=grid.device)
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                tap = (dx * 3 + dy) * 3 + dz
                src = g[:, :, dx:dx + x, dy:dy + y, dz:dz + z, :]
                acc += torch.einsum("bhxyzi,hoi->bhxyzo", src,
                                    w[..., tap])
    return (acc + out).reshape(r, x * y * z, f)


def grid_conv3d(grid, weight, bias, sizes, heads):
    """Grouped 'same' 3x3x3 conv + bias: [R, G, F] -> [R, G, F] f32."""
    _check(grid, sizes, heads, weight=weight, bias=bias)
    if not grid.is_cuda:
        return grid_conv3d_plain(grid, weight, bias, sizes, heads)
    r, _, f = grid.shape
    if 27 * f * f * 4 > _MAX_STATIC_SMEM:
        raise ValueError(f"grid_conv3d kernel takes F <= 21, got {f}")
    args = [a.contiguous() for a in (grid, weight, bias)]
    out = torch.empty_like(args[0])
    lib = cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = lib.ct_grid_conv3d(*(a.data_ptr() for a in args), out.data_ptr(),
                             r, heads, *sizes, f, stream)
    cuda_build.check(err, "grid_conv3d")
    grid_conv3d.launches += 1
    return out


grid_conv3d.launches = 0


def transpose_weight(weight, heads):
    """Weights of the transposed conv, which maps the output's cotangent to
    the input's: per head, (out, in) swapped and the three tap axes flipped.
    [H*F, F, 3, 3, 3] -> [H*F, F, 3, 3, 3]."""
    f = weight.shape[1]
    w = weight.reshape(heads, f, f, 3, 3, 3).transpose(1, 2).flip(3, 4, 5)
    return w.reshape(heads * f, f, 3, 3, 3).contiguous()


# --- weight gradient --------------------------------------------------------

def grid_conv3d_dw_plain(grid, g, sizes, heads):
    """Plain version: per tap, the [F, F] product of the cotangent with the
    shifted, zero-padded grid, summed over cells and batch members."""
    r, _, f = grid.shape
    x, y, z = sizes
    b = r // heads
    gp = F.pad(grid.reshape(b, heads, x, y, z, f), (0, 0, 1, 1, 1, 1, 1, 1))
    g6 = g.reshape(b, heads, x, y, z, f)
    taps = [torch.einsum("bhxyzi,bhxyzo->hoi",
                         gp[:, :, dx:dx + x, dy:dy + y, dz:dz + z, :], g6)
            for dx in range(3) for dy in range(3) for dz in range(3)]
    return torch.stack(taps, -1).reshape(heads * f, f, 3, 3, 3)


def grid_conv3d_dw(grid, g, sizes, heads):
    """Weight gradient of ``grid_conv3d`` for the output cotangent ``g``
    [R, G, F]: ``dW[h*F + fo, fi, dx, dy, dz] = sum over b and cells of
    grid[b*H + h, cell + tap, fi] * g[b*H + h, cell, fo]``, taps outside the
    grid adding nothing.  -> [H*F, F, 3, 3, 3] f32, the parameter layout."""
    _check(grid, sizes, heads, g=g)
    if not grid.is_cuda:
        return grid_conv3d_dw_plain(grid, g, sizes, heads)
    r, _, f = grid.shape
    # threads = F * F * S; each keeps 27 sums that meet in shared memory
    split = max(1, 256 // (f * f))
    if f * f * split * 27 * 4 > _MAX_STATIC_SMEM:
        raise ValueError(f"grid_conv3d_dw kernel takes F <= 21, got {f}")
    args = [a.contiguous() for a in (grid, g)]
    # one scratch row per block of the first pass: (batch member, x plane)
    partial = torch.empty((r // heads) * sizes[0], heads, f, f, 27,
                          dtype=torch.float32, device=grid.device)
    d_weight = torch.empty(heads * f, f, 3, 3, 3, dtype=torch.float32,
                           device=grid.device)
    lib = cuda_build.libraries()["grid_conv"]
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    err = lib.ct_grid_conv3d_dw(*(a.data_ptr() for a in args),
                                partial.data_ptr(), d_weight.data_ptr(), r,
                                heads, *sizes, f, split, stream)
    cuda_build.check(err, "grid_conv3d_dw")
    grid_conv3d_dw.launches += 1
    return d_weight


grid_conv3d_dw.launches = 0
