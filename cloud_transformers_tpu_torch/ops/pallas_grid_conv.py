"""Grouped 'same' 3x3x3 grid convolution on flat grids, with its kernel.

Counterpart of ``cloud_transformers_tpu/ops/pallas_grid_conv.py``
(``pallas_grid_conv``, 3D).  Grids are flat ``[R = B*H, G, F]`` with cells in
row-major (x, y, z) order; row r belongs to head ``r % H``.  The weight is
the grouped conv weight in PyTorch's layout ``[H*F (out), F (in), 3, 3, 3]``
(the JAX param ``[3, 3, 3, F, H*F]`` after ``convert.py``), the bias
``[H*F]``.

``grid_conv3d`` runs the CUDA kernel (``csrc/grid_conv.cu``) on a CUDA
tensor and the plain PyTorch version on a CPU tensor; nothing falls back.
Launches are counted in ``grid_conv3d.launches``.
"""

import torch
import torch.nn.functional as F

from cloud_transformers_tpu_torch.ops import cuda_build

# shared memory the kernel stages its head's weights in without opting in
_MAX_STATIC_SMEM = 48 * 1024


def _check(grid, weight, bias, sizes, heads):
    if len(sizes) != 3:
        raise ValueError(f"grid_conv3d takes 3D sizes, got {sizes}")
    r, g, f = grid.shape
    x, y, z = sizes
    for name, t, shape in (("grid", grid, (r, x * y * z, f)),
                           ("weight", weight, (heads * f, f, 3, 3, 3)),
                           ("bias", bias, (heads * f,))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != grid.device):
            raise ValueError(f"{name}: expected float32 {shape} on "
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
    _check(grid, weight, bias, sizes, heads)
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
