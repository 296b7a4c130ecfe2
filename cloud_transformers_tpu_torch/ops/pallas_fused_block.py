"""The fused MHCT block: splat -> grouped 3^dim conv -> slice in one kernel.

Counterpart of ``cloud_transformers_tpu/ops/pallas_fused_block.py``
(``pallas_fused_block``).  Inputs are those of ``ops/pallas_splat.py``
(flat per-(batch, head) rows: ``x0``/``lane0`` [R, K] int32, ``w_lo``/
``w_hi`` [R, K, 4], ``values`` [R, K, F]) and of ``ops/pallas_grid_conv.py``
(``weight`` [H*F, F, 3, 3(, 3)], ``bias`` [H*F]).  Outputs: the points
[R, K, F], the splatted grid ``gk`` [R, G, F] (the stats read it, and the
splat backward routes through it) and, with ``want_gk2``, the convolved
grid ``gk2`` [R, G, F] (the slice backward reads it; serving skips it).

``fused_block`` runs its CUDA kernel (``csrc/fused_block.cu``) on CUDA
tensors and its plain version, the composition of the three plain ops, on
CPU tensors; nothing falls back.  Launches are counted in
``fused_block.launches``.  The autograd Function is in
``core/splat_slice.py``.
"""

import torch

from cloud_transformers_tpu_torch.ops import cuda_build
from cloud_transformers_tpu_torch.ops.pallas_grid_conv import (
    grid_conv_plain,
    kernel_config,
)
from cloud_transformers_tpu_torch.ops.pallas_splat import (
    _check_mapping,
    kernel_grid_dims,
    slice_plain,
    splat_max_plain,
)


def fused_block_plain(x0, lane0, w_lo, w_hi, values, weight, bias, sizes,
                      heads, want_gk2=False):
    """Plain version: ``splat_max_plain``, ``grid_conv_plain``,
    ``slice_plain`` in turn."""
    gk = splat_max_plain(x0, lane0, w_lo, w_hi, values, sizes)
    gk2 = grid_conv_plain(gk, weight, bias, sizes, heads)
    pts = slice_plain(x0, lane0, w_lo, w_hi, gk2, sizes)
    return (pts, gk, gk2) if want_gk2 else (pts, gk)


def fused_block(x0, lane0, w_lo, w_hi, values, weight, bias, sizes, heads,
                want_gk2=False):
    """Splat-max of ``values`` into per-row grids, the grouped 'same' conv +
    bias of each grid with its head's weights, and the slice of the points
    from the convolved grid.  -> (pts, gk) or (pts, gk, gk2); ``gk`` is
    bit-equal to ``splat_max``'s."""
    r, k = x0.shape
    f = values.shape[-1]
    cells = kernel_grid_dims(sizes)[2]
    _check_mapping(x0, lane0, w_lo, w_hi, sizes, ("values", values, (r, k, f)),
                   ("weight", weight, (heads * f, f) + (3,) * len(sizes)),
                   ("bias", bias, (heads * f,)))
    if r % heads:
        raise ValueError(f"rows {r} not a multiple of heads {heads}")
    if not values.is_cuda:
        return fused_block_plain(x0, lane0, w_lo, w_hi, values, weight, bias,
                                 sizes, heads, want_gk2)
    kernel_config(f, len(sizes))
    args = [a.contiguous()
            for a in (x0, lane0, w_lo, w_hi, values, weight, bias)]
    dev = values.device
    pts = torch.empty(r, k, f, dtype=torch.float32, device=dev)
    gk = torch.empty(r, cells, f, dtype=torch.float32, device=dev)
    # the kernel keeps gk2 in shared memory where it fits, and writes it
    # here when it is wanted or does not fit
    gk2 = torch.empty(r, cells, f, dtype=torch.float32, device=dev)
    x, y, z = (tuple(sizes) + (1,))[:3]
    lib = cuda_build.libraries()["fused_block"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ct_fused_block(
        *(a.data_ptr() for a in args), pts.data_ptr(), gk.data_ptr(),
        gk2.data_ptr(), r, heads, k, f, x, y, z, len(sizes), int(want_gk2),
        stream)
    cuda_build.check(err, "fused_block")
    fused_block.launches += 1
    return (pts, gk, gk2) if want_gk2 else (pts, gk)


fused_block.launches = 0
