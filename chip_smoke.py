"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

1. builds the port's CUDA kernels from ``cloud_transformers_tpu_torch/csrc``;
2. prints the card's name and power limit (nvidia-smi);
3. holds every kernel against its plain PyTorch version on the card at each
   shape the classifier gives it (R = B*H = 128, K = 2048): the splat
   exactly, slice and grid conv within 1e-5 of the output scale; the splat
   backward's winner map exactly and its gradients within 1e-6, the slice
   backward and the conv weight gradient within 1e-5; times the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call (``scatter_reduce_`` amax for the splat, ``grid_sample`` for
   the slice, grouped ``conv3d`` for the conv, ``scatter_add_`` for the
   d_grid half of the slice backward, ``convolution_backward`` for the conv
   weight gradient; each is held to the plain version too; no single call
   routes a cotangent to the lowest-indexed winner, so the splat backward
   has none); and computes each kernel's bound from this run's inputs (the
   slice and the two point backwards count only the grid rows their mapping
   touches);
4. serves 100 full-width ScanObjectNN classifier requests (random weights
   from a seed, clouds of 1024 to 3000 points) through
   ``InferenceEngine.classify`` in the B=8 x 2048 bucket, with the launch
   counters set to 0 just before and read just after: 26 splat, 24 slice and
   8 conv launches per forward; ms/forward is the median over the calls;
   then runs one forward under ``torch.cuda.set_sync_debug_mode("error")``,
   so that any operation that makes the host wait for the device raises;
5. runs the same model and weights on the CPU (plain versions) for one cloud
   and holds the card's logits and mask to it (cosine > 0.999, median
   error <= 1e-3);
6. trains the full-width classifier through ``Trainer`` (synthetic
   ScanObjectNN, the optimizer of ``configs/scanobjectnn.yaml``, B=8 x 2048):
   one warm-up step, then 50 timed steps with the six launch counters set
   to 0 just before and read just after: per step 26 splat, 24 slice and 16
   conv launches (8 forward, 8 input gradients), 26 splat-backward, 24
   slice-backward and 8 weight-gradient launches.  Every loss is finite,
   the last 10 are lower on average than the first 10, every parameter has
   a finite gradient and some ``key_bn.bias`` a nonzero one.  Then one
   forward + backward runs under ``set_sync_debug_mode("error")``;
7. gradient parity: the same full-width model (one stage, B=4 x 2048, train
   mode, no dropout) takes one forward + backward on the card (kernels) and
   one on the CPU (plain versions): loss within 1e-4, the concatenated
   gradient with cosine > 0.999 and median error <= 1e-3 of its scale;
8. prints ms/forward and clouds/s, then the training line (ms/step, clouds/s,
   peak memory), then one ``{"kernels": [...]}`` line, then the ``{"ok":
   true, "device": ...}`` line last.

TF32 is off for matmuls and cuDNN convolutions, so everything is float32.
Any failure raises and the exit code is non-zero; without CUDA the script
exits non-zero before printing any result.  ``--profile DIR`` profiles 10
more classify calls: it adds their host wall time, device busy time and the
device's idle share (one window, both clocks) to the result line, and
writes the torch.profiler table by kernel to ``DIR/profile_forward.txt``;
it does the same for 5 more training steps (``DIR/profile_train.txt``).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
B, H, K = 8, 16, 2048
R = B * H
# (sizes, F, splat launches, slice launches) per forward: 4 stages of the
# stage plan, plus the two pools (8^3 x 32 and 16^2 x 16 splat only)
POINT_SHAPES = [((128, 128), 4, 4, 4), ((32, 32, 32), 4, 4, 4),
                ((64, 64), 16, 4, 4), ((16, 16, 16), 16, 4, 4),
                ((16, 16), 16, 5, 4), ((8, 8, 8), 32, 5, 4)]
CONV_SHAPES = [((32, 32, 32), 4, 4), ((16, 16, 16), 16, 4)]
N_REQUESTS = 100   # classify calls in the counted, timed run
PROFILE_CALLS = 10   # classify calls in the --profile window
TRAIN_STEPS = 50   # timed optimizer steps, after one warm-up step
PROFILE_STEPS = 5   # training steps in the --profile window
PARITY_B = 4   # clouds in the card-vs-CPU gradient comparison
TOL = 1e-5   # max abs error relative to max(1, max |plain output|)
ROUTE_TOL = 1e-6   # the same, for the splat backward (no atomics, few terms)
LIB_TOL = 1e-4   # the same, for a library yardstick (other op order)
REPLACES = {
    "splat_max": "cloud_transformers_tpu/ops/pallas_splat.py:528",
    "slice_gather": "cloud_transformers_tpu/ops/pallas_splat.py:780",
    "grid_conv3d": "cloud_transformers_tpu/ops/pallas_grid_conv.py:100",
    "splat_max_bwd": "cloud_transformers_tpu/ops/pallas_splat.py:1179",
    "slice_bwd": "cloud_transformers_tpu/ops/pallas_splat.py:1382",
    "grid_conv3d_dw": "cloud_transformers_tpu/ops/pallas_grid_conv.py:183",
}
_SPLAT_CU = "cloud_transformers_tpu_torch/csrc/splat_slice.cu"
_CONV_CU = "cloud_transformers_tpu_torch/csrc/grid_conv.cu"
SOURCES = {
    "splat_max": _SPLAT_CU, "slice_gather": _SPLAT_CU,
    "grid_conv3d": _CONV_CU, "splat_max_bwd": _SPLAT_CU,
    "slice_bwd": _SPLAT_CU, "grid_conv3d_dw": _CONV_CU,
}
# launches per forward of the serving path, and per training step
PER_FORWARD = {"splat_max": 26, "slice_gather": 24, "grid_conv3d": 8}
PER_STEP = {"splat_max": 26, "slice_gather": 24, "grid_conv3d": 16,
            "splat_max_bwd": 26, "slice_bwd": 24, "grid_conv3d_dw": 8}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mapping_inputs(sizes, f, gen):
    """A kernel-input mapping as the forward makes it: tanh lattice ->
    grid_mapping, rows per (b, h); values like post-BN features.  Also
    returns the keys per row, [R, K, dim], clipped as grid_mapping clips."""
    from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
    from cloud_transformers_tpu_torch.core.splat_slice import (
        _flatten_mapping)
    lat = torch.tanh(torch.randn(B, K, H, len(sizes), generator=gen,
                                 device="cuda"))
    mapping = _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))
    values = torch.randn(R, K, f, generator=gen, device="cuda")
    keys = lat.transpose(1, 2).reshape(R, K, len(sizes)).clamp(
        -1 + 1e-7, 1 - 1e-7)
    return [a.contiguous() for a in mapping], values, keys


def grid_sample_inputs(grid, keys, sizes):
    """The flat grid [R, G, F] and keys [R, K, dim] laid out for
    ``F.grid_sample``: input [R, F, X, Y(, Z)], sample points [R, 1(, 1), K,
    dim] with the coordinates in (last axis, ..., first axis) order.
    align_corners=True maps [-1, 1] to [0, size - 1], the mapping's scale."""
    r, k, dim = keys.shape
    inp = grid.reshape((r,) + tuple(sizes) + (grid.shape[-1],)).movedim(-1, 1)
    pts = keys.flip(-1).reshape((r,) + (1,) * (dim - 1) + (k, dim))
    return inp.contiguous(), pts.contiguous()


def grid_sample_slice(inp, pts):
    return torch.nn.functional.grid_sample(
        inp, pts, mode="bilinear", padding_mode="zeros", align_corners=True)


def held(what, got, plain, tol):
    """Max abs error of ``got`` against ``plain``; raises above ``tol``
    times max(1, max |plain|)."""
    err = float((got - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max abs err {err} > {tol} x {scale}")
    return err


def check_point_backwards(ps, rows, gen, mapping, values, grid, sizes, f,
                          n_splat, n_slice, touched):
    """The splat and slice backward kernels at one main-path shape.  The
    splat's ``grid`` is the forward's own output, so winners exist."""
    shape = f"{'x'.join(map(str, sizes))} F={f}"
    cells = ps.kernel_grid_dims(sizes)[2]
    n_vert = 2 ** len(sizes)
    map_bytes = R * K * 40
    g = torch.randn(grid.shape, generator=gen, device="cuda")
    d_lo, d_hi, d_val, winner = ps.splat_max_bwd(
        *mapping, values, grid, g, sizes, return_winner=True)
    if not torch.equal(winner, ps.splat_winner_plain(*mapping, values, grid,
                                                     sizes)):
        raise AssertionError(f"splat_max_bwd {shape}: the winner map "
                             "differs from the plain version")
    p_lo, p_hi, p_val = ps.splat_max_bwd_plain(*mapping, values, grid, g,
                                               sizes)
    if not torch.equal(d_val != 0, p_val != 0):
        raise AssertionError(f"splat_max_bwd {shape}: another set of "
                             "contributions was routed")
    err = max(held(f"splat_max_bwd {shape} {n}", a, b, ROUTE_TOL)
              for n, a, b in (("d_w_lo", d_lo, p_lo), ("d_w_hi", d_hi, p_hi),
                              ("d_values", d_val, p_val)))
    rows["splat_max_bwd"].append(dict(
        shape=shape, calls=n_splat, max_abs_err=err,
        grid_rows_read=touched, grid_rows=R * cells,
        won=int((winner != ps.NO_WINNER).sum()),
        ms=cuda_ms(lambda: ps.splat_max_bwd(*mapping, values, grid, g,
                                            sizes)),
        plain_ms=cuda_ms(lambda: ps.splat_max_bwd_plain(
            *mapping, values, grid, g, sizes), iters=3, warmup=1),
        library_ms=None,
        # reads the mapping, the values and the touched rows of the grid
        # and of the cotangent; writes d_values and the two d_w
        bound=bound(map_bytes + R * K * f * 4 + 2 * touched * f * 4
                    + R * K * f * 4 + R * K * 32,
                    R * K * n_vert * f * 5)))
    del g, d_lo, d_hi, d_val, winner, p_lo, p_hi, p_val

    g_pts = torch.randn(R, K, f, generator=gen, device="cuda")
    d_grid, d_lo, d_hi = ps.slice_bwd(*mapping, g_pts, grid, sizes)
    p_grid, p_lo, p_hi = ps.slice_bwd_plain(*mapping, g_pts, grid, sizes)
    err = max(held(f"slice_bwd {shape} {n}", a, b, TOL)
              for n, a, b in (("d_grid", d_grid, p_grid),
                              ("d_w_lo", d_lo, p_lo), ("d_w_hi", d_hi, p_hi)))
    # the library yardstick covers the d_grid half only: one scatter_add_
    # of products expanded outside the timing
    idx, w = ps.vertex_index_weights(*mapping, sizes)
    index = idx.reshape(R, K * 8, 1).expand(R, K * 8, f).contiguous()
    src = (w[..., None] * g_pts[:, :, None, :]).reshape(R, K * 8, f)

    def library():
        return torch.zeros(R, cells, f, device="cuda").scatter_add_(
            1, index, src)
    lib_err = held(f"scatter_add_ {shape}", library(), p_grid, LIB_TOL)
    rows["slice_bwd"].append(dict(
        shape=shape, calls=n_slice, max_abs_err=err, library_err=lib_err,
        grid_rows_read=touched, grid_rows=R * cells,
        ms=cuda_ms(lambda: ps.slice_bwd(*mapping, g_pts, grid, sizes)),
        plain_ms=cuda_ms(lambda: ps.slice_bwd_plain(
            *mapping, g_pts, grid, sizes), iters=3, warmup=1),
        library_ms=cuda_ms(library),
        # reads the mapping, the point cotangents and the touched grid
        # rows; writes the whole d_grid (zeros included) and the two d_w
        bound=bound(map_bytes + R * K * f * 4 + touched * f * 4
                    + R * cells * f * 4 + R * K * 32,
                    R * K * n_vert * f * 4)))


def check_kernels(gen):
    """Phase 3: compare, time and bound every kernel at each shape."""
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as gc
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    rows = {name: [] for name in REPLACES}
    for sizes, f, n_splat, n_slice in POINT_SHAPES:
        mapping, values, keys = mapping_inputs(sizes, f, gen)
        cells = ps.kernel_grid_dims(sizes)[2]
        n_vert = 2 ** len(sizes)
        map_bytes = R * K * 40
        grid = ps.splat_max(*mapping, values, sizes)
        plain = ps.splat_max_plain(*mapping, values, sizes)
        n_diff = int((grid != plain).sum())
        if n_diff:
            raise AssertionError(f"splat_max {sizes} F={f}: {n_diff} "
                                 "elements differ from the plain version")
        err = float((grid - plain).abs().max())
        idx, w = ps.vertex_index_weights(*mapping, sizes)
        index = idx.reshape(R, K * 8, 1).expand(R, K * 8, f).contiguous()
        src = (w[..., None] * values[:, :, None, :]).reshape(R, K * 8, f)
        rows["splat_max"].append(dict(
            shape=f"{'x'.join(map(str, sizes))} F={f}", calls=n_splat,
            max_abs_err=err,
            ms=cuda_ms(lambda: ps.splat_max(*mapping, values, sizes)),
            plain_ms=cuda_ms(lambda: ps.splat_max_plain(*mapping, values,
                                                        sizes), iters=5),
            library_ms=cuda_ms(lambda: torch.zeros(R, cells, f,
                                                   device="cuda")
                               .scatter_reduce_(1, index, src, "amax")),
            bound=bound(map_bytes + R * K * f * 4 + R * cells * f * 4,
                        R * K * n_vert * f * 2)))
        del index, src
        # slice reads a grid of the forward's kind: splat output
        out = ps.slice_gather(*mapping, grid, sizes)
        plain = ps.slice_plain(*mapping, grid, sizes)
        err = held(f"slice {sizes} F={f}", out, plain, TOL)
        # the library yardstick: one grid_sample call, layouts made outside
        # the timing; it must compute the same function
        inp, pts = grid_sample_inputs(grid, keys, sizes)
        lib = grid_sample_slice(inp, pts).reshape(R, f, K).transpose(1, 2)
        idx, w = ps.vertex_index_weights(*mapping, sizes)
        lib_err = held(f"grid_sample {sizes} F={f}", lib, plain, LIB_TOL)
        # the grid rows this data reads: distinct (r, cell) with weight > 0
        touched = int(torch.unique(
            (torch.arange(R, device="cuda")[:, None, None] * cells
             + idx)[w > 0]).numel())
        rows["slice_gather"].append(dict(
            shape=f"{'x'.join(map(str, sizes))} F={f}", calls=n_slice,
            max_abs_err=err, library_err=lib_err,
            grid_rows_read=touched, grid_rows=R * cells,
            ms=cuda_ms(lambda: ps.slice_gather(*mapping, grid, sizes)),
            plain_ms=cuda_ms(lambda: ps.slice_plain(*mapping, grid, sizes),
                             iters=5),
            library_ms=cuda_ms(lambda: grid_sample_slice(inp, pts)),
            bound=bound(map_bytes + touched * f * 4 + R * K * f * 4,
                        R * K * n_vert * f * 2)))
        del plain, out, inp, pts, lib, idx, w
        # the backward kernels run 4 times per shape in a step (the pools'
        # fifth splat has no slice)
        check_point_backwards(ps, rows, gen, mapping, values, grid, sizes,
                              f, n_splat, n_slice, touched)
        del grid
    for sizes, f, n_conv in CONV_SHAPES:
        cells = ps.kernel_grid_dims(sizes)[2]
        grid = torch.randn(R, cells, f, generator=gen, device="cuda").relu()
        weight = torch.randn(H * f, f, 3, 3, 3, generator=gen,
                             device="cuda") * (27 * f) ** -0.5
        bias = torch.randn(H * f, generator=gen, device="cuda") * 0.1
        out = gc.grid_conv3d(grid, weight, bias, sizes, H)
        plain = gc.grid_conv3d_plain(grid, weight, bias, sizes, H)
        err = held(f"grid_conv3d {sizes} F={f}", out, plain, TOL)
        x_cf = grid.reshape((B, H) + sizes + (f,)).movedim(-1, 2).reshape(
            (B, H * f) + sizes).contiguous()
        # (output cell, tap) pairs whose input lies inside the grid: the
        # taps over the zero padding need no work
        pairs = int(np.prod([3 * s - 2 for s in sizes]))
        rows["grid_conv3d"].append(dict(
            shape=f"{'x'.join(map(str, sizes))} F={f}", calls=n_conv,
            max_abs_err=err,
            ms=cuda_ms(lambda: gc.grid_conv3d(grid, weight, bias, sizes, H)),
            plain_ms=cuda_ms(lambda: gc.grid_conv3d_plain(
                grid, weight, bias, sizes, H), iters=5),
            library_ms=cuda_ms(lambda: torch.nn.functional.conv3d(
                x_cf, weight, bias, padding=1, groups=H)),
            bound=bound(2 * R * cells * f * 4 + weight.numel() * 4
                        + bias.numel() * 4,
                        R * (pairs * f * f * 2 + cells * f))))
        del out, plain
        # the weight gradient for a cotangent of the output's shape
        g = torch.randn(R, cells, f, generator=gen, device="cuda")
        d_w = gc.grid_conv3d_dw(grid, g, sizes, H)
        plain = gc.grid_conv3d_dw_plain(grid, g, sizes, H)
        err = held(f"grid_conv3d_dw {sizes} F={f}", d_w, plain, TOL)
        g_cf = g.reshape((B, H) + sizes + (f,)).movedim(-1, 2).reshape(
            (B, H * f) + sizes).contiguous()

        def library():
            return torch.ops.aten.convolution_backward(
                g_cf, x_cf, weight, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                False, [0, 0, 0], H, (False, True, False))[1]
        lib_err = held(f"convolution_backward {sizes} F={f}", library(),
                       plain, LIB_TOL)
        rows["grid_conv3d_dw"].append(dict(
            shape=f"{'x'.join(map(str, sizes))} F={f}", calls=n_conv,
            max_abs_err=err, library_err=lib_err,
            ms=cuda_ms(lambda: gc.grid_conv3d_dw(grid, g, sizes, H)),
            plain_ms=cuda_ms(lambda: gc.grid_conv3d_dw_plain(
                grid, g, sizes, H), iters=5),
            library_ms=cuda_ms(library),
            bound=bound(2 * R * cells * f * 4 + weight.numel() * 4,
                        R * pairs * f * f * 2)))
        del grid, g, x_cf, g_cf, d_w, plain
    return rows


def kernel_line(rows, serving, training):
    """Per kernel: times summed over the calls of one pass of its path
    (each shape times its calls): one forward for the three kernels of the
    serving path, one training step for the three backward kernels.
    ``launches`` is the count of that path's run; both runs' counts stand
    beside it."""
    out = []
    for name, shapes in rows.items():
        per = "per_forward" if name in PER_FORWARD else "per_step"

        def total(key):
            return sum(s[key] * s["calls"] for s in shapes)
        t_bound = sum(s["bound"][0] * s["calls"] for s in shapes)
        by = max(shapes, key=lambda s: s["bound"][0] * s["calls"])
        lib = (None if any(s["library_ms"] is None for s in shapes)
               else total("library_ms"))
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": (serving if name in PER_FORWARD else training)[name],
            "launches_serving": serving.get(name, 0),
            "launches_training": training[name], "times_are": per,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": t_bound, "bound_by": by["bound"][1],
            "library_ms": lib,
            "per_shape": [{
                "shape": s["shape"], per: s["calls"],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound"][0], "bound_by": s["bound"][1],
                "library_ms": s["library_ms"],
                "max_abs_err": s["max_abs_err"],
                **{k: s[k] for k in ("library_err", "grid_rows_read",
                                     "grid_rows", "won") if k in s}}
                for s in shapes],
        })
    return {"kernels": out}


def requests(rng, n):
    sizes = [1500, 2048, 3000, 1800, 2048, 2500, 1024, 2048]
    return [rng.uniform(-1, 1, (sizes[i % len(sizes)], 3)).astype(np.float32)
            for i in range(n)]


def parity(card, cpu, what):
    a = card.reshape(-1).double()
    b = cpu.reshape(-1).double()
    cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
    p50 = float((a - b).abs().median())
    log(f"parity {what}: cosine {cos:.7f}  p50 err {p50:.3e}  "
        f"max err {float((a - b).abs().max()):.3e}")
    if not (cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"{what}: card vs CPU cosine {cos}, p50 {p50}")


def device_ms(events):
    """Kernels and copies on the card, summed as the profiler table's
    footer sums them; one stream, so they do not overlap."""
    return sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)) / 1e3


# device kernels by a part of their name, first match wins
KERNEL_GROUPS = (
    ("grid_conv3d_dw", "grid_conv3d_dw"),
    ("grid_conv3d_kernel", "grid_conv3d"),
    ("splat_winner", "splat_max_bwd"), ("splat_route", "splat_max_bwd"),
    ("splat_max_kernel", "splat_max"), ("slice_bwd", "slice_bwd"),
    ("slice_kernel", "slice_gather"),
    ("cudnn", "cuDNN convolutions and their layout kernels"),
    ("implicit_gemm", "cuDNN convolutions and their layout kernels"),
    ("implicit_convolve", "cuDNN convolutions and their layout kernels"),
    ("gemm", "matmuls (cuBLAS, CUTLASS)"),
    ("", "elementwise, reductions, copies and the rest"))


def device_table(events, passes, limit=40):
    """The kernels and copies on the card by self time, per pass (forward
    or training step): sums by ``KERNEL_GROUPS``, then ms and launches of
    the longest kernels."""
    rows = sorted(((e.self_device_time_total / 1e3 / passes,
                    e.count / passes, e.key) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    total = sum(ms for ms, _, _ in rows)
    groups = {}
    for ms, n, key in rows:
        name = next(g for part, g in KERNEL_GROUPS if part in key)
        t, c = groups.get(name, (0.0, 0.0))
        groups[name] = (t + ms, c + n)
    lines = [f"{ms:10.3f} ms {100 * ms / total:5.1f}% {n:9.1f} launches  "
             f"{name}" for name, (ms, n) in sorted(
                 groups.items(), key=lambda item: -item[1][0])]
    lines.append(f"{total:10.3f} ms in all, "
                 f"{sum(n for _, n, _ in rows):.1f} launches")
    lines += [f"{ms:10.3f} ms {n:9.1f} launches  {key[:120]}"
              for ms, n, key in rows[:limit]]
    rest = sum(ms for ms, _, _ in rows[limit:])
    return "\n".join(lines + [f"{rest:10.3f} ms in {len(rows) - limit} "
                              "more kernels"] * (len(rows) > limit))


def endless(loader):
    """Batches of ``loader``, epoch after epoch."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def train_phase(wrappers, smi, profile_dir, exp_root):
    """Phase 6: optimizer steps on the full-width classifier through the
    Trainer, whose experiment directories go under ``exp_root``.
    -> (result dict, launches in the timed steps)."""
    from cloud_transformers_tpu_torch.tasks import classification
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "scanobjectnn.yaml"))
    if (cfg["data"]["batch_size"], cfg["data"]["num_points"]) != (B, K):
        raise AssertionError("configs/scanobjectnn.yaml is not B=8 x 2048")
    cfg["experiment"] = {"root": exp_root}
    trainer = Trainer(
        model_from_config(cfg), cfg, "chip_smoke",
        classification.make_loss_fn(
            float(cfg["train"].get("seg_weight", 0.5))),
        device="cuda", seed=0)
    train_loader, _ = classification.make_datasets(cfg, synthetic=True)
    batches = endless(train_loader)
    model = trainer.model
    if len(model.backbone.trunk.stages) != 4 or \
            model.backbone.stem.out_features != 512:
        raise AssertionError("the trained model is not the full-width one")

    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, per_step in PER_STEP.items():
        if launches[name] != per_step * TRAIN_STEPS:
            raise AssertionError(
                f"{name}: {launches[name]} launches in {TRAIN_STEPS} "
                f"training steps, expected {per_step} per step")
    log(f"launches in {TRAIN_STEPS} training steps: {launches}")

    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 10 steps "
                             f"{first}, last 10 steps {last}")
    key_grad = 0.0
    for name, param in model.named_parameters():
        if param.grad is None or not bool(torch.isfinite(param.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.endswith("key_bn.bias"):
            key_grad = max(key_grad, float(param.grad.abs().max()))
    if not key_grad > 0:
        raise AssertionError("every key_bn.bias gradient is zero: the key "
                             "path through d_w is not connected")
    if trainer.global_step != TRAIN_STEPS + 1 or \
            trainer.optimizer.lrs != [1e-3]:
        raise AssertionError("the trainer's step count or learning rate "
                             f"is off: {trainer.global_step}, "
                             f"{trainer.optimizer.lrs}")

    # forward, backward and the optimizer step never make the host wait
    batch = trainer.to_device(next(batches))
    model.train()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.optimizer.zero_grad()
        loss, _ = trainer.loss_fn(model, batch)
        loss.backward()
        trainer.optimizer.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("training step: no host-device synchronisation")

    ms = float(np.median(step_ms))
    result = {"train_ms_per_step": ms, "train_clouds_per_s": B * 1e3 / ms,
              "train_ms_mean": float(np.mean(step_ms)),
              "train_ms_p10": float(np.percentile(step_ms, 10)),
              "train_ms_p90": float(np.percentile(step_ms, 90)),
              "train_steps": TRAIN_STEPS,
              "train_peak_memory_bytes": int(peak),
              "loss_first10": first, "loss_last10": last,
              "key_bn_bias_grad_max": key_grad, "batch": B, "points": K}

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                trainer.train_step(next(batches))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy = device_ms(events)
        profiled = {"train_profiled_steps": PROFILE_STEPS,
                    "train_profiled_wall_ms_per_step":
                        wall_ms / PROFILE_STEPS,
                    "train_profiled_device_ms_per_step":
                        busy / PROFILE_STEPS,
                    "train_profiled_device_idle_share": 1 - busy / wall_ms}
        table = events.table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, "profile_train.txt"), "w") as fh:
            fh.write(f"{smi}\n{json.dumps(profiled)}\n"
                     f"device kernels, per training step:\n"
                     f"{device_table(events, PROFILE_STEPS)}\n"
                     f"(totals over {PROFILE_STEPS} training steps)\n{table}")
        log(json.dumps(profiled))
        result.update(profiled)
    return result, launches


def gradient_parity():
    """Phase 7: one forward + backward of the same full-width model (one
    stage, train mode, no dropout) on the card with the kernels and on the
    CPU with the plain versions.  -> result dict.

    The weights are a fresh initialisation, so the key BatchNorm's scale is
    0 as at the start of training: the key path's gradient is there (in
    ``key_bn.scale`` and ``key_bn.bias``, through the d_w of both backward
    kernels), and the comparison is well conditioned.  With a key scale of
    0.25 each block multiplies a rounding difference in its keys by about
    (size - 1) / 2, up to 63.5, and the two devices' float32 gradients then
    agree only to a cosine of about 0.98, on the CPU alone as well."""
    from cloud_transformers_tpu_torch.data import ScanObjectNN
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.nn.init import init_model_
    from cloud_transformers_tpu_torch.tasks import classification

    ds = ScanObjectNN(None, train=True, synthetic_items=PARITY_B,
                      num_points=K)
    batch = {k: torch.as_tensor(np.stack([ds[i][k] for i in range(PARITY_B)]))
             for k in ("pcd", "label", "mask")}
    batch["label"] = batch["label"].long()
    loss_fn = classification.make_loss_fn(0.5)
    runs = {}
    for device in ("cuda", "cpu"):
        model = get_model("scanobject_classifier", repeats=1, dropout=0.0)
        init_model_(model, torch.Generator().manual_seed(1))
        model = model.to(device).train()
        t0 = time.perf_counter()
        loss, _ = loss_fn(model, {k: v.to(device) for k, v in batch.items()})
        loss.backward()
        loss = loss.detach()
        runs[device] = (float(loss),
                        {n: p.grad.detach().cpu().double()
                         for n, p in model.named_parameters()})
        log(f"gradient parity: {device} forward + backward in "
            f"{time.perf_counter() - t0:.1f} s, loss {float(loss):.6f}")
    (card_loss, card), (cpu_loss, cpu) = runs["cuda"], runs["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    a = torch.cat([card[n].reshape(-1) for n in cpu])
    b = torch.cat([cpu[n].reshape(-1) for n in cpu])
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("non-finite gradient on the card")
    cos = float(torch.dot(a, b) / (a.norm() * b.norm()))
    scale = float(b.abs().max())
    p50 = float((a - b).abs().median()) / scale
    # per tensor, over those that carry a gradient at all (a bias before a
    # BatchNorm has none: rounding noise, with no direction to compare)
    worst = min(
        ((float(torch.dot(card[n].reshape(-1), cpu[n].reshape(-1))
                / (card[n].norm() * cpu[n].norm())), n)
         for n in cpu if float(cpu[n].abs().max()) > 1e-6 * scale))
    log(f"gradient parity: loss rel diff {loss_rel:.3e}, cosine {cos:.7f}, "
        f"p50 err {p50:.3e} of scale {scale:.3e}, worst tensor cosine "
        f"{worst[0]:.7f} ({worst[1]})")
    if not (loss_rel <= 1e-4 and cos > 0.999 and p50 <= 1e-3):
        raise AssertionError(f"card vs CPU gradients: loss rel diff "
                             f"{loss_rel}, cosine {cos}, p50 {p50}")
    return {"parity_batch": PARITY_B, "parity_loss_rel_diff": loss_rel,
            "parity_grad_cosine": cos, "parity_grad_p50_of_scale": p50,
            "parity_worst_tensor_cosine": worst[0],
            "parity_worst_tensor": worst[1]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help=f"profile {PROFILE_CALLS} classify calls and "
                         f"{PROFILE_STEPS} training steps: device idle "
                         "share, and the tables in DIR/profile_forward.txt "
                         "and DIR/profile_train.txt")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cloud_transformers_tpu_torch.nn.precision import strict_f32
    from cloud_transformers_tpu_torch.ops import cuda_build
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as gc
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    from cloud_transformers_tpu_torch.serve import InferenceEngine

    strict_f32()
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    built = cuda_build.build()
    cuda_build.libraries()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for so in built.values():
        ptxas = so.with_suffix(".log").read_text(errors="replace")
        log("\n".join(line for line in ptxas.splitlines()
                      if "registers" in line or "spill" in line))

    # 2. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # 3. kernels vs plain versions at the main-path shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    rows = check_kernels(gen)
    log(f"kernel checks done in {time.perf_counter() - t0:.1f} s")

    # 4. the main path: serve full-width classifier requests
    rng = np.random.RandomState(0)
    engine = InferenceEngine.build(
        "scanobject_classifier", seed=0, device="cuda",
        batch_buckets=(B,), point_buckets=(K,))
    batches = [requests(rng, B) for _ in range(N_REQUESTS)]
    probs = engine.classify(batches[0])          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    wrappers = {"splat_max": ps.splat_max, "slice_gather": ps.slice_gather,
                "grid_conv3d": gc.grid_conv3d,
                "splat_max_bwd": ps.splat_max_bwd, "slice_bwd": ps.slice_bwd,
                "grid_conv3d_dw": gc.grid_conv3d_dw}
    for w in wrappers.values():
        w.launches = 0
    call_ms = []   # classify returns numpy, so each call ends synchronised
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: w.launches for name, w in wrappers.items()}
    expect = dict(PER_FORWARD, splat_max_bwd=0, slice_bwd=0,
                  grid_conv3d_dw=0)
    for name, per_fwd in expect.items():
        if launches[name] != per_fwd * len(batches):
            raise AssertionError(
                f"{name}: {launches[name]} launches in {len(batches)} "
                f"forwards, expected {per_fwd} per forward")
    if probs.shape != (B, 15) or not np.isfinite(probs).all() or \
            not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad class probabilities {probs}")
    ms_fwd = float(np.median(call_ms))
    log(f"launches in {len(batches)} forwards: {launches}")

    # the forward itself never makes the host wait for the device
    pcd = torch.from_numpy(engine.pad_batch(batches[0])[0]).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            engine.model(pcd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("forward: no host-device synchronisation")

    profiled = {}
    if args.profile:
        # device busy time and host wall time of the same window; the
        # profiler's own host cost makes this idle share an upper bound
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for clouds in batches[:PROFILE_CALLS]:
                engine.classify(clouds)
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy = device_ms(events)
        profiled = {"profiled_calls": PROFILE_CALLS,
                    "profiled_wall_ms_per_forward": wall_ms / PROFILE_CALLS,
                    "profiled_device_ms_per_forward": busy / PROFILE_CALLS,
                    "profiled_device_idle_share": 1 - busy / wall_ms}
        os.makedirs(args.profile, exist_ok=True)
        table = events.table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(args.profile, "profile_forward.txt"),
                  "w") as fh:
            fh.write(f"{smi}\n{json.dumps(profiled)}\n"
                     f"device kernels, per forward:\n"
                     f"{device_table(events, PROFILE_CALLS)}\n"
                     f"(totals over {PROFILE_CALLS} classify calls)\n{table}")
        log(json.dumps(profiled))

    # 5. the same model and weights on the CPU, one cloud
    cloud = batches[0][:1]
    cpu_engine = InferenceEngine.build(
        "scanobject_classifier", seed=0, device="cpu",
        batch_buckets=(1,), point_buckets=(K,))
    (card_cls, card_mask, _), _, _, _ = engine.predict_padded(cloud)
    (cpu_cls, cpu_mask, _), _, _, _ = cpu_engine.predict_padded(cloud)
    for t in (card_cls, card_mask):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite model output on the card")
    parity(card_cls[:1].cpu(), cpu_cls,
           f"class logits {list(cpu_cls.shape)}")
    parity(card_mask[:1].cpu(), cpu_mask,
           f"point mask {list(cpu_mask.shape)}")

    # 6. the second path: training steps at full width
    del engine, cpu_engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        trained, train_launches = train_phase(wrappers, smi, args.profile,
                                              exp_root)
    log(f"training phase done in {time.perf_counter() - t0:.1f} s")

    # 7. the same gradients on the card and on the CPU
    trained.update(gradient_parity())

    # 8. results
    log(f"{ms_fwd:.3f} ms/forward (median) at B={B} x {K} points, "
        f"{B * 1e3 / ms_fwd:.2f} clouds/s "
        f"({len(batches)} classify calls, host clock, synchronised)")
    print(json.dumps({"classify_ms_per_forward": ms_fwd,
                      "clouds_per_s": B * 1e3 / ms_fwd,
                      "classify_ms_mean": float(np.mean(call_ms)),
                      "classify_ms_p10": float(np.percentile(call_ms, 10)),
                      "classify_ms_p90": float(np.percentile(call_ms, 90)),
                      "classify_calls": len(call_ms),
                      "batch": B, "points": K, **profiled}), flush=True)
    log(f"{trained['train_ms_per_step']:.3f} ms/step (median) at B={B} x {K} "
        f"points, {trained['train_clouds_per_s']:.2f} clouds/s, peak memory "
        f"{trained['train_peak_memory_bytes'] / 2 ** 30:.2f} GiB "
        f"({TRAIN_STEPS} steps, host clock, synchronised)")
    print(json.dumps(trained), flush=True)
    print(json.dumps(kernel_line(rows, launches, train_launches)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
