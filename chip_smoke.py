"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

1. builds the port's CUDA kernels from ``cloud_transformers_tpu_torch/csrc``;
2. prints the card's name and power limit (nvidia-smi);
3. holds every kernel against its plain PyTorch version on the card at each
   shape the classifier gives it (R = B*H = 128, K = 2048): the splat
   exactly (and bit-equal over two runs), slice and grid conv within 1e-5
   of the output scale; the splat
   backward's winner map exactly and its gradients within 1e-6, the slice
   backward within 1e-5 and bit-equal over two runs (its d_grid is summed
   in fixed point), the conv weight gradient within 1e-5; times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (``scatter_reduce_`` amax for the splat, ``grid_sample`` for
   the slice, grouped ``conv3d`` for the conv, ``scatter_add_`` for the
   d_grid half of the slice backward, ``convolution_backward`` for the conv
   weight gradient; each is held to the plain version too; no single call
   routes a cotangent to the lowest-indexed winner, so the splat backward
   has none); and computes each kernel's bound from this run's inputs (the
   slice and the two point backwards count only the grid rows their mapping
   touches).  The kernels of the JAX package's execution switches too: the
   2D conv and its weight gradient at the three 2D head-group shapes and
   the 3D pair at 8^3 x 32 (against ``conv2d``/``conv3d`` and
   ``convolution_backward``), the winner-tracking splat (grid equal to the
   plain version's and to splat_max's, map equal to the plain version's
   and to the two-pass backward's, two runs bit-equal) and the routing
   pass alone (bit-equal to the two-pass backward) at every splat shape,
   and the fused block at every head group's shape, with and without gk2
   (gk exact, points and gk2 within 1e-5, two runs bit-equal), timed
   beside the three separate kernels.  The fused block, the splat, the
   splat backward, the winner-tracking splat, the routing pass and the
   slice backward also at the completion decoder's rows (B = 2 clouds x 16
   heads, K = 16384 points) at every head group's shape, with the same
   gates;
4. serves 100 full-width ScanObjectNN classifier requests (random weights
   from a seed, clouds of 1024 to 3000 points) through
   ``InferenceEngine.classify`` in the B=8 x 2048 bucket, with the launch
   counters set to 0 just before and read just after: 26 splat, 24 slice and
   8 conv launches per forward; ms/forward is the median over the calls;
   then runs one forward under ``torch.cuda.set_sync_debug_mode("error")``,
   so that any operation that makes the host wait for the device raises;
5. runs the same model and weights on the CPU (plain versions) for one cloud
   and holds the card's logits and mask to it (cosine > 0.999, median
   error <= 1e-3); then serves the same 100 requests, runs the sync-free
   forward and holds the card to the CPU under set A
   (``set_grid_conv_strategy("pallas")`` + ``FWD_WINNER``: 26 splat, 24
   slice, 12 3D and 12 2D conv launches per forward) and under set B
   (``set_block_fusion("fused")``: 24 fused blocks and the pools' 2 splats
   per forward), with the switches set and restored by the script;
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
   gradient with cosine > 0.999 and median error <= 1e-3 of its scale.
   Phases 6 and 7 run again under set A (1 + 20 steps, per step 26
   winner-tracking splats and 26 routing passes, no plain splat and no
   two-pass backward, 24 slice and slice backward, 24 3D and 24 2D convs,
   12 weight gradients of each) and under set B (per step 24 fused blocks,
   2 splats, 26 two-pass splat backwards, 24 slice backwards, 12 of each
   conv and each weight gradient);
8. the completion path: trains the full-width ``completion_inpainter`` of
   ``configs/inpainting.yaml`` through ``Trainer`` (synthetic ShapeNet
   pairs, B=2, 2048 partial and 16384 decoder points, the EMD loss at eps
   0.005 and 50 rounds): one warm-up step, then 20 timed steps with the
   eight launch counters set to 0 just before and read just after: per step
   50 splat, 48 slice, 32 conv, 50 splat-backward, 48 slice-backward and 16
   weight-gradient launches, and one ``top2`` launch per auction round.
   Every loss and gradient is finite, every decoder key ``scale`` has a
   nonzero gradient, the assignment is in range; the model's forward,
   backward and update run under ``set_sync_debug_mode("error")`` (the
   auction waits for the device once a round and is left out).  Then it
   saves a checkpoint, restores it into a fresh model with
   ``restore_params_only`` and holds the two reconstructions equal (after
   one more training step under each set, whose loss and gradients must be
   finite and whose launches follow from the default step's), and
   runs the evaluation protocol (F-score@0.01, Chamfer x 1000, EMD at eps
   0.004 and up to 3000 rounds) on 4 synthetic test clouds;
9. the same EMD with the window tail switched on, on a pair that converges
   (B=2 x 16384): it ends inside the budget, one to one, at a cost within
   2% of the staged tail's, through ``auction_window`` launches;
10. the completion path on the card against the CPU: the full-width
   inpainter with one stage each side, B=1, same weights and noise
   (cosine > 0.999, median error <= 1e-3), and ``loss_emd`` at N=2048
   within 2%;
11. prints ms/forward and clouds/s, then the training line (ms/step,
   clouds/s, peak memory), then the completion line (ms/step, clouds/s,
   peak memory, the EMD's share of a step, the evaluation's table values,
   rounds and seconds per cloud, both tails), then the ``{"switched":
   ...}`` line (both sets' serving, training and parity numbers), then one
   ``{"kernels": [...]}`` line of all thirteen kernels (the TPU kernel
   table's twelve rows, row 9 as its forward and its routed backward; the
   2D and 3D convs, their weight gradients, the slice, ``top2``, the
   fused block, the splat, the winner-tracking splat, the splat backward,
   the routing pass and the slice backward also with ``bound_share``,
   bound_ms / ms, per pass and per shape, and per shape whether the kernel
   took less time than its library call in this run; the slice, ``top2``
   and those six also with their device and host times, and per shape
   their launch plan; the fused block also beside the three separate
   kernels, by the loop and on the device; those six also per completion
   decoder step, from the decoder's rows; ``top2`` also per evaluated
   cloud, from the bid searches the evaluation ran at each width), then
   the ``{"ok": true, "device": ...}`` line last.

In phase 3 the auction's two kernels are held too: ``top2`` against
``top2_plain`` at every (B, W, M) the staged schedule gives it at N = 16384
(B = 2 in training, 1 in evaluation; W = 16384, 2048, 1024, 512, 256), at a
shape that is a multiple of nothing, with duplicated targets, with one
target and on a mid-auction state: values and indices bit for bit, with
its square-root skip on and off; ``auction_window`` against
``auction_window_plain`` from a mid-auction state at B=2, W=512, M=16384,
up to 64 rounds: owner map and rounds used equal, prices within 2e-5, two
calls equal.  ``top2`` is timed beside ``torch.cdist`` + ``topk(2)`` (two
library calls and an elementwise pass, not one); its bound is B * W * M
values of 12 float32 operations, or their square roots at the
special-function rate, whichever takes longer.  Every kernel's ``ms`` and
``library_ms`` time a loop of 20 launches (``cuda_ms``), so they hold the
wrapper's host cost wherever it exceeds the kernel's.  The slice, ``top2``,
``grid_sample``, the fused block, the splat kernels and the slice backward
(with ``scatter_add_``) take tens
of microseconds at some shapes, about what a wrapper takes on the host, so
they are also timed by replaying a CUDA graph of 20 calls (``graph_ms``),
which leaves the host out: ``device_ms`` and
``library_device_ms``; ``host_ms`` and ``library_host_ms`` are the host
time to launch one call; ``top2`` on the mid-auction state also with its
square-root skip off.

TF32 is off for matmuls and cuDNN convolutions, so everything is float32.
Any failure raises and the exit code is non-zero; without CUDA the script
exits non-zero before printing any result.  ``--profile DIR`` profiles 10
more classify calls: it adds their host wall time, device busy time and the
device's idle share (one window, both clocks) to the result line, and
writes the torch.profiler table by kernel to ``DIR/profile_forward.txt``;
it does the same for 5 more training steps of the classifier
(``DIR/profile_train.txt``) and of the completion model
(``DIR/profile_completion.txt``), and for the classify calls and training
steps under each set (``DIR/profile_{forward,train}_set_{a,b}.txt``).
"""

import argparse
import contextlib
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
# (sizes, F, calls per forward on the default path, calls per forward
# under set A): 8^3 x 32 reaches the kernel under "pallas" only
CONV_SHAPES = [((32, 32, 32), 4, 4, 4), ((16, 16, 16), 16, 4, 4),
               ((8, 8, 8), 32, 0, 4)]
# the 2D head groups: (sizes, F, calls per forward under set A)
CONV2D_SHAPES = [((128, 128), 4, 4), ((64, 64), 16, 4), ((16, 16), 16, 4)]
# every head group's block: (sizes, F, fused launches per forward, set B)
BLOCK_SHAPES = [((128, 128), 4, 4), ((32, 32, 32), 4, 4), ((64, 64), 16, 4),
                ((16, 16, 16), 16, 4), ((16, 16), 16, 4), ((8, 8, 8), 32, 4)]
# the completion decoder's rows: (clouds, points a cloud); each head group's
# shape takes 4 fused blocks (set B) and 4 splat backwards per step
COMPLETION_ROWS = (2, 16384)
SWITCHED_STEPS = 20   # timed optimizer steps under each set, after a warm-up
N_REQUESTS = 100   # classify calls in the counted, timed run
PROFILE_CALLS = 10   # classify calls in the --profile window
TRAIN_STEPS = 50   # timed optimizer steps, after one warm-up step
PROFILE_STEPS = 5   # training steps in the --profile window
PARITY_B = 4   # clouds in the card-vs-CPU gradient comparison
TOL = 1e-5   # max abs error relative to max(1, max |plain output|)
ROUTE_TOL = 1e-6   # the same, for the splat backward (no atomics, few terms)
LIB_TOL = 1e-4   # the same, for a library yardstick (other op order)
SFU_OP_PER_S = 132 * 16 * 1.98e9   # H100 SXM: 16 special-function results
#                                    a clock on each of 132 SMs at 1.98 GHz
EMD_TOL = 2e-5   # max abs error of bid values and prices (numbers near 3)
# top2 shapes (B, W, M): the widths of the staged schedule at N = 16384 for
# the training batch (B = 2) and for one evaluated cloud (B = 1), and one
# shape that is a multiple of nothing
TOP2_SHAPES = [(b, w, 16384) for b in (2, 1)
               for w in (16384, 2048, 1024, 512, 256)] + [(2, 777, 3001)]
WINDOW_SHAPE = (2, 512, 16384)   # (B, W, M) of the auction_window check
COMPLETION_STEPS = 20   # timed optimizer steps, after one warm-up step
EVAL_CLOUDS = 4
REPLACES = {
    "splat_max": "cloud_transformers_tpu/ops/pallas_splat.py:528",
    "slice_gather": "cloud_transformers_tpu/ops/pallas_splat.py:780",
    "grid_conv3d": "cloud_transformers_tpu/ops/pallas_grid_conv.py:100",
    "splat_max_bwd": "cloud_transformers_tpu/ops/pallas_splat.py:1179",
    "slice_bwd": "cloud_transformers_tpu/ops/pallas_splat.py:1382",
    "grid_conv3d_dw": "cloud_transformers_tpu/ops/pallas_grid_conv.py:183",
    "top2": "cloud_transformers_tpu/ops/pallas_emd.py:112",
    "auction_window": "cloud_transformers_tpu/ops/pallas_emd.py:373",
    "grid_conv2d": "cloud_transformers_tpu/ops/pallas_grid_conv.py:277",
    "grid_conv2d_dw": "cloud_transformers_tpu/ops/pallas_grid_conv.py:362",
    # pallas_splat(..., with_winner=True) and pallas_splat_bwd_routed
    "splat_max_winner": "cloud_transformers_tpu/ops/pallas_splat.py:528",
    "splat_route": "cloud_transformers_tpu/ops/pallas_splat.py:1024",
    "fused_block": "cloud_transformers_tpu/ops/pallas_fused_block.py:196",
}
_SPLAT_CU = "cloud_transformers_tpu_torch/csrc/splat_slice.cu"
_CONV_CU = "cloud_transformers_tpu_torch/csrc/grid_conv.cu"
_EMD_CU = "cloud_transformers_tpu_torch/csrc/emd.cu"
SOURCES = {
    "splat_max": _SPLAT_CU, "slice_gather": _SPLAT_CU,
    "grid_conv3d": _CONV_CU, "splat_max_bwd": _SPLAT_CU,
    "slice_bwd": _SPLAT_CU, "grid_conv3d_dw": _CONV_CU,
    "top2": _EMD_CU, "auction_window": _EMD_CU,
    "grid_conv2d": _CONV_CU, "grid_conv2d_dw": _CONV_CU,
    "splat_max_winner": _SPLAT_CU, "splat_route": _SPLAT_CU,
    "fused_block": "cloud_transformers_tpu_torch/csrc/fused_block.cu",
}
# launches per forward of the serving path, and per training step
PER_FORWARD = {"splat_max": 26, "slice_gather": 24, "grid_conv3d": 8}
PER_STEP = {"splat_max": 26, "slice_gather": 24, "grid_conv3d": 16,
            "splat_max_bwd": 26, "slice_bwd": 24, "grid_conv3d_dw": 8}
# the JAX package's execution switches, as the port names them (launches
# per pass under each: ``set_counts``):
# set A = set_grid_conv_strategy("pallas") + FWD_WINNER: every grid conv on
# the kernels (12 blocks x one 2D and one 3D head group), every splat under
# a gradient tracks its winner map, whose backward is the routing pass alone
# set B = set_block_fusion("fused"): each head group one fused block, the
# two pools plain splats; the backward composes the slice backward, the
# conv's backward kernels (whatever the conv strategy) and the two-pass
# splat backward
SETS = ("set_a", "set_b")
# per completion training step: the encoder (the classifier's backbone, 26
# splats) and the decoder (4 stages x 3 unions x 2 heads groups, 24 splats)
PER_STEP_COMPLETION = {
    "splat_max": 50, "slice_gather": 48, "grid_conv3d": 32,
    "splat_max_bwd": 50, "slice_bwd": 48, "grid_conv3d_dw": 16}
# where ``library_ms`` is not the time of one PyTorch call
LIBRARY_IS = {"top2": "torch.cdist + an elementwise pass + topk(2): two "
                      "library calls, not one"}
# kernels whose entries in the kernels line also give the share of the
# bound reached (bound_ms / ms), per pass and per shape
BOUND_SHARE = ("grid_conv2d", "grid_conv2d_dw", "grid_conv3d",
               "grid_conv3d_dw", "slice_gather", "top2", "fused_block",
               "splat_max_bwd", "splat_route", "splat_max",
               "splat_max_winner", "slice_bwd")
# kernels short enough that a loop of launches may time their wrappers on
# the host: their entries also carry the device time of a CUDA graph
# replay (``device_ms``, ``device_bound_share``; per shape, against the
# library call's, ``faster_than_library_device``)
DEVICE_TIMED = ("slice_gather", "top2", "fused_block", "splat_max_bwd",
                "splat_route", "splat_max", "splat_max_winner", "slice_bwd")
# the path whose run gives each kernel's ``launches``
MAIN_PATH = {"splat_max": "serving", "slice_gather": "serving",
             "grid_conv3d": "serving", "splat_max_bwd": "training",
             "slice_bwd": "training", "grid_conv3d_dw": "training",
             "top2": "completion", "auction_window": "window",
             "grid_conv2d": "serving_set_a",
             "grid_conv2d_dw": "training_set_a",
             "splat_max_winner": "training_set_a",
             "splat_route": "training_set_a", "fused_block": "serving_set_b"}


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


def host_ms(fn, iters=200):
    """Host time to launch one ``fn()``: ``iters`` calls from a synchronised
    start, timed on the host clock before the card catches up (its launch
    queue takes them all).  Where it exceeds the device time, a loop of
    launches (``cuda_ms``) reads this."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def graph_ms(fn, iters=20, replays=5):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA
    graph (after a warm-up on a side stream) and replayed ``replays``
    times between CUDA events.  Beside ``cuda_ms`` for kernels that take
    about as long as their wrappers do on the host: the replay leaves the
    host out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream, whose top2 arrival counts exist
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mapping_inputs(sizes, f, gen, b=B, k=K):
    """A kernel-input mapping as the forward makes it: tanh lattice ->
    grid_mapping, rows per (b, h); values like post-BN features.  Also
    returns the keys per row, [B * H, K, dim], clipped as grid_mapping
    clips."""
    from cloud_transformers_tpu_torch.core.grid_mapping import grid_mapping
    from cloud_transformers_tpu_torch.core.splat_slice import (
        _flatten_mapping)
    lat = torch.tanh(torch.randn(b, k, H, len(sizes), generator=gen,
                                 device="cuda"))
    mapping = _flatten_mapping(grid_mapping(lat, sizes, len(sizes)))
    values = torch.randn(b * H, k, f, generator=gen, device="cuda")
    keys = lat.transpose(1, 2).reshape(b * H, k, len(sizes)).clamp(
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


def touched_rows(ps, mapping, sizes):
    """The grid rows a mapping's points read: distinct (row, cell) with a
    vertex weight > 0."""
    r = mapping[0].shape[0]
    cells = ps.kernel_grid_dims(sizes)[2]
    idx, w = ps.vertex_index_weights(*mapping, sizes)
    return int(torch.unique(
        (torch.arange(r, device="cuda")[:, None, None] * cells
         + idx)[w > 0]).numel())


def shape_name(sizes, f, r=R, k=K):
    """A shape's name in the kernels line: its grid and F, and its rows
    and points where they are not the classifier's."""
    name = f"{'x'.join(map(str, sizes))} F={f}"
    return name if r == R else f"{name} R={r} K={k}"


def check_splat(ps, mapping, values, sizes, f, calls):
    """``splat_max`` at one shape: bit-equal to the plain version and over
    two runs; timed by the loop, by graph replay and on the host, beside
    ``scatter_reduce_`` amax on products expanded outside the timing (held
    to the plain version).  -> (its entry, the grid)."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    grid = ps.splat_max(*mapping, values, sizes)
    plain = ps.splat_max_plain(*mapping, values, sizes)
    n_diff = int((grid != plain).sum())
    if n_diff:
        raise AssertionError(f"splat_max {shape}: {n_diff} elements differ "
                             "from the plain version")
    if not torch.equal(grid, ps.splat_max(*mapping, values, sizes)):
        raise AssertionError(f"splat_max {shape}: two runs differ")
    idx, w = ps.vertex_index_weights(*mapping, sizes)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f).contiguous()
    src = (w[..., None] * values[:, :, None, :]).reshape(r, k * 8, f)

    def library():
        return torch.zeros(r, cells, f, device="cuda").scatter_reduce_(
            1, index, src, "amax")
    if not torch.equal(library(), plain):
        raise AssertionError(f"scatter_reduce_ {shape}: not the plain splat")
    del plain, idx, w

    def splat():
        return ps.splat_max(*mapping, values, sizes)
    row = dict(
        shape=shape, calls=calls, max_abs_err=0.0,
        plan=ps.splat_plan(r, k, f, sizes)._asdict(),
        ms=cuda_ms(splat), device_ms=graph_ms(splat), host_ms=host_ms(splat),
        plain_ms=cuda_ms(lambda: ps.splat_max_plain(*mapping, values, sizes),
                         iters=5),
        library_ms=cuda_ms(library),
        # reads the mapping and the values; writes the grid
        bound=bound(r * k * 40 + r * k * f * 4 + r * cells * f * 4,
                    r * k * 2 ** len(sizes) * f * 2))
    return row, grid


def check_winner_splat(ps, mapping, values, grid, winner, sizes, f, calls):
    """``splat_max_winner`` at one shape: its grid bit-equal to the plain
    version's and to ``splat_max``'s (``grid``), its map equal to the plain
    map and to the two-pass backward's (``winner``), two runs bit-equal;
    timed by the loop, by graph replay and on the host.  -> its entry."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    w_grid, w_map = ps.splat_max_winner(*mapping, values, sizes)
    p_grid, p_map = ps.splat_max_winner_plain(*mapping, values, sizes)
    if not (torch.equal(w_grid, p_grid) and torch.equal(w_map, p_map)
            and torch.equal(w_grid, grid) and torch.equal(w_map, winner)):
        raise AssertionError(f"splat_max_winner {shape}: the grid or the "
                             "winner map differs from the plain version's")
    if not all(torch.equal(a, b) for a, b in zip(
            ps.splat_max_winner(*mapping, values, sizes), (w_grid, w_map))):
        raise AssertionError(f"splat_max_winner {shape}: two runs differ")
    splat_plan = ps.splat_plan(r, k, f, sizes)
    bwd_plan = ps.splat_bwd_plan(r, k, f, sizes)

    def winner_splat():
        return ps.splat_max_winner(*mapping, values, sizes)
    return dict(
        shape=shape, calls=calls,
        max_abs_err=float((w_grid - p_grid).abs().max()),
        won=int((w_map != ps.NO_WINNER).sum()),
        plan={"splat": splat_plan._asdict(),
              "winners_in_splat": ps.winners_in_splat(splat_plan),
              "winner_pass": None if ps.winners_in_splat(splat_plan) else {
                  key: getattr(bwd_plan, key) for key in (
                      "winner_group", "winner_blocks", "winner_features")}},
        ms=cuda_ms(winner_splat), device_ms=graph_ms(winner_splat),
        host_ms=host_ms(winner_splat),
        plain_ms=cuda_ms(lambda: ps.splat_max_winner_plain(
            *mapping, values, sizes), iters=3, warmup=1),
        library_ms=None,
        # reads the mapping and the values; writes the grid and the map
        bound=bound(r * k * 40 + r * k * f * 4 + 2 * r * cells * f * 4,
                    r * k * 2 ** len(sizes) * f * 2))


def check_splat_backward(ps, gen, mapping, values, grid, sizes, f, calls,
                         touched):
    """The splat backward's two passes and the routing pass alone at one
    shape, on the forward's own grid (so that winners exist): the winner
    map equal to the plain one, the same set of contributions routed, the
    gradients within ROUTE_TOL, and ``splat_route`` on that map bit-equal
    to the two-pass backward.  -> (splat_max_bwd's entry, splat_route's
    entry), each timed by the loop, by graph replay and on the host."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    n_vert = 2 ** len(sizes)
    map_bytes = r * k * 40
    plan = ps.splat_bwd_plan(r, k, f, sizes)._asdict()
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
    again = ps.splat_max_bwd(*mapping, values, grid, g, sizes,
                             return_winner=True)
    if not all(torch.equal(a, b) for a, b in zip(again,
                                                 (d_lo, d_hi, d_val, winner))):
        raise AssertionError(f"splat_max_bwd {shape}: two runs differ")
    del again, p_lo, p_hi, p_val

    def bwd():
        return ps.splat_max_bwd(*mapping, values, grid, g, sizes)
    bwd_row = dict(
        shape=shape, calls=calls, max_abs_err=err, plan=plan,
        grid_rows_read=touched, grid_rows=r * cells,
        won=int((winner != ps.NO_WINNER).sum()),
        ms=cuda_ms(bwd), device_ms=graph_ms(bwd), host_ms=host_ms(bwd),
        plain_ms=cuda_ms(lambda: ps.splat_max_bwd_plain(
            *mapping, values, grid, g, sizes), iters=3, warmup=1),
        library_ms=None,
        # reads the mapping, the values and the touched rows of the grid
        # and of the cotangent; writes d_values and the two d_w
        bound=bound(map_bytes + r * k * f * 4 + 2 * touched * f * 4
                    + r * k * f * 4 + r * k * 32,
                    r * k * n_vert * f * 5))
    routed = ps.splat_route(*mapping, values, winner, g, sizes)
    if not all(torch.equal(a, b) for a, b in zip(routed, (d_lo, d_hi, d_val))):
        raise AssertionError(f"splat_route {shape}: not bit-equal to the "
                             "two-pass splat_max_bwd")
    plain = ps.splat_route_plain(*mapping, values, winner, g, sizes)
    err = max(held(f"splat_route {shape} {n}", a, b, ROUTE_TOL)
              for n, a, b in zip(("d_w_lo", "d_w_hi", "d_values"), routed,
                                 plain))
    del routed, plain, d_lo, d_hi, d_val

    def route():
        return ps.splat_route(*mapping, values, winner, g, sizes)
    route_row = dict(
        shape=shape, calls=calls, max_abs_err=err, plan=plan,
        grid_rows_read=touched, grid_rows=r * cells,
        ms=cuda_ms(route), device_ms=graph_ms(route), host_ms=host_ms(route),
        plain_ms=cuda_ms(lambda: ps.splat_route_plain(
            *mapping, values, winner, g, sizes), iters=3, warmup=1),
        library_ms=None,
        # reads the mapping, the values and the touched rows of the winner
        # map and of the cotangent; writes d_values and the two d_w
        bound=bound(map_bytes + r * k * f * 4 + 2 * touched * f * 4
                    + r * k * f * 4 + r * k * 32,
                    r * k * n_vert * f * 4))
    return bwd_row, route_row, winner


def check_point_backwards(ps, rows, gen, mapping, values, grid, sizes, f,
                          n_splat, n_slice, touched):
    """The splat and slice backward kernels at one main-path shape.  The
    splat's ``grid`` is the forward's own output, so winners exist."""
    bwd_row, route_row, winner = check_splat_backward(
        ps, gen, mapping, values, grid, sizes, f, n_splat, touched)
    rows["splat_max_bwd"].append(bwd_row)
    rows["splat_route"].append(route_row)

    # set A: the splat that records the winner map in the forward, then the
    # routing pass alone, bit-equal to the two-pass backward
    rows["splat_max_winner"].append(check_winner_splat(
        ps, mapping, values, grid, winner, sizes, f, n_splat))
    del winner

    rows["slice_bwd"].append(check_slice_bwd(ps, gen, mapping, grid, sizes,
                                             f, n_slice, touched))


def check_slice_bwd(ps, gen, mapping, grid, sizes, f, calls, touched):
    """``slice_bwd`` at one shape, on a grid of the forward's kind: its
    outputs bit-equal over two runs (d_grid is summed in fixed point) and
    within TOL of the plain version; timed by the loop, by graph replay and
    on the host, beside ``scatter_add_`` (the d_grid half: one call on
    products expanded outside the timing, held to the plain version).  ->
    its entry."""
    r, k = mapping[0].shape
    shape = shape_name(sizes, f, r, k)
    cells = ps.kernel_grid_dims(sizes)[2]
    g_pts = torch.randn(r, k, f, generator=gen, device="cuda")
    d_grid, d_lo, d_hi = ps.slice_bwd(*mapping, g_pts, grid, sizes)
    if not all(torch.equal(a, b) for a, b in zip(
            ps.slice_bwd(*mapping, g_pts, grid, sizes),
            (d_grid, d_lo, d_hi))):
        raise AssertionError(f"slice_bwd {shape}: two runs differ")
    p_grid, p_lo, p_hi = ps.slice_bwd_plain(*mapping, g_pts, grid, sizes)
    err = max(held(f"slice_bwd {shape} {n}", a, b, TOL)
              for n, a, b in (("d_grid", d_grid, p_grid),
                              ("d_w_lo", d_lo, p_lo), ("d_w_hi", d_hi, p_hi)))
    if len(sizes) == 2 and (d_lo[..., 2:].any() or d_hi[..., 2:].any()):
        raise AssertionError(f"slice_bwd {shape}: 2D slots 2, 3 not zero")
    del d_grid, d_lo, d_hi, p_lo, p_hi
    idx, w = ps.vertex_index_weights(*mapping, sizes)
    index = idx.reshape(r, k * 8, 1).expand(r, k * 8, f).contiguous()
    src = (w[..., None] * g_pts[:, :, None, :]).reshape(r, k * 8, f)
    del idx, w

    def library():
        return torch.zeros(r, cells, f, device="cuda").scatter_add_(
            1, index, src)
    lib_err = held(f"scatter_add_ {shape}", library(), p_grid, LIB_TOL)
    del p_grid

    def slice_bwd():
        return ps.slice_bwd(*mapping, g_pts, grid, sizes)
    row = dict(
        shape=shape, calls=calls, max_abs_err=err, library_err=lib_err,
        grid_rows_read=touched, grid_rows=r * cells,
        plan=ps.slice_bwd_plan(r, k, f, sizes)._asdict(),
        ms=cuda_ms(slice_bwd), device_ms=graph_ms(slice_bwd),
        host_ms=host_ms(slice_bwd),
        plain_ms=cuda_ms(lambda: ps.slice_bwd_plain(
            *mapping, g_pts, grid, sizes), iters=3, warmup=1),
        library_ms=cuda_ms(library), library_device_ms=graph_ms(library),
        # reads the mapping, the point cotangents and the touched grid
        # rows; writes the whole d_grid (zeros included) and the two d_w
        bound=bound(r * k * 40 + r * k * f * 4 + touched * f * 4
                    + r * cells * f * 4 + r * k * 32,
                    r * k * 2 ** len(sizes) * f * 4))
    del index, src
    return row


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
        splat_row, grid = check_splat(ps, mapping, values, sizes, f, n_splat)
        rows["splat_max"].append(splat_row)
        # slice reads a grid of the forward's kind: splat output
        out = ps.slice_gather(*mapping, grid, sizes)
        plain = ps.slice_plain(*mapping, grid, sizes)
        err = held(f"slice {sizes} F={f}", out, plain, TOL)
        # the library yardstick: one grid_sample call, layouts made outside
        # the timing; it must compute the same function
        inp, pts = grid_sample_inputs(grid, keys, sizes)
        lib = grid_sample_slice(inp, pts).reshape(R, f, K).transpose(1, 2)
        lib_err = held(f"grid_sample {sizes} F={f}", lib, plain, LIB_TOL)
        touched = touched_rows(ps, mapping, sizes)
        rows["slice_gather"].append(dict(
            shape=shape_name(sizes, f), calls=n_slice,
            max_abs_err=err, library_err=lib_err,
            grid_rows_read=touched, grid_rows=R * cells,
            plan=ps.slice_plan(R, K, f, sizes)._asdict(),
            ms=cuda_ms(lambda: ps.slice_gather(*mapping, grid, sizes)),
            device_ms=graph_ms(
                lambda: ps.slice_gather(*mapping, grid, sizes)),
            host_ms=host_ms(lambda: ps.slice_gather(*mapping, grid, sizes)),
            plain_ms=cuda_ms(lambda: ps.slice_plain(*mapping, grid, sizes),
                             iters=5),
            library_ms=cuda_ms(lambda: grid_sample_slice(inp, pts)),
            library_device_ms=graph_ms(lambda: grid_sample_slice(inp, pts)),
            library_host_ms=host_ms(lambda: grid_sample_slice(inp, pts)),
            bound=bound(map_bytes + touched * f * 4 + R * K * f * 4,
                        R * K * n_vert * f * 2)))
        del plain, out, inp, pts, lib
        # the backward kernels run 4 times per shape in a step (the pools'
        # fifth splat has no slice)
        check_point_backwards(ps, rows, gen, mapping, values, grid, sizes,
                              f, n_splat, n_slice, touched)
        del grid
    for sizes, f, n_conv, n_set_a in CONV_SHAPES:
        check_conv(gc, rows, gen, sizes, f, n_conv, n_set_a)
    for sizes, f, n_set_a in CONV2D_SHAPES:
        check_conv(gc, rows, gen, sizes, f, n_set_a, n_set_a)
    for sizes, f, n_set_b in BLOCK_SHAPES:
        rows["fused_block"].append(check_fused_block(gen, sizes, f, n_set_b))
    return rows


def check_conv(gc, rows, gen, sizes, f, calls, calls_set_a):
    """The grid conv and its weight gradient of the grid's dimension at one
    shape; ``calls`` per forward (per step for the weight gradient) on the
    kernel's main path, ``calls_set_a`` under set A."""
    dim = len(sizes)
    fwd, dw = ("grid_conv2d", "grid_conv2d_dw") if dim == 2 else (
        "grid_conv3d", "grid_conv3d_dw")
    conv = torch.nn.functional.conv2d if dim == 2 else \
        torch.nn.functional.conv3d
    shape = shape_name(sizes, f)
    cells = int(np.prod(sizes))
    grid = torch.randn(R, cells, f, generator=gen, device="cuda").relu()
    weight = torch.randn((H * f, f) + (3,) * dim, generator=gen,
                         device="cuda") * (3 ** dim * f) ** -0.5
    bias = torch.randn(H * f, generator=gen, device="cuda") * 0.1
    out = getattr(gc, fwd)(grid, weight, bias, sizes, H)
    plain = gc.grid_conv_plain(grid, weight, bias, sizes, H)
    err = held(f"{fwd} {shape}", out, plain, TOL)
    x_cf = grid.reshape((B, H) + sizes + (f,)).movedim(-1, 2).reshape(
        (B, H * f) + sizes).contiguous()
    lib_out = conv(x_cf, weight, bias, padding=1, groups=H)
    lib_err = held(f"conv{dim}d {shape}", lib_out.reshape(
        (B, H, f) + sizes).movedim(2, -1).reshape(R, cells, f), plain,
        LIB_TOL)
    # (output cell, tap) pairs whose input lies inside the grid: the taps
    # over the zero padding need no work
    pairs = int(np.prod([3 * s - 2 for s in sizes]))
    rows[fwd].append(dict(
        shape=shape, calls=calls, calls_set_a=calls_set_a, max_abs_err=err,
        library_err=lib_err,
        ms=cuda_ms(lambda: getattr(gc, fwd)(grid, weight, bias, sizes, H)),
        plain_ms=cuda_ms(lambda: gc.grid_conv_plain(
            grid, weight, bias, sizes, H), iters=5),
        library_ms=cuda_ms(lambda: conv(x_cf, weight, bias, padding=1,
                                        groups=H)),
        bound=bound(2 * R * cells * f * 4 + weight.numel() * 4
                    + bias.numel() * 4,
                    R * (pairs * f * f * 2 + cells * f))))
    del out, plain, lib_out
    # the weight gradient for a cotangent of the output's shape
    g = torch.randn(R, cells, f, generator=gen, device="cuda")
    d_w = getattr(gc, dw)(grid, g, sizes, H)
    plain = gc.grid_conv_dw_plain(grid, g, sizes, H)
    err = held(f"{dw} {shape}", d_w, plain, TOL)
    if not torch.equal(d_w, getattr(gc, dw)(grid, g, sizes, H)):
        raise AssertionError(f"{dw} {shape}: two runs differ")
    g_cf = g.reshape((B, H) + sizes + (f,)).movedim(-1, 2).reshape(
        (B, H * f) + sizes).contiguous()

    def library():
        return torch.ops.aten.convolution_backward(
            g_cf, x_cf, weight, None, [1] * dim, [1] * dim, [1] * dim,
            False, [0] * dim, H, (False, True, False))[1]
    lib_err = held(f"convolution_backward {shape}", library(), plain,
                   LIB_TOL)
    rows[dw].append(dict(
        shape=shape, calls=calls, calls_set_a=calls_set_a, max_abs_err=err,
        library_err=lib_err,
        ms=cuda_ms(lambda: getattr(gc, dw)(grid, g, sizes, H)),
        plain_ms=cuda_ms(lambda: gc.grid_conv_dw_plain(grid, g, sizes, H),
                         iters=5),
        library_ms=cuda_ms(library),
        bound=bound(2 * R * cells * f * 4 + weight.numel() * 4,
                    R * pairs * f * f * 2)))


def check_fused_block(gen, sizes, f, calls, b=B, k=K):
    """Set B's fused block at one head group's shape, ``b`` clouds of ``k``
    points, with and without gk2: gk bit-equal to the plain composition's,
    the points and gk2 within TOL, two runs bit-equal.  Timed beside the
    three separate kernels on the same inputs (by the loop and by graph
    replay); no single PyTorch call computes the block.  -> its entry."""
    from cloud_transformers_tpu_torch.ops import pallas_fused_block as fb
    from cloud_transformers_tpu_torch.ops import pallas_grid_conv as gc
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    dim = len(sizes)
    r = b * H
    shape = shape_name(sizes, f, r, k)
    cells = int(np.prod(sizes))
    mapping, values, _ = mapping_inputs(sizes, f, gen, b, k)
    weight = torch.randn((H * f, f) + (3,) * dim, generator=gen,
                         device="cuda") * (3 ** dim * f) ** -0.5
    bias = torch.randn(H * f, generator=gen, device="cuda") * 0.1
    args = (*mapping, values, weight, bias, sizes, H)
    plain = fb.fused_block_plain(*args, want_gk2=True)
    err = 0.0
    for want in (False, True):
        got = fb.fused_block(*args, want_gk2=want)
        if not torch.equal(got[1], plain[1]):
            raise AssertionError(f"fused_block {shape}: gk differs from the "
                                 "plain splat's")
        err = max(err, held(f"fused_block {shape} pts", got[0], plain[0],
                            TOL))
        if want:
            err = max(err, held(f"fused_block {shape} gk2", got[2],
                                plain[2], TOL))
        if not all(torch.equal(x, y) for x, y in zip(
                got, fb.fused_block(*args, want_gk2=want))):
            raise AssertionError(f"fused_block {shape}: two runs differ")
    del got, plain
    conv = gc.grid_conv2d if dim == 2 else gc.grid_conv3d

    def separate():
        gk = ps.splat_max(*mapping, values, sizes)
        return ps.slice_gather(*mapping, conv(gk, weight, bias, sizes, H),
                               sizes)

    def fused():
        return fb.fused_block(*args)
    n_vert = 2 ** dim
    pairs = int(np.prod([3 * s - 2 for s in sizes]))
    return dict(
        shape=shape, calls=calls, max_abs_err=err,
        plan=fb.fused_block_plan(r, k, f, sizes)._asdict(),
        ms=cuda_ms(fused), device_ms=graph_ms(fused), host_ms=host_ms(fused),
        ms_with_gk2=cuda_ms(lambda: fb.fused_block(*args, want_gk2=True)),
        separate_kernels_ms=cuda_ms(separate),
        separate_kernels_device_ms=graph_ms(separate),
        plain_ms=cuda_ms(lambda: fb.fused_block_plain(*args), iters=3,
                         warmup=1),
        library_ms=None,
        # reads the mapping, the values and the weights; writes the points
        # and gk (serving: no gk2)
        bound=bound(r * k * 40 + 2 * r * k * f * 4 + weight.numel() * 4
                    + bias.numel() * 4 + r * cells * f * 4,
                    r * k * n_vert * f * 4
                    + r * (pairs * f * f * 2 + cells * f)))


def check_completion_rows(gen):
    """The fused block, the splat, the splat backward, the winner-tracking
    splat, the routing pass and the slice backward at the completion
    decoder's rows (B = 2 clouds x 16 heads, K = 16384 points) at each head
    group's shape, with the gates of the classifier's shapes.  ->
    {kernel: [entry per shape]}, ``calls`` per completion step (the
    decoder's part)."""
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    b, k = COMPLETION_ROWS
    out = {"fused_block": [], "splat_max": [], "splat_max_bwd": [],
           "splat_max_winner": [], "splat_route": [], "slice_bwd": []}
    for sizes, f, calls in BLOCK_SHAPES:
        out["fused_block"].append(check_fused_block(gen, sizes, f, calls,
                                                    b, k))
        mapping, values, _ = mapping_inputs(sizes, f, gen, b, k)
        splat_row, grid = check_splat(ps, mapping, values, sizes, f, calls)
        out["splat_max"].append(splat_row)
        touched = touched_rows(ps, mapping, sizes)
        bwd_row, route_row, winner = check_splat_backward(
            ps, gen, mapping, values, grid, sizes, f, calls, touched)
        out["splat_max_bwd"].append(bwd_row)
        out["splat_route"].append(route_row)
        out["splat_max_winner"].append(check_winner_splat(
            ps, mapping, values, grid, winner, sizes, f, calls))
        out["slice_bwd"].append(check_slice_bwd(
            ps, gen, mapping, grid, sizes, f, calls, touched))
        del mapping, values, grid, winner
        torch.cuda.empty_cache()
    return out


def bound_top2(pairs, n_bytes):
    """The bid search's least time: ``pairs`` values of 12 float32
    operations and one square root each, the square roots at the
    special-function rate, against ``n_bytes`` moved."""
    t_ops = max(pairs * 12 / F32_FLOP_PER_S, pairs / SFU_OP_PER_S) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def equal_top2(what, got, plain):
    """Values and indices bit for bit; raises otherwise.  -> 0.0, the
    max abs error."""
    for n, a, b in zip(("best", "better", "best_i"), got, plain):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{what} {n}: {int((a != b).sum())} elements differ from "
                f"the plain version (max abs err "
                f"{float((a.double() - b.double()).abs().max())})")
    return 0.0


def mid_auction_state(x1, x2, eps, until):
    """The staged auction of ``losses/emd.py`` run until at most ``until``
    points of a row are unassigned.  -> (state, rounds)."""
    from cloud_transformers_tpu_torch.losses import emd
    b, n, _ = x1.shape
    state = emd._init_state(b, n, n, x1.device)
    rounds = 0
    caps = [None] + [c for c in (n // 8, n // 16, n // 32, n // 64)
                     if c >= 256]
    for cap, nxt in zip(caps, caps[1:] + [0]):
        while emd._max_unassigned(state[0]) > max(until, nxt):
            idx = (None if cap is None
                   else emd._compact_unassigned(state[0][:, :n], cap))
            state = emd._auction_round(x1, x2, eps, 2048, state, last=False,
                                       idx=idx)
            rounds += 1
    return state, rounds


def check_emd_kernels(gen):
    """Phase 3, the auction's two kernels: compare, time and bound."""
    from cloud_transformers_tpu_torch.losses import emd
    from cloud_transformers_tpu_torch.ops import pallas_emd as pe
    rows = {"top2": [], "auction_window": []}
    for b, w, m in TOP2_SHAPES:
        x1 = torch.rand(b, w, 3, generator=gen, device="cuda") * 2 - 1
        x2 = torch.rand(b, m, 3, generator=gen, device="cuda") * 2 - 1
        price = torch.rand(b, m, generator=gen, device="cuda") * 0.1
        got = pe.top2(x1, x2, price)
        plain = pe.top2_plain(x1, x2, price)
        err = equal_top2(f"top2 {(b, w, m)}", got, plain)
        for skip in (True, False):
            equal_top2(f"top2 {(b, w, m)} skip={skip}",
                       pe._launch_top2(x1, x2, price, skip), plain)
        if not bool(((got[2] >= 0) & (got[2] < m)).all()):
            raise AssertionError(f"top2 {(b, w, m)}: index out of range")

        def library():
            # two library calls and an elementwise pass, not one call
            value = 3.0 - torch.cdist(x1, x2) - price[:, None, :]
            return value.topk(2, dim=-1)
        lib = library()
        lib_err = max(held(f"cdist+topk {(b, w, m)} best",
                           lib.values[..., 0], plain[0], LIB_TOL),
                      held(f"cdist+topk {(b, w, m)} better",
                           lib.values[..., 1], plain[1], LIB_TOL))
        del lib
        rows["top2"].append(dict(
            shape=f"B={b} W={w} M={m}", b=b, w=w, calls=0.0,
            max_abs_err=err, library_err=lib_err,
            plan=pe.top2_plan(b, w, m)._asdict(),
            ms=cuda_ms(lambda: pe.top2(x1, x2, price)),
            device_ms=graph_ms(lambda: pe.top2(x1, x2, price)),
            host_ms=host_ms(lambda: pe.top2(x1, x2, price)),
            plain_ms=cuda_ms(lambda: pe.top2_plain(x1, x2, price), iters=3,
                             warmup=1),
            library_ms=cuda_ms(library, iters=3, warmup=1),
            bound=bound_top2(b * w * m,
                             (b * w * 3 + b * m * 4 + b * w * 3) * 4)))
        log(f"top2 B={b} W={w} M={m}: {rows['top2'][-1]['ms']:.4f} ms "
            f"({rows['top2'][-1]['device_ms']:.4f} on the device), "
            f"plain {rows['top2'][-1]['plain_ms']:.3f} ms, bit-equal")
        del x1, x2, price, got, plain

    # exact duplicates: the second-best equals the best, the first
    # occurrence wins; and a single target: no second-best
    x1 = torch.rand(2, 1024, 3, generator=gen, device="cuda")
    half = torch.rand(2, 3000, 3, generator=gen, device="cuda")
    x2 = torch.cat([half, half], 1)
    price = torch.zeros(2, 6000, device="cuda")
    got, plain = pe.top2(x1, x2, price), pe.top2_plain(x1, x2, price)
    equal_top2("top2 duplicated targets", got, plain)
    if not (bool((got[2] < 3000).all()) and torch.equal(got[0], got[1])):
        raise AssertionError("top2 duplicated targets: not the first "
                             "occurrence, or the second-best is not the best")
    one = pe.top2(x1, x2[:, :1].contiguous(), price[:, :1].contiguous())
    equal_top2("top2 one target", one, pe.top2_plain(
        x1, x2[:, :1].contiguous(), price[:, :1].contiguous()))
    if not (bool((one[1] == -1e9).all()) and bool((one[2] == 0).all())):
        raise AssertionError("top2 with one target: second-best is not -1e9")
    log("top2: duplicated targets and the single target hold")

    # the window from a mid-auction state
    b, w, m = WINDOW_SHAPE
    eps = 0.004
    x1 = torch.rand(b, m, 3, generator=gen, device="cuda") * 2 - 1
    x2 = torch.rand(b, m, 3, generator=gen, device="cuda") * 2 - 1
    state, rounds = mid_auction_state(x1, x2, eps, 2 * w)
    # the bid search on the same state: every point bids at the prices the
    # auction has reached (what the skip meets in the auction's rounds)
    first = rows["top2"][0]
    if (first["b"], first["w"]) != (b, m):
        raise AssertionError("the first top2 shape is not B=2, W=M=16384")
    equal_top2("top2 mid-auction", pe.top2(x1, x2, state[2]),
               pe.top2_plain(x1, x2, state[2]))
    first["auction_state_device_ms"] = graph_ms(
        lambda: pe.top2(x1, x2, state[2]))
    first["auction_state_device_ms_no_skip"] = graph_ms(
        lambda: pe._launch_top2(x1, x2, state[2], False))
    log(f"top2 on a mid-auction state: "
        f"{first['auction_state_device_ms']:.4f} ms on the device, "
        f"{first['auction_state_device_ms_no_skip']:.4f} without the skip")
    idx = emd._compact_unassigned(state[0][:, :m], w)
    x1w = torch.gather(x1, 1, idx.clamp(max=m - 1)[..., None]
                       .expand(-1, -1, 3)).contiguous()
    j_real = idx.to(torch.int32).contiguous()
    owner = state[1].to(torch.int32)
    args = (x1w, j_real, x2, state[2], owner, 3000, eps, m)
    price_k, owner_k, used_k = pe.auction_window(*args, rounds_cap=64)
    price_p, owner_p, used_p, bids = pe.auction_window_plain(
        *args, rounds_cap=64, return_bids=True)
    if not (torch.equal(owner_k, owner_p) and torch.equal(used_k, used_p)):
        raise AssertionError(
            f"auction_window: owner map or rounds used differ from the "
            f"plain version ({int((owner_k != owner_p).sum())} owners, "
            f"used {used_k.tolist()} vs {used_p.tolist()})")
    err = held("auction_window price", price_k, price_p, EMD_TOL)
    again = pe.auction_window(*args, rounds_cap=64)
    if not all(torch.equal(a, c) for a, c in zip(
            (price_k, owner_k, used_k), again)):
        raise AssertionError("auction_window: two calls differ")
    n_rounds = int(used_k.max())
    # the bids the data needed, each over M targets, and per round the
    # W * W comparisons of the resolve pass
    t_bound = bound_top2(bids * m, b * (w * 16 + m * 28))[0] \
        + int(used_k.sum()) * w * w / F32_FLOP_PER_S * 1e3
    rows["auction_window"].append(dict(
        shape=f"B={b} W={w} M={m}", calls=0.0, max_abs_err=err,
        rounds_before=rounds, used=used_k.tolist(), bids=bids,
        unassigned_before=int((state[0][:, :m] < 0).sum(1).max()),
        ms=cuda_ms(lambda: pe.auction_window(*args, rounds_cap=64),
                   iters=5, warmup=1),
        plain_ms=cuda_ms(lambda: pe.auction_window_plain(
            *args, rounds_cap=64), iters=2, warmup=0),
        library_ms=None, bound=(t_bound, "operations")))
    r = rows["auction_window"][-1]
    log(f"auction_window {r['shape']}: used {r['used']} rounds, {bids} bids, "
        f"{r['ms']:.3f} ms ({r['ms'] / max(n_rounds, 1):.3f} ms a round), "
        f"plain {r['plain_ms']:.1f} ms")
    return rows


def per_shape(name, s, per):
    """One shape's entry of the kernels line."""
    return {
        "shape": s["shape"], per: s["calls"],
        "ms": s["ms"], "plain_ms": s["plain_ms"],
        "bound_ms": s["bound"][0], "bound_by": s["bound"][1],
        "library_ms": s["library_ms"],
        "max_abs_err": s["max_abs_err"],
        **({"bound_share": s["bound"][0] / s["ms"]}
           if name in BOUND_SHARE else {}),
        **({"faster_than_library": s["ms"] < s["library_ms"]}
           if name in BOUND_SHARE and s["library_ms"] is not None else {}),
        **({"device_ms": s["device_ms"],
            "device_bound_share": s["bound"][0] / s["device_ms"]}
           if name in DEVICE_TIMED else {}),
        **({"library_device_ms": s["library_device_ms"],
            "faster_than_library_device":
                s["device_ms"] < s["library_device_ms"]}
           if "library_device_ms" in s else {}),
        **({"faster_than_separate_kernels":
                s["ms"] < s["separate_kernels_ms"],
            "faster_than_separate_kernels_device":
                s["device_ms"] < s["separate_kernels_device_ms"]}
           if "separate_kernels_ms" in s else {}),
        **{k: s[k] for k in (
            "library_err", "grid_rows_read", "grid_rows", "won",
            "plan", "host_ms", "library_host_ms",
            "calls_per_evaluated_cloud",
            "auction_state_device_ms",
            "auction_state_device_ms_no_skip",
            "used", "bids",
            "rounds_before", "unassigned_before", "calls_set_a",
            "ms_with_gk2", "separate_kernels_ms",
            "separate_kernels_device_ms") if k in s}}


def kernel_line(rows, launches, completion_rows):
    """Per kernel: times summed over the calls of one pass of its path
    (each shape times its calls): one forward for the three kernels of the
    serving path, one training step of the classifier for the three
    backward kernels, one training step of the completion model for
    ``top2``, the one checked call for ``auction_window``.  ``launches``
    is {path: {kernel: count}}: a kernel's ``launches`` is the count of its
    path's run (``MAIN_PATH``), and every path's count stands beside it."""
    times_are = {"serving": "per_forward", "training": "per_step",
                 "completion": "per_completion_step",
                 "window": "per_call_from_the_checked_state",
                 "serving_set_a": "per_forward_set_a",
                 "training_set_a": "per_step_set_a",
                 "serving_set_b": "per_forward_set_b"}
    out = []
    for name, shapes in rows.items():
        per = times_are[MAIN_PATH[name]]

        def total(key):
            return sum(s[key] * s["calls"] for s in shapes)
        t_bound = sum(s["bound"][0] * s["calls"] for s in shapes)
        by = max(shapes, key=lambda s: s["bound"][0] * s["calls"])
        lib = (None if any(s["library_ms"] is None for s in shapes)
               else total("library_ms"))
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[MAIN_PATH[name]][name],
            **{f"launches_{path}": counts.get(name, 0)
               for path, counts in launches.items()},
            "times_are": per,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": t_bound, "bound_by": by["bound"][1],
            "library_ms": lib,
            **({"library_is": LIBRARY_IS[name]} if name in LIBRARY_IS
               else {}),
            **({"separate_kernels_ms": total("separate_kernels_ms"),
                "separate_kernels_device_ms":
                    total("separate_kernels_device_ms")}
               if name == "fused_block" else {}),
            **({"ms_per_evaluated_cloud": sum(
                    sh["ms"] * sh["calls_per_evaluated_cloud"]
                    for sh in shapes),
                "device_ms_per_evaluated_cloud": sum(
                    sh["device_ms"] * sh["calls_per_evaluated_cloud"]
                    for sh in shapes)}
               if name == "top2" else {}),
            **({"bound_share": t_bound / total("ms")}
               if name in BOUND_SHARE else {}),
            **({"device_ms": total("device_ms"),
                "device_bound_share": t_bound / total("device_ms")}
               if name in DEVICE_TIMED else {}),
            **({"library_device_ms": total("library_device_ms")}
               if "library_device_ms" in shapes[0] else {}),
            "per_shape": [per_shape(name, s, per) for s in shapes],
            **({"per_completion_decoder_step": {
                "ms": sum(c["ms"] * c["calls"] for c in done),
                "device_ms": sum(c["device_ms"] * c["calls"] for c in done),
                "bound_ms": sum(c["bound"][0] * c["calls"] for c in done),
                **({"separate_kernels_ms": sum(
                    c["separate_kernels_ms"] * c["calls"] for c in done)}
                   if name == "fused_block" else {}),
                "per_shape": [per_shape(name, c, "per_completion_step")
                              for c in done]}}
               if (done := completion_rows.get(name)) else {}),
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
    ("top2_kernel", "top2"), ("auction_window_kernel", "auction_window"),
    # the 2D kernels ahead of the 3D patterns
    ("conv2d_dw_kernel", "grid_conv2d_dw"),
    ("conv2d_dw_sum_kernel", "grid_conv2d_dw"),
    ("conv2d_fwd_kernel", "grid_conv2d"),
    ("grid_conv3d_dw", "grid_conv3d_dw"),
    # the forward and its weight packing pass
    ("grid_conv3d_", "grid_conv3d"),
    ("fused_block", "fused_block"), ("fused_cluster", "fused_block"),
    # the winner-tracking splat's two launches: splat_max's kernel and
    # splat_max_bwd's winner pass, tagged use::splat_max_winner
    ("splat_max_winner", "splat_max_winner"),
    ("splat_winner", "splat_max_bwd"),
    # the routing pass: splat_max_bwd's second pass, or splat_route alone
    ("splat_route", "splat routing pass (splat_max_bwd, splat_route)"),
    ("splat_slab", "splat_max"), ("slice_bwd", "slice_bwd"),
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


@contextlib.contextmanager
def switches(name):
    """The port's execution switches set as ``name`` ("set_a", "set_b")
    says, and back to the defaults afterwards."""
    from cloud_transformers_tpu_torch.core import splat_slice as ss
    from cloud_transformers_tpu_torch.nn import grouped_conv as gcm
    try:
        if name == "set_a":
            gcm.set_grid_conv_strategy("pallas")
            ss.FWD_WINNER = True
        elif name == "set_b":
            gcm.set_block_fusion("fused")
        else:
            raise ValueError(name)
        yield
    finally:
        gcm.set_grid_conv_strategy(None)
        gcm.set_block_fusion(None)
        ss.FWD_WINNER = False


def set_counts(name, n_splat, n_slice, training):
    """Launches per forward (or per training step) under a set, from the
    default path's splat and slice counts of a model whose head groups are
    half 2D and half 3D (the pools' splats have no slice): each slice is
    one head group.  The classifier (26 splats, 24 slices): set A 26 splat,
    24 slice, 12 + 12 conv per forward; per step 26 winner splats and
    routing passes, 24 slice and slice backward, 24 + 24 conv, 12 + 12
    weight gradients.  Set B 24 fused and 2 splat per forward; per step 24
    fused, 2 splat, 26 splat backward, 24 slice backward, 12 of each conv
    and each weight gradient."""
    groups = n_slice // 2   # of each dimension
    if name == "set_a":
        if not training:
            return {"splat_max": n_splat, "slice_gather": n_slice,
                    "grid_conv3d": groups, "grid_conv2d": groups}
        return {"splat_max_winner": n_splat, "splat_route": n_splat,
                "slice_gather": n_slice, "slice_bwd": n_slice,
                "grid_conv3d": 2 * groups, "grid_conv3d_dw": groups,
                "grid_conv2d": 2 * groups, "grid_conv2d_dw": groups}
    if not training:
        return {"fused_block": n_slice, "splat_max": n_splat - n_slice}
    return {"fused_block": n_slice, "splat_max": n_splat - n_slice,
            "splat_max_bwd": n_splat, "slice_bwd": n_slice,
            "grid_conv3d": groups, "grid_conv3d_dw": groups,
            "grid_conv2d": groups, "grid_conv2d_dw": groups}


def profile_serving(engine, batches, smi, path):
    """``PROFILE_CALLS`` more classify calls under torch.profiler: the
    device kernels by group in ``path``.  -> {profiled_...} with the device
    busy time and host wall time of the same window; the profiler's own
    host cost makes this idle share an upper bound."""
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
    table = events.table(sort_by="cuda_time_total", row_limit=40)
    with open(path, "w") as fh:
        fh.write(f"{smi}\n{json.dumps(profiled)}\n"
                 f"device kernels, per forward:\n"
                 f"{device_table(events, PROFILE_CALLS)}\n"
                 f"(totals over {PROFILE_CALLS} classify calls)\n{table}")
    log(json.dumps(profiled))
    return profiled


def switched_serving(name, engine, cpu_engine, batches, wrappers, smi,
                     profile_dir):
    """The serving path under a set: the timed, counted classify calls, one
    forward under ``set_sync_debug_mode("error")``, and the card's logits
    and mask against the CPU's for one cloud; with ``profile_dir``, the
    profile of ``PROFILE_CALLS`` more calls.  -> (result, launches)."""
    engine.classify(batches[0])                  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    zero_launches(wrappers)
    call_ms = []
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, set_counts(
        name, PER_FORWARD["splat_max"], PER_FORWARD["slice_gather"], False),
        len(batches), f"{name} forwards")
    if probs.shape != (B, 15) or not np.isfinite(probs).all():
        raise AssertionError(f"{name}: bad class probabilities {probs}")
    pcd = torch.from_numpy(engine.pad_batch(batches[0])[0]).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            engine.model(pcd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cloud = batches[0][:1]
    (card_cls, card_mask, _), _, _, _ = engine.predict_padded(cloud)
    (cpu_cls, cpu_mask, _), _, _, _ = cpu_engine.predict_padded(cloud)
    parity(card_cls[:1].cpu(), cpu_cls, f"{name} class logits")
    parity(card_mask[:1].cpu(), cpu_mask, f"{name} point mask")
    ms = float(np.median(call_ms))
    log(f"{name}: {ms:.3f} ms/forward (median), launches {launches}")
    result = {"classify_ms_per_forward": ms, "clouds_per_s": B * 1e3 / ms,
              "classify_ms_p10": float(np.percentile(call_ms, 10)),
              "classify_ms_p90": float(np.percentile(call_ms, 90))}
    if profile_dir:
        result.update(profile_serving(engine, batches, smi, os.path.join(
            profile_dir, f"profile_forward_{name}.txt")))
    return result, launches


def endless(loader):
    """Batches of ``loader``, epoch after epoch."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def train_phase(wrappers, smi, profile_dir, exp_root, steps=TRAIN_STEPS,
                per_step=PER_STEP, profile_name="profile_train.txt"):
    """Phase 6: optimizer steps on the full-width classifier through the
    Trainer, whose experiment directories go under ``exp_root``, with
    ``per_step`` launches of each kernel in each of the ``steps`` timed
    steps (none of the others).  -> (result dict, launches in the timed
    steps)."""
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
    zero_launches(wrappers)
    step_ms, losses = [], []
    for _ in range(steps):
        batch = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = read_launches(wrappers)
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches, per_step, steps, "training steps")
    log(f"launches in {steps} training steps: {launches}")

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
    if trainer.global_step != steps + 1 or \
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
              "train_steps": steps,
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
        with open(os.path.join(profile_dir, profile_name), "w") as fh:
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


class EmdRecorder:
    """Stands in for ``losses.emd.emd_auction_with_rounds`` and
    ``_top2_dispatch`` while a phase runs: it passes every call through and
    keeps the rounds each auction used, the CUDA events around it, its
    last assignment, and the bid searches by (batch, width)."""

    def __init__(self):
        from cloud_transformers_tpu_torch.losses import emd
        self.emd = emd
        self.auction, self.dispatch = (emd.emd_auction_with_rounds,
                                       emd._top2_dispatch)
        self.rounds, self.events, self.widths = [], [], {}
        self.assignment = None

    def __enter__(self):
        def auction(xyz1, xyz2, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist, assignment, rounds = self.auction(xyz1, xyz2, *args,
                                                    **kwargs)
            end.record()
            self.rounds.append(rounds)
            self.events.append((start, end))
            self.assignment = assignment
            return dist, assignment, rounds

        def dispatch(x1w, x2, price, chunk_size):
            key = (x1w.shape[0], x1w.shape[1])
            self.widths[key] = self.widths.get(key, 0) + 1
            return self.dispatch(x1w, x2, price, chunk_size)

        self.emd.emd_auction_with_rounds = auction
        self.emd._top2_dispatch = dispatch
        return self

    def __exit__(self, *exc):
        self.emd.emd_auction_with_rounds = self.auction
        self.emd._top2_dispatch = self.dispatch

    def ms(self):
        """Device time between each auction's first and last kernel."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def read_launches(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def check_launches(launches, per_pass, passes, what):
    """Raise unless every kernel launched ``per_pass[name]`` (0 where it is
    not named) times in each of ``passes`` passes."""
    expect = {name: per_pass.get(name, 0) * passes for name in launches}
    if launches != expect:
        raise AssertionError(f"{what}: launches {launches} in {passes} "
                             f"passes, expected {expect}")


def zero_launches(wrappers):
    for w in wrappers.values():
        w.launches = 0


def completion_phase(wrappers, smi, profile_dir, exp_root):
    """The third path: the full-width completion model trained for 1 +
    COMPLETION_STEPS steps through the Trainer on synthetic ShapeNet pairs,
    a checkpoint round trip, and the evaluation protocol on EVAL_CLOUDS
    test clouds.  -> (result dict, launches in the timed steps, launches in
    the evaluation, bid searches per step and per evaluated cloud by
    (batch, width), launches of the one step under each set).  An auction
    makes the host wait once per round (its exit test) and once more where
    a phase of the width schedule ends."""
    from cloud_transformers_tpu_torch import eval_inpainting
    from cloud_transformers_tpu_torch.core.noise import partial_postprocess
    from cloud_transformers_tpu_torch.data import (
        DataLoader,
        ShapeNetCompletion,
    )
    from cloud_transformers_tpu_torch.tasks import completion
    from cloud_transformers_tpu_torch.train.checkpoint import (
        restore_params_only,
    )
    from cloud_transformers_tpu_torch.train.config import (
        load_config,
        model_from_config,
    )
    from cloud_transformers_tpu_torch.train.trainer import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "configs", "inpainting.yaml"))
    d = cfg["data"]
    bsz, n_in, n_gt = d["batch_size"], d["input_size"], d["gt_size"]
    if (bsz, n_in, n_gt) != (2, 2048, 16384):
        raise AssertionError("configs/inpainting.yaml is not B=2, 2048 "
                             "partial and 16384 ground-truth points")
    cfg["experiment"] = {"root": exp_root}
    gens = {"train": torch.Generator("cuda").manual_seed(1)}
    trainer = Trainer(
        model_from_config(cfg), cfg, "chip_smoke_completion",
        completion.make_loss_fn(
            gens["train"], float(cfg["train"].get("chamfer_weight", 0.0))),
        device="cuda", seed=0, generators=gens)
    model = trainer.model
    if (len(model.encoder.backbone.trunk.stages), len(model.decoder.stages),
            model.start_conv.out_features, model.mapping.out_features) \
            != (4, 4, 512, 512):
        raise AssertionError("the completion model is not the full-width one")
    train_loader, _ = completion.make_datasets(cfg, synthetic=True)
    batches = endless(train_loader)

    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(next(batches))            # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    step_ms, losses = [], []
    with EmdRecorder() as rec:
        zero_launches(wrappers)
        for _ in range(COMPLETION_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"])
        launches = read_launches(wrappers)
        emd_ms = rec.ms()
    peak = torch.cuda.max_memory_allocated()
    expect = {name: PER_STEP_COMPLETION.get(name, 0) * COMPLETION_STEPS
              for name in launches}
    # one bid search per round, the last round included; with
    # _KERNEL_BID_MIN_WIDTH = 1 every one of them is a kernel launch
    expect.update(top2=sum(rec.rounds), auction_window=0)
    if launches != expect or sum(rec.widths.values()) != launches["top2"]:
        raise AssertionError(f"completion training: launches {launches}, "
                             f"expected {expect}; bid searches {rec.widths}")
    log(f"launches in {COMPLETION_STEPS} completion steps: {launches}; "
        f"rounds per auction {rec.rounds}; bid searches by (B, W) "
        f"{rec.widths}")
    a = rec.assignment
    if a.shape != (bsz, n_gt) or int(a.min()) < 0 or int(a.max()) >= n_gt:
        raise AssertionError("completion training: assignment out of range")
    losses = torch.stack(losses).cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite completion loss: {losses}")
    scale_grads = {}
    for name, param in model.named_parameters():
        if param.grad is None or not bool(torch.isfinite(param.grad).all()):
            raise AssertionError(f"{name}: missing or non-finite gradient")
        if name.startswith("decoder.") and name.endswith(".scale") \
                and param.dim() == 0:
            scale_grads[name] = float(param.grad.abs())
    if len(scale_grads) != 24 or not all(g > 0 for g in scale_grads.values()):
        raise AssertionError("a decoder key scale has no gradient: the key "
                             f"path is not connected ({scale_grads})")
    if trainer.global_step != COMPLETION_STEPS + 1:
        raise AssertionError(f"trainer step count {trainer.global_step}")

    # the model's forward, backward and update never make the host wait;
    # the auction does, once a round, and is left out of this check
    batch = trainer.to_device(next(batches))
    parts, noise = partial_postprocess(gens["train"], batch["partial"], n_gt)
    model.train()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.optimizer.zero_grad()
        recon, _ = model(noise, parts)
        recon.square().mean().backward()
        trainer.optimizer.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("completion model step: no host-device synchronisation")

    ms = float(np.median(step_ms))
    result = {
        "completion_ms_per_step": ms,
        "completion_clouds_per_s": bsz * 1e3 / ms,
        "completion_ms_mean": float(np.mean(step_ms)),
        "completion_ms_p10": float(np.percentile(step_ms, 10)),
        "completion_ms_p90": float(np.percentile(step_ms, 90)),
        "completion_steps": COMPLETION_STEPS,
        "completion_peak_memory_bytes": int(peak),
        "completion_emd_ms_per_step": float(np.median(emd_ms)),
        "completion_emd_share_of_step": float(np.sum(emd_ms)
                                              / np.sum(step_ms)),
        "completion_emd_rounds": rec.rounds,
        "completion_loss_first": float(losses[0]),
        "completion_loss_last": float(losses[-1]),
        "completion_scale_grad_min": min(scale_grads.values()),
        "batch": bsz, "partial_points": n_in, "points": n_gt}
    widths_per_step = {k: v / COMPLETION_STEPS for k, v in rec.widths.items()}

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
        profiled = {"completion_profiled_steps": PROFILE_STEPS,
                    "completion_profiled_wall_ms_per_step":
                        wall_ms / PROFILE_STEPS,
                    "completion_profiled_device_ms_per_step":
                        busy / PROFILE_STEPS,
                    "completion_profiled_device_idle_share":
                        1 - busy / wall_ms}
        table = events.table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, "profile_completion.txt"),
                  "w") as fh:
            fh.write(f"{smi}\n{json.dumps(profiled)}\n"
                     f"device kernels, per completion training step:\n"
                     f"{device_table(events, PROFILE_STEPS)}\n"
                     f"(totals over {PROFILE_STEPS} training steps)\n{table}")
        log(json.dumps(profiled))
        result.update(profiled)

    # one training step under each set: the AdaIN blocks take the same
    # branches as the classifier's
    switched_launches = {}
    for name in SETS:
        with switches(name), EmdRecorder() as rec:
            zero_launches(wrappers)
            metrics = trainer.train_step(next(batches))
            torch.cuda.synchronize()
            got = read_launches(wrappers)
        expect = set_counts(name, PER_STEP_COMPLETION["splat_max"],
                            PER_STEP_COMPLETION["slice_gather"], True)
        expect["top2"] = sum(rec.rounds)
        check_launches(got, expect, 1, f"completion step under {name}")
        loss = float(metrics["loss"])
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
        if not np.isfinite(loss) or bad:
            raise AssertionError(f"completion step under {name}: loss {loss}, "
                                 f"missing or non-finite gradients {bad[:5]}")
        result[f"completion_{name}_loss"] = loss
        switched_launches[name] = got
        log(f"completion step under {name}: loss {loss:.6f}, launches {got}")

    # checkpoint: save, restore into a fresh model, same reconstruction
    path = trainer.save()
    fresh = restore_params_only(path, model_from_config(cfg)).to("cuda")
    model.eval()
    fresh.eval()
    with torch.no_grad():
        same = torch.equal(model(noise, parts)[0], fresh(noise, parts)[0])
    if not same:
        raise AssertionError("the restored model's reconstruction differs "
                             "from the trainer's")
    result["checkpoint_bytes"] = os.path.getsize(path)
    log(f"checkpoint {result['checkpoint_bytes'] / 2 ** 20:.1f} MiB: the "
        "restored model reconstructs bit for bit")
    del trainer, model

    # the evaluation protocol on synthetic test clouds
    ds = ShapeNetCompletion(split="test", n_input=n_in, n_output=n_gt)
    loader = DataLoader(ds, 1, shuffle=False, drop_last=False)
    with EmdRecorder() as rec:
        zero_launches(wrappers)
        per_cat = eval_inpainting.evaluate(
            fresh, loader, torch.Generator("cuda").manual_seed(2), "cuda",
            limit=EVAL_CLOUDS, emd=True, emd_eps=0.004, emd_iters=3000)
        eval_launches = read_launches(wrappers)
        eval_emd_ms = rec.ms()
    table = eval_inpainting.format_table(per_cat, emd=True)
    log(table)
    m = next(iter(per_cat.values()))
    flat = [v for key in ("f", "cd", "emd") for v in m[key]]
    if len(per_cat) != 1 or len(m["f"]) != EVAL_CLOUDS \
            or not np.isfinite(flat).all():
        raise AssertionError(f"evaluation: bad table\n{table}")
    if eval_launches["top2"] != sum(m["rounds"]):
        raise AssertionError(f"evaluation: {eval_launches['top2']} top2 "
                             f"launches, rounds {m['rounds']}")
    result.update({
        "eval_clouds": EVAL_CLOUDS, "eval_f_score": float(np.mean(m["f"])),
        "eval_chamfer_x1000": float(np.mean(m["cd"])),
        "eval_emd": float(np.mean(m["emd"])), "eval_rounds": m["rounds"],
        "eval_seconds_per_cloud": float(np.median(m["seconds"])),
        "eval_seconds": m["seconds"],
        "eval_emd_ms_per_cloud": float(np.median(eval_emd_ms)),
        "eval_top2_launches_per_cloud": eval_launches["top2"] / EVAL_CLOUDS,
        "eval_bid_searches_by_width": {
            f"B={k[0]} W={k[1]}": v for k, v in rec.widths.items()}})
    eval_widths = {k: v / EVAL_CLOUDS for k, v in rec.widths.items()}
    return result, launches, eval_launches, widths_per_step, eval_widths, \
        switched_launches


def window_tail_phase(wrappers):
    """The EMD once more with the window tail switched on (the module
    switch, set and restored here): a pair that converges (uniform clouds,
    the first a permutation of the second plus noise of 0.01, B=2 x 16384,
    eps 0.004, up to 3000 rounds) through the staged tail and through the
    window tail.  The synthetic ShapeNet pairs do not converge within 3000
    rounds under either tail (their clipped corners hold exact duplicates),
    so they cannot show that the window tail ends.
    -> (result dict, launches)."""
    from cloud_transformers_tpu_torch.losses import emd

    rs = np.random.RandomState(0)
    n = 16384
    gt = rs.rand(2, n, 3).astype(np.float32)
    perm = np.stack([rs.permutation(n) for _ in range(2)])
    x1 = torch.as_tensor(
        np.take_along_axis(gt, perm[..., None], 1)
        + 0.01 * rs.randn(2, n, 3).astype(np.float32)).to("cuda")
    x2 = torch.as_tensor(gt).to("cuda")
    runs = {}
    for tail in (False, True):
        emd._WINDOW_TAIL = tail
        try:
            zero_launches(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist, assignment, rounds = emd.emd_auction_with_rounds(
                x1, x2, eps=0.004, iters=3000)
            torch.cuda.synchronize()
            runs[tail] = (time.perf_counter() - t0, rounds,
                          float(torch.sqrt(dist + 1e-12).mean()),
                          assignment, read_launches(wrappers))
        finally:
            emd._WINDOW_TAIL = False
    (s_sec, s_rounds, s_cost, _, s_launches) = runs[False]
    (w_sec, w_rounds, w_cost, w_asg, w_launches) = runs[True]
    one_to_one = all(int(torch.unique(w_asg[i]).numel()) == n
                     for i in range(w_asg.shape[0]))
    rel = abs(w_cost - s_cost) / s_cost
    log(f"window tail: {w_rounds} rounds in {w_sec:.3f} s, "
        f"{w_launches['auction_window']} window launches, cost {w_cost:.6f}; "
        f"staged tail: {s_rounds} rounds in {s_sec:.3f} s, cost "
        f"{s_cost:.6f}; rel diff {rel:.3e}")
    if not (w_rounds < 3000 and one_to_one and rel <= 0.02
            and w_launches["auction_window"] > 0
            and s_launches["auction_window"] == 0):
        raise AssertionError(
            f"window tail: rounds {w_rounds}, one to one {one_to_one}, cost "
            f"rel diff {rel}, launches {w_launches}")
    return ({"window_tail_rounds": w_rounds, "window_tail_seconds": w_sec,
             "window_tail_launches": w_launches["auction_window"],
             "window_tail_top2_launches": w_launches["top2"],
             "window_tail_cost": w_cost, "staged_tail_rounds": s_rounds,
             "staged_tail_seconds": s_sec, "staged_tail_cost": s_cost,
             "staged_tail_top2_launches": s_launches["top2"],
             "window_vs_staged_cost_rel_diff": rel}, w_launches)


def completion_parity():
    """Card against CPU for the completion path: the full-width inpainter
    with one encoder and one decoder stage, B=1, the same weights and the
    same noise (PARITY.md criteria on the reconstruction), and ``loss_emd``
    on one pair of clouds at N=2048 within 2% (the auction amplifies
    rounding, so the loss is held and not the assignment)."""
    from cloud_transformers_tpu_torch.core.noise import partial_postprocess
    from cloud_transformers_tpu_torch.data import ShapeNetCompletion
    from cloud_transformers_tpu_torch.losses import loss_emd
    from cloud_transformers_tpu_torch.models import get_model
    from cloud_transformers_tpu_torch.nn.init import init_model_

    item = ShapeNetCompletion(split="test")[0]
    partial = torch.as_tensor(item["partial"])[None] * 2.0
    parts, noise = partial_postprocess(torch.Generator().manual_seed(3),
                                       partial, 16384)
    out = {}
    for device in ("cuda", "cpu"):
        model = get_model("completion_inpainter", encoder_repeats=1,
                          decoder_repeats=1)
        init_model_(model, torch.Generator().manual_seed(1))
        with torch.no_grad():
            # the key scales start at 0; a trained model's are not
            for name, p in model.named_parameters():
                if name.endswith(".scale") and p.dim() == 0:
                    p.fill_(0.05)
        model = model.to(device).eval()
        t0 = time.perf_counter()
        with torch.no_grad():
            out[device] = model(noise.to(device), parts.to(device))[0].cpu()
        log(f"completion parity: {device} forward in "
            f"{time.perf_counter() - t0:.1f} s")
    if not bool(torch.isfinite(out["cuda"]).all()):
        raise AssertionError("non-finite reconstruction on the card")
    parity(out["cuda"], out["cpu"],
           f"reconstruction {list(out['cpu'].shape)}")

    rs = np.random.RandomState(4)
    x2 = rs.rand(1, 2048, 3).astype(np.float32)
    x1 = (x2[:, rs.permutation(2048)]
          + 0.05 * rs.randn(1, 2048, 3)).astype(np.float32)
    x1, x2 = torch.as_tensor(x1), torch.as_tensor(x2)
    card = float(loss_emd(x1.cuda(), x2.cuda(), eps=0.004, iters=3000))
    cpu = float(loss_emd(x1, x2, eps=0.004, iters=3000))
    rel = abs(card - cpu) / cpu
    log(f"loss_emd N=2048: card {card:.7f}, CPU {cpu:.7f}, rel diff "
        f"{rel:.3e}")
    if not rel <= 0.02:
        raise AssertionError(f"loss_emd card {card} vs CPU {cpu}")
    return {"completion_parity_loss_emd_rel_diff": rel}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help=f"profile {PROFILE_CALLS} classify calls and "
                         f"{PROFILE_STEPS} training steps of each model: "
                         "device idle share, and the tables in "
                         "DIR/profile_forward.txt, DIR/profile_train.txt, "
                         "DIR/profile_completion.txt and, under each set, "
                         "DIR/profile_{forward,train}_set_{a,b}.txt")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    # the default path is the JAX package's defaults; the sets of switches
    # are set by the phases themselves
    for var in ("CT_GRID_CONV", "CT_BLOCK_FUSION"):
        if os.environ.pop(var, None) is not None:
            log(f"{var} ignored: chip_smoke runs each set of switches itself")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cloud_transformers_tpu_torch.nn.precision import strict_f32
    from cloud_transformers_tpu_torch.ops import cuda_build
    from cloud_transformers_tpu_torch.ops import pallas_emd as pe
    from cloud_transformers_tpu_torch.ops import pallas_fused_block as fb
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
    rows.update(check_emd_kernels(gen))
    completion_rows = check_completion_rows(gen)
    torch.cuda.empty_cache()
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
                "grid_conv3d_dw": gc.grid_conv3d_dw, "top2": pe.top2,
                "auction_window": pe.auction_window,
                "grid_conv2d": gc.grid_conv2d,
                "grid_conv2d_dw": gc.grid_conv2d_dw,
                "splat_max_winner": ps.splat_max_winner,
                "splat_route": ps.splat_route, "fused_block": fb.fused_block}
    zero_launches(wrappers)
    call_ms = []   # classify returns numpy, so each call ends synchronised
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(wrappers)
    check_launches(launches, PER_FORWARD, len(batches), "forwards")
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
        os.makedirs(args.profile, exist_ok=True)
        profiled = profile_serving(engine, batches, smi, os.path.join(
            args.profile, "profile_forward.txt"))

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

    # 5b. the serving path under each set of the JAX package's switches
    switched, all_launches = {}, {"serving": launches}
    for name in SETS:
        with switches(name):
            switched[name], all_launches[f"serving_{name}"] = \
                switched_serving(name, engine, cpu_engine, batches, wrappers,
                                 smi, args.profile)

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
    all_launches["training"] = train_launches

    # 7b. training, the sync-free step and gradient parity under each set
    for name in SETS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with switches(name), tempfile.TemporaryDirectory() as exp_root:
            result, all_launches[f"training_{name}"] = train_phase(
                wrappers, smi, args.profile, exp_root, steps=SWITCHED_STEPS,
                profile_name=f"profile_train_{name}.txt",
                per_step=set_counts(name, PER_STEP["splat_max"],
                                    PER_STEP["slice_gather"], True))
            result.update(gradient_parity())
        switched[name].update(result)
        log(f"{name} training phase done in {time.perf_counter() - t0:.1f} s")

    # 8. the third path: completion training, checkpoint, evaluation
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as exp_root:
        (completed, completion_launches, eval_launches, widths_per_step,
         eval_widths, completion_switched) = completion_phase(
             wrappers, smi, args.profile, exp_root)
    for name, got in completion_switched.items():
        all_launches[f"completion_{name}"] = got
    log(f"completion phase done in {time.perf_counter() - t0:.1f} s")
    for row in rows["top2"]:
        row["calls"] = widths_per_step.get((row["b"], row["w"]), 0.0)
        row["calls_per_evaluated_cloud"] = eval_widths.get(
            (row["b"], row["w"]), 0.0)
    if round(sum(r["calls"] for r in rows["top2"]) * COMPLETION_STEPS) \
            != completion_launches["top2"]:
        raise AssertionError("a bid search of the completion step ran at a "
                             f"width that was not checked: {widths_per_step}")
    if round(sum(r["calls_per_evaluated_cloud"] for r in rows["top2"])
             * EVAL_CLOUDS) != eval_launches["top2"]:
        raise AssertionError("a bid search of the evaluation ran at a width "
                             f"that was not checked: {eval_widths}")

    # 9. the window tail, a path of its own
    torch.cuda.empty_cache()
    windowed, window_launches = window_tail_phase(wrappers)
    # the window's times are of the one checked call, from a mid-auction
    # state with every lane bidding; the tail's own calls mostly have a few
    # lanes left and cost less (window_tail_seconds has their sum)
    rows["auction_window"][0]["calls"] = 1.0
    completed.update(windowed)

    # 10. the completion path on the card and on the CPU
    completed.update(completion_parity())

    # 11. results
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
    log(f"{completed['completion_ms_per_step']:.3f} ms/step (median) for the "
        f"completion model at B={completed['batch']} x "
        f"{completed['partial_points']} -> {completed['points']} points, "
        f"{completed['completion_clouds_per_s']:.3f} clouds/s, peak memory "
        f"{completed['completion_peak_memory_bytes'] / 2 ** 30:.2f} GiB, EMD "
        f"{100 * completed['completion_emd_share_of_step']:.1f}% of a step; "
        f"evaluation {completed['eval_seconds_per_cloud']:.3f} s/cloud")
    print(json.dumps(completed), flush=True)
    for name, res in switched.items():
        log(f"{name}: {res['classify_ms_per_forward']:.3f} ms/forward "
            f"(default {ms_fwd:.3f}), {res['train_ms_per_step']:.3f} ms/step "
            f"(default {trained['train_ms_per_step']:.3f})")
    print(json.dumps({"switched": switched}), flush=True)
    all_launches.update(completion=completion_launches,
                        evaluation=eval_launches, window=window_launches)
    print(json.dumps(kernel_line(rows, all_launches, completion_rows)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
