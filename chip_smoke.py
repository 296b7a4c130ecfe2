"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--profile DIR]

1. builds the port's CUDA kernels from ``cloud_transformers_tpu_torch/csrc``;
2. prints the card's name and power limit (nvidia-smi);
3. holds every kernel against its plain PyTorch version on the card at each
   shape the classifier's forward gives it (R = B*H = 128, K = 2048): the
   splat exactly, slice and grid conv within 1e-5 of the output scale; times
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (``scatter_reduce_`` amax for the splat,
   ``grid_sample`` for the slice, grouped ``conv3d`` for the conv; each is
   held to the plain version too); and computes each kernel's bound from
   this run's inputs (the slice counts only the grid rows its mapping reads);
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
6. prints ms/forward and clouds/s, then one ``{"kernels": [...]}`` line, then
   the ``{"ok": true, "device": ...}`` line last.

TF32 is off for matmuls and cuDNN convolutions, so everything is float32.
Any failure raises and the exit code is non-zero; without CUDA the script
exits non-zero before printing any result.  ``--profile DIR`` profiles 10
more classify calls: it adds their host wall time, device busy time and the
device's idle share (one window, both clocks) to the result line, and
writes the torch.profiler table by kernel to ``DIR/profile_forward.txt``.
"""

import argparse
import json
import os
import subprocess
import sys
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
TOL = 1e-5   # max abs error relative to max(1, max |plain output|)
LIB_TOL = 1e-4   # the same, for a library yardstick (other op order)
REPLACES = {
    "splat_max": "cloud_transformers_tpu/ops/pallas_splat.py:528",
    "slice_gather": "cloud_transformers_tpu/ops/pallas_splat.py:780",
    "grid_conv3d": "cloud_transformers_tpu/ops/pallas_grid_conv.py:100",
}
SOURCES = {
    "splat_max": "cloud_transformers_tpu_torch/csrc/splat_slice.cu",
    "slice_gather": "cloud_transformers_tpu_torch/csrc/splat_slice.cu",
    "grid_conv3d": "cloud_transformers_tpu_torch/csrc/grid_conv.cu",
}


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
            shape=f"{'x'.join(map(str, sizes))} F={f}", per_forward=n_splat,
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
        err = float((out - plain).abs().max())
        scale = max(1.0, float(plain.abs().max()))
        if not err <= TOL * scale:
            raise AssertionError(f"slice {sizes} F={f}: max abs err {err} "
                                 f"> {TOL} x {scale}")
        # the library yardstick: one grid_sample call, layouts made outside
        # the timing; it must compute the same function
        inp, pts = grid_sample_inputs(grid, keys, sizes)
        lib = grid_sample_slice(inp, pts).reshape(R, f, K).transpose(1, 2)
        idx, w = ps.vertex_index_weights(*mapping, sizes)
        lib_err = float((lib - plain).abs().max())
        if not lib_err <= LIB_TOL * scale:
            raise AssertionError(f"grid_sample {sizes} F={f}: max abs err "
                                 f"{lib_err} > {LIB_TOL} x {scale}")
        # the grid rows this data reads: distinct (r, cell) with weight > 0
        touched = int(torch.unique(
            (torch.arange(R, device="cuda")[:, None, None] * cells
             + idx)[w > 0]).numel())
        rows["slice_gather"].append(dict(
            shape=f"{'x'.join(map(str, sizes))} F={f}", per_forward=n_slice,
            max_abs_err=err, library_err=lib_err,
            grid_rows_read=touched, grid_rows=R * cells,
            ms=cuda_ms(lambda: ps.slice_gather(*mapping, grid, sizes)),
            plain_ms=cuda_ms(lambda: ps.slice_plain(*mapping, grid, sizes),
                             iters=5),
            library_ms=cuda_ms(lambda: grid_sample_slice(inp, pts)),
            bound=bound(map_bytes + touched * f * 4 + R * K * f * 4,
                        R * K * n_vert * f * 2)))
        del grid, plain, out, inp, pts, lib, idx, w
    for sizes, f, n_conv in CONV_SHAPES:
        cells = ps.kernel_grid_dims(sizes)[2]
        grid = torch.randn(R, cells, f, generator=gen, device="cuda").relu()
        weight = torch.randn(H * f, f, 3, 3, 3, generator=gen,
                             device="cuda") * (27 * f) ** -0.5
        bias = torch.randn(H * f, generator=gen, device="cuda") * 0.1
        out = gc.grid_conv3d(grid, weight, bias, sizes, H)
        plain = gc.grid_conv3d_plain(grid, weight, bias, sizes, H)
        err = float((out - plain).abs().max())
        scale = max(1.0, float(plain.abs().max()))
        if not err <= TOL * scale:
            raise AssertionError(f"grid_conv3d {sizes} F={f}: max abs err "
                                 f"{err} > {TOL} x {scale}")
        x_cf = grid.reshape((B, H) + sizes + (f,)).movedim(-1, 2).reshape(
            (B, H * f) + sizes).contiguous()
        # (output cell, tap) pairs whose input lies inside the grid: the
        # taps over the zero padding need no work
        pairs = int(np.prod([3 * s - 2 for s in sizes]))
        rows["grid_conv3d"].append(dict(
            shape=f"{'x'.join(map(str, sizes))} F={f}", per_forward=n_conv,
            max_abs_err=err,
            ms=cuda_ms(lambda: gc.grid_conv3d(grid, weight, bias, sizes, H)),
            plain_ms=cuda_ms(lambda: gc.grid_conv3d_plain(
                grid, weight, bias, sizes, H), iters=5),
            library_ms=cuda_ms(lambda: torch.nn.functional.conv3d(
                x_cf, weight, bias, padding=1, groups=H)),
            bound=bound(2 * R * cells * f * 4 + weight.numel() * 4
                        + bias.numel() * 4,
                        R * (pairs * f * f * 2 + cells * f))))
        del grid, out, plain, x_cf
    return rows


def kernel_line(rows, launches):
    """Per kernel: times summed over one forward's calls (each shape times
    its calls per forward), with the per-shape numbers beside them."""
    out = []
    for name, shapes in rows.items():
        def total(key):
            return sum(s[key] * s["per_forward"] for s in shapes)
        t_bound = sum(s["bound"][0] * s["per_forward"] for s in shapes)
        by = max(shapes, key=lambda s: s["bound"][0] * s["per_forward"])
        lib = (None if any(s["library_ms"] is None for s in shapes)
               else total("library_ms"))
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": t_bound, "bound_by": by["bound"][1],
            "library_ms": lib,
            "per_shape": [{
                "shape": s["shape"], "per_forward": s["per_forward"],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound"][0], "bound_by": s["bound"][1],
                "library_ms": s["library_ms"],
                "max_abs_err": s["max_abs_err"],
                **{k: s[k] for k in ("library_err", "grid_rows_read",
                                     "grid_rows") if k in s}}
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help=f"profile {PROFILE_CALLS} classify calls: device "
                         "idle share, and the table in "
                         "DIR/profile_forward.txt")
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
                "grid_conv3d": gc.grid_conv3d}
    for w in wrappers.values():
        w.launches = 0
    call_ms = []   # classify returns numpy, so each call ends synchronised
    for clouds in batches:
        t0 = time.perf_counter()
        probs = engine.classify(clouds)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {name: w.launches for name, w in wrappers.items()}
    expect = {"splat_max": 26, "slice_gather": 24, "grid_conv3d": 8}
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
        # kernels and copies on the card, summed as the table's footer sums
        # them; one stream, so they do not overlap
        device_ms = sum(
            e.self_device_time_total for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)) / 1e3
        profiled = {"profiled_calls": PROFILE_CALLS,
                    "profiled_wall_ms_per_forward": wall_ms / PROFILE_CALLS,
                    "profiled_device_ms_per_forward":
                        device_ms / PROFILE_CALLS,
                    "profiled_device_idle_share": 1 - device_ms / wall_ms}
        os.makedirs(args.profile, exist_ok=True)
        table = events.table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(args.profile, "profile_forward.txt"),
                  "w") as fh:
            fh.write(f"{smi}\n{json.dumps(profiled)}\n"
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

    # 6. results
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
    print(json.dumps(kernel_line(rows, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
