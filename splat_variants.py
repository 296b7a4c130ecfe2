"""Time the splat kernels of the PyTorch/CUDA port on one NVIDIA GPU, per
shape, beside variants of the splat kernel and beside another checkout;
or, with ``--kernel slice_bwd``, the slice backward and its variants.

    python3 splat_variants.py [--kernel splat|slice_bwd] [--tree DIR]
                              [--variants] [--tag NAME]

For each head-group shape of the classifier (R = 128 rows of K = 2048
points) and of the completion decoder (R = 32 x K = 16384) it holds
``splat_max`` and ``splat_max_winner`` bit-equal to their plain versions
and times each by a loop of 20 launches and by CUDA-graph replay, as
``chip_smoke.py`` does (its helpers are used), then prints one JSON line a
shape and the sums per pass (a forward's calls at the classifier's rows,
four calls a shape at the decoder's).  ``--tree DIR`` times the port of
another checkout (its package and its ``chip_smoke.py``), for a parent
commit.  ``--variants`` also times the splat built from ``VARIANTS``:
text substitutions of ``csrc/splat_slice.cu`` (asserted to apply once
each) with the matching Python constants, compiled beside the real build.
``--kernel slice_bwd`` does the same for ``slice_bwd`` on a grid of the
forward's kind and a random point cotangent (``SLICE_BWD_VARIANTS``): each
kernel within 1e-5 of the plain version, and the port's d_grid the same in
two runs; four calls a shape at either rows (a classifier step's and a
decoder step's).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

# name -> ([(text in csrc/splat_slice.cu, its replacement)], {pallas_splat
# constant: value}); the kernel as it stands is "change"
VARIANTS = {
    # a volatile read of the shared-memory word before each atomicMax
    "precheck": ([(
        "    atomicMax(reinterpret_cast<int*>(slab + at), __float_as_int(c));",
        "    if (c > *static_cast<volatile float*>(slab + at))\n"
        "      atomicMax(reinterpret_cast<int*>(slab + at), __float_as_int(c));"
    )], {}),
    # a relaxed global read of the word before each write-out atomicMax
    "flushcheck": ([(
        "      if (t > 0.0f)\n"
        "        atomicMax(reinterpret_cast<int*>(out + i), __float_as_int(t));",
        "      float held;\n"
        "      asm volatile(\"ld.relaxed.gpu.global.f32 %0, [%1];\"\n"
        "                   : \"=f\"(held) : \"l\"(out + i));\n"
        "      if (t > held)\n"
        "        atomicMax(reinterpret_cast<int*>(out + i), __float_as_int(t));"
    )], {}),
    "fill132": ([("kFillBlocks = 132 * 3;", "kFillBlocks = 132;")],
                {"SPLAT_FILL_BLOCKS": 132}),
    "fill264": ([("kFillBlocks = 132 * 3;", "kFillBlocks = 132 * 2;")],
                {"SPLAT_FILL_BLOCKS": 264}),
    "fill528": ([("kFillBlocks = 132 * 3;", "kFillBlocks = 132 * 4;")],
                {"SPLAT_FILL_BLOCKS": 528}),
    "listp1": ([("kListP = 2;", "kListP = 1;")], {}),
    "listp4": ([("kListP = 2;", "kListP = 4;")], {}),
}
# the slice backward's: the d_grid words a block sums (so the slabs), the
# blocks that fill the card
SLICE_BWD_VARIANTS = {
    "slab8192": ([("kSbSlabWords = 4992;", "kSbSlabWords = 8192;")],
                 {"SLICE_BWD_SLAB_WORDS": 8192}),
    "slab12288": ([("kSbSlabWords = 4992;", "kSbSlabWords = 12288;")],
                  {"SLICE_BWD_SLAB_WORDS": 12288}),
    "fill132": ([("kSbFillBlocks = 132 * 3;", "kSbFillBlocks = 132;")],
                {"SLICE_BWD_FILL_BLOCKS": 132}),
    # one or four listed points a lane group (shared with the splat)
    "listp1": ([("kListP = 2;", "kListP = 1;")], {}),
    "listp4": ([("kListP = 2;", "kListP = 4;")], {}),
}
HEADS = 16
# (sizes, F, calls per forward at the classifier's rows)
SHAPES = [((128, 128), 4, 4), ((32, 32, 32), 4, 4), ((64, 64), 16, 4),
          ((16, 16, 16), 16, 4), ((16, 16), 16, 5), ((8, 8, 8), 32, 5)]
ROWS = [(8, 2048), (2, 16384)]   # (clouds, points); 16 heads a cloud


def start_variant(cuda_build, name, edits):
    """Start compiling ``csrc/splat_slice.cu`` with ``edits`` into the
    build directory.  -> (the nvcc process, the library's path)."""
    src = (cuda_build.CSRC / "splat_slice.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source exactly once")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    return subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE), so


def load_variant(cuda_build, proc, so):
    """Wait for a variant's build; -> its library, entry points typed."""
    _, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{so.name}: nvcc failed\n{err.decode()}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in cuda_build.SIGNATURES["splat_slice"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def time_tag(tag, smoke, ps, winner=True):
    """One JSON line a shape and the sums per pass for the kernels as they
    are loaded now."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, k in ROWS:
        for sizes, f, calls in SHAPES:
            mapping, values, _ = smoke.mapping_inputs(sizes, f, gen, b, k)
            plain = ps.splat_max_plain(*mapping, values, sizes)

            def splat():
                return ps.splat_max(*mapping, values, sizes)
            if not torch.equal(splat(), plain):
                raise AssertionError(f"{tag} {sizes} F={f} K={k}: splat_max "
                                     "differs from the plain version")
            row = dict(tag=tag, shape=f"{'x'.join(map(str, sizes))} F={f}",
                       rows=b * HEADS, points=k,
                       calls=calls if b * HEADS == 128 else 4,
                       ms=smoke.cuda_ms(splat),
                       device_ms=smoke.graph_ms(splat))
            if winner:
                def winner_splat():
                    return ps.splat_max_winner(*mapping, values, sizes)
                grid, won = winner_splat()
                if not (torch.equal(grid, plain) and torch.equal(
                        won, ps.splat_winner_plain(*mapping, values, plain,
                                                   sizes))):
                    raise AssertionError(f"{tag} {sizes} F={f} K={k}: "
                                         "splat_max_winner differs")
                row.update(winner_ms=smoke.cuda_ms(winner_splat),
                           winner_device_ms=smoke.graph_ms(winner_splat))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del mapping, values, plain
    for key in ("ms", "device_ms", "winner_ms", "winner_device_ms"):
        for r in (128, 32):
            got = [x for x in rows if x["rows"] == r and key in x]
            if got:
                print(json.dumps({"tag": tag, "per_pass": key, "rows": r,
                                  "ms": sum(x[key] * x["calls"]
                                            for x in got)}), flush=True)


def time_slice_bwd(tag, smoke, ps):
    """One JSON line a shape and the sums per pass for the slice backward
    as it is loaded now."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, k in ROWS:
        for sizes, f, _ in SHAPES:
            mapping, values, _ = smoke.mapping_inputs(sizes, f, gen, b, k)
            grid = ps.splat_max(*mapping, values, sizes)
            g_pts = torch.randn(values.shape, generator=gen, device="cuda")

            def slice_bwd():
                return ps.slice_bwd(*mapping, g_pts, grid, sizes)
            got = slice_bwd()
            plain = ps.slice_bwd_plain(*mapping, g_pts, grid, sizes)
            for a, p in zip(got, plain):
                smoke.held(f"{tag} {sizes} F={f} K={k}", a, p, smoke.TOL)
            # the port's d_grid has one order; the parent's took atomics
            if hasattr(ps, "slice_bwd_plan") and not torch.equal(
                    got[0], slice_bwd()[0]):
                raise AssertionError(f"{tag} {sizes} F={f} K={k}: two "
                                     "runs of d_grid differ")
            row = dict(tag=tag, shape=f"{'x'.join(map(str, sizes))} F={f}",
                       rows=b * HEADS, points=k, calls=4,
                       ms=smoke.cuda_ms(slice_bwd),
                       device_ms=smoke.graph_ms(slice_bwd))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del mapping, values, grid, g_pts, got, plain
    for key in ("ms", "device_ms"):
        for r in (128, 32):
            got = [x for x in rows if x["rows"] == r]
            print(json.dumps({"tag": tag, "per_pass": key, "rows": r,
                              "ms": sum(x[key] * x["calls"] for x in got)}),
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("splat", "slice_bwd"),
                    default="splat")
    ap.add_argument("--tree", help="time the port of this checkout")
    ap.add_argument("--variants", action="store_true",
                    help="also time the kernel's variants")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("splat_variants: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.tree or os.path.dirname(
        os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as smoke
    from cloud_transformers_tpu_torch.ops import cuda_build
    from cloud_transformers_tpu_torch.ops import pallas_splat as ps
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    cuda_build.libraries()
    if args.kernel == "splat":
        variants, caches = VARIANTS, ("_splat_plan", "_splat_params")

        def run(tag, is_variant):
            time_tag(tag, smoke, ps, winner=not is_variant)
    else:
        variants = SLICE_BWD_VARIANTS
        caches = ("_slice_bwd_plan", "_slice_bwd_params")

        def run(tag, is_variant):
            time_slice_bwd(tag, smoke, ps)
    # the variants compile, all together, while the kernels as they are run
    builds = {name: start_variant(cuda_build, name, edits)
              for name, (edits, _) in variants.items()} \
        if args.variants else {}
    run(args.tag, False)
    real = cuda_build.libraries()["splat_slice"]
    for name, (proc, so) in builds.items():
        consts = variants[name][1]
        saved = {c: getattr(ps, c) for c in consts}
        cuda_build._loaded["splat_slice"] = load_variant(cuda_build, proc, so)
        for c, v in consts.items():
            setattr(ps, c, v)
        for cache in caches:
            getattr(ps, cache).cache_clear()
        run(name, True)
        for c, v in saved.items():
            setattr(ps, c, v)
        for cache in caches:
            getattr(ps, cache).cache_clear()
    cuda_build._loaded["splat_slice"] = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
