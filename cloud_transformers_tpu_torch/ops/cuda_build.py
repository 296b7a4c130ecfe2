"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``cloud_transformers_tpu_torch/csrc/`` is compiled for
``sm_90a`` into its own shared library with a plain C interface; the
``nvcc`` processes start together and run in parallel.  No source includes
PyTorch's headers, which keeps a cold build to seconds instead of minutes.
Libraries go to ``build/kernels/`` at the root of the checkout, named by a
hash of their source and flags, so an edited source is rebuilt and an
unchanged one is reused.

Nothing here runs at import time: the first wrapper that launches a kernel
calls ``libraries()``, which builds (or finds) every library once per
process.  A missing ``nvcc`` or a failed compile raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from cloud_transformers_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points, by library (source stem)
SIGNATURES = {
    "splat_slice": {
        "ct_splat_max": [_P] * 8,
        "ct_slice": [_P] * 8,
        "ct_splat_max_bwd": [_P] * 13,
        "ct_slice_bwd": [_P] * 12,
        "ct_splat_max_winner": [_P] * 10,
        "ct_splat_route": [_P] * 12,
    },
    "grid_conv": {
        "ct_grid_conv3d": [_P] * 5 + [_I] * 12 + [_P],
        "ct_grid_conv2d": [_P] * 4 + [_I] * 10 + [_P],
        "ct_grid_conv3d_dw": [_P] * 4 + [_I] * 15 + [_P],
        "ct_grid_conv2d_dw": [_P] * 4 + [_I] * 10 + [_P],
    },
    "fused_block": {
        "ct_fused_block": [_P] * 12,
    },
    "emd": {
        "ct_emd_top2": [_P] * 10,
        "ct_emd_auction_window": [_P] * 10 + [_I] * 3 + [_F, _P],
    },
    "batch_norm": {
        "ct_bn_stats": [_P] * 6 + [_I] * 8 + [_F] * 3 + [_I, _P],
        "ct_bn_apply": [_P] * 6 + [_I] * 8 + [_P],
        "ct_bn_backward": [_P] * 11 + [_I] * 12 + [_P],
    },
}

_loaded = {}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(src):
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def build(timeout=600):
    """Compile every source that has no up-to-date library, all in
    parallel.  Returns {stem: path of the .so}.  ptxas' register and
    shared-memory report for each build is kept beside it as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))}
    jobs = {}
    for stem, (src, so) in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp, so)
    failed = []
    try:
        for stem, (proc, tmp, so) in jobs.items():
            out, _ = proc.communicate(timeout=timeout)
            so.with_suffix(".log").write_bytes(out)
            if proc.returncode != 0:
                failed.append(f"{stem}: nvcc exited {proc.returncode}\n"
                              + out.decode(errors="replace"))
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
    finally:
        # a timeout or an error leaves no nvcc running behind the caller
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    trace.count("kernels.built", len(jobs))
    return {stem: so for stem, (_, so) in targets.items()}


def libraries():
    """{stem: ctypes.CDLL} with argtypes set; builds on first use (the
    ``setup.kernels`` span; ``kernels.built`` and ``kernels.loaded`` count
    the sources compiled and the libraries loaded)."""
    if not _loaded:
        with trace.span("setup.kernels"):
            for stem, so in build().items():
                lib = ctypes.CDLL(str(so))
                for fn, argtypes in SIGNATURES[stem].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _loaded[stem] = lib
            trace.count("kernels.loaded", len(_loaded))
    return _loaded


def int_params(*values):
    """(C int array of ``values``, its address) for an entry point that
    takes its integers by address.  Cache it per shape and keep the array:
    ctypes converts every argument on every call, which for a dozen ints
    costs more host time than a small kernel takes on the card."""
    arr = (ctypes.c_int * len(values))(*values)
    return arr, ctypes.addressof(arr)


def current_stream(device):
    """Raw handle of ``device``'s current CUDA stream: what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object at every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err, what):
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
