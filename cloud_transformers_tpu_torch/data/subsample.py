"""Voxel-grid subsampling: one (barycenter, mean feature, majority label)
per occupied ``sampleDl`` voxel.

Counterpart of ``cloud_transformers_tpu/data/subsample.py``: the same
ctypes bridge to ``native/grid_subsampling/grid_subsampling.cpp`` (read,
never written), and the numpy version as its plain counterpart.

The native library is built with ``g++ -O3 -shared -fPIC`` into
``build/native/`` at the root of the checkout, named by a digest of the
source and the flags (as ``ops/cuda_build.py`` names the CUDA libraries),
on the first call that needs it; nothing is built at import time.  A
missing ``g++`` or a failed build raises: the numpy version runs only when
the caller passes ``use_native=False``.

The two emit the same voxels in different orders: the native library in
the order of each voxel's first point, the numpy version by sorted voxel
key.  The numpy version computes the voxel index as the native library
does, ``floor((p - min) * float32(1 / sampleDl))`` in float32, so that a
point on a voxel face lands in the same voxel in both; it sums in float64
where the native library sums in float32, so barycenters and means agree
to float32 rounding.  A majority vote that ties goes to the lowest label
in both.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "grid_subsampling" / "grid_subsampling.cpp"
BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()


def library_path(source=SOURCE):
    """Where the library built from ``source`` goes: ``build/native/``,
    named by a digest of the source and the flags."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgridsubsample-{digest[:16]}.so"


def build(source=SOURCE, timeout=300):
    """Compile ``source`` unless its library is there.  -> its path;
    raises where ``g++`` is missing or fails."""
    so = library_path(source)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o",
                               str(tmp)], capture_output=True,
                              timeout=timeout)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native grid subsampler "
                           "cannot be built") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native grid subsampler build failed (g++ exited "
            f"{proc.returncode}):\n{proc.stderr.decode(errors='replace')}")
    os.replace(tmp, so)
    return so


def _load_native():
    """The native library with its signatures; built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.voxelize.restype = ctypes.c_int32
            lib.voxelize.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
            lib.reduce_cells.restype = None
            lib.reduce_cells.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
    return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _native_subsample(points, features, labels, sample_dl, n_label_classes):
    lib = _load_native()
    n = points.shape[0]
    cell_ids = np.empty(n, np.int32)
    n_cells = lib.voxelize(_fptr(points), n, ctypes.c_float(sample_dl),
                           _iptr(cell_ids))
    f_dim = 0 if features is None else features.shape[1]
    out_points = np.empty((n_cells, 3), np.float32)
    out_features = (np.empty((n_cells, f_dim), np.float32)
                    if f_dim else np.empty((0, 0), np.float32))
    out_labels = (np.empty(n_cells, np.int32) if labels is not None
                  else np.empty(0, np.int32))
    lib.reduce_cells(
        _fptr(points),
        _fptr(features) if features is not None else None,
        _iptr(labels) if labels is not None else None,
        _iptr(cell_ids), n, f_dim,
        n_label_classes if labels is not None else 0,
        n_cells, _fptr(out_points), _fptr(out_features),
        _iptr(out_labels))
    return out_points, (out_features if f_dim else None), \
        (out_labels if labels is not None else None)


def voxel_keys(points, sample_dl):
    """Each point's voxel key, ``ix | iy << 21 | iz << 42`` (21 bits an
    axis), with the voxel index computed as the native library does."""
    minv = points.min(0)
    inv = np.float32(1.0) / np.float32(sample_dl)
    vox = np.floor((points - minv) * inv).astype(np.int64)
    return (vox[:, 0] & 0x1FFFFF) | ((vox[:, 1] & 0x1FFFFF) << 21) | \
        ((vox[:, 2] & 0x1FFFFF) << 42)


def _numpy_subsample(points, features, labels, sample_dl, n_label_classes):
    uniq, inv, counts = np.unique(voxel_keys(points, sample_dl),
                                  return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    n_cells = uniq.shape[0]
    out_points = np.zeros((n_cells, 3), np.float64)
    np.add.at(out_points, inv, points)
    out_points = (out_points / counts[:, None]).astype(np.float32)
    out_features = None
    if features is not None:
        out_features = np.zeros((n_cells, features.shape[1]), np.float64)
        np.add.at(out_features, inv, features)
        out_features = (out_features / counts[:, None]).astype(np.float32)
    out_labels = None
    if labels is not None:
        votes = np.zeros((n_cells, n_label_classes), np.int64)
        np.add.at(votes, (inv, labels.reshape(-1)), 1)
        out_labels = votes.argmax(1).astype(np.int32)
    return out_points, out_features, out_labels


def grid_subsampling(points, features=None, labels=None, sampleDl=0.1,
                     n_label_classes=13, use_native=True):
    """Subsample to one (barycenter, mean feature, majority label) per
    occupied voxel.  Returns only the arrays that were provided, as the
    JAX package's and the reference's wrappers do."""
    points = np.ascontiguousarray(points, np.float32)
    if features is not None:
        features = np.ascontiguousarray(features, np.float32)
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.int32).reshape(-1)
        n_label_classes = max(n_label_classes, int(labels.max()) + 1)
    impl = _native_subsample if use_native else _numpy_subsample
    out_points, out_features, out_labels = impl(
        points, features, labels, float(sampleDl), n_label_classes)
    result = [out_points]
    if features is not None:
        result.append(out_features)
    if labels is not None:
        result.append(out_labels)
    return result[0] if len(result) == 1 else tuple(result)
