"""The port's voxel-grid subsampler: the native library (built into
``build/native/``) against its numpy plain version and against the JAX
package's ``grid_subsampling``.

* native against numpy: the same voxels (the native library emits them in
  first-appearance order, numpy by sorted key, so the numpy outputs are
  put in first-appearance order), barycenters and mean features within
  1e-6 relative, majority labels equal;
* native against the JAX package's native path (the same source and
  flags): bit-equal;
* a source that does not compile, or no ``g++``, raises (no fallback).
"""

import numpy as np
import pytest

from cloud_transformers_tpu.data.subsample import (
    grid_subsampling as jax_grid_subsampling,
)
from cloud_transformers_tpu_torch.data import subsample


def _cloud(seed, n=20000, extent=(1.0, 1.5, 0.5)):
    rs = np.random.RandomState(seed)
    pts = (rs.rand(n, 3) * np.array(extent)).astype(np.float32)
    colors = (rs.rand(n, 3) * 255).astype(np.float32)
    labels = rs.randint(0, 13, n).astype(np.int32)
    return pts, colors, labels


@pytest.mark.parametrize("seed,sample_dl", [(0, 0.1), (1, 0.04), (2, 0.25)])
def test_native_matches_numpy(seed, sample_dl):
    pts, colors, labels = _cloud(seed)
    n_p, n_f, n_l = subsample.grid_subsampling(pts, colors, labels,
                                               sampleDl=sample_dl)
    p_p, p_f, p_l = subsample.grid_subsampling(pts, colors, labels,
                                               sampleDl=sample_dl,
                                               use_native=False)
    assert n_p.shape == p_p.shape and n_p.shape[0] > 10
    assert n_p.shape[0] < pts.shape[0]      # several points a voxel
    # the numpy outputs (by sorted key) in first-appearance order
    _, first = np.unique(subsample.voxel_keys(pts, sample_dl),
                         return_index=True)
    order = np.argsort(first)
    np.testing.assert_allclose(n_p, p_p[order], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(n_f, p_f[order], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(n_l, p_l[order])


@pytest.mark.parametrize("with_features,with_labels",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
def test_native_bit_equal_to_jax(with_features, with_labels):
    pts, colors, labels = _cloud(3)
    args = dict(features=colors if with_features else None,
                labels=labels if with_labels else None, sampleDl=0.08)
    got = subsample.grid_subsampling(pts, **args)
    want = jax_grid_subsampling(pts, use_native=True, **args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == 1 + with_features + with_labels
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_library_named_by_source(tmp_path, monkeypatch):
    monkeypatch.setattr(subsample, "BUILD_DIR", tmp_path / "native")
    a = subsample.library_path()
    other = tmp_path / "other.cpp"
    other.write_bytes(subsample.SOURCE.read_bytes() + b"\n// edited\n")
    assert a.parent == tmp_path / "native"
    assert a != subsample.library_path(other)
    assert subsample.build() == a and a.exists()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(subsample, "BUILD_DIR", tmp_path / "native")
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int voxelize( {\n")
    with pytest.raises(RuntimeError, match="build failed"):
        subsample.build(bad)
    assert not subsample.library_path(bad).exists()
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        subsample.build(subsample.SOURCE)
