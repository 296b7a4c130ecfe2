"""The port's S3DIS data path against the JAX package's, on the CPU.

``Indoor3DSemSeg`` items equal to the JAX dataset's bit for bit for the same
seed, epoch and index: on the synthetic blocks and on a tiny h5 fixture in
the reference layout (``all_files.txt``, ``room_filelist.txt``, blocks of
xyz + rgb + normalized xyz), both splits of ``test_area``; with the
augmentations off, on, and on with elastic distortion and dropout.  Each
augmentation of ``data/augment.py`` and the HSV shift against its JAX twin
on the same draws.  The h5 path needs h5py, the elastic distortion scipy.
"""

import numpy as np
import pytest

from cloud_transformers_tpu.data import augment as jaug
from cloud_transformers_tpu.data import s3dis as js3dis
from cloud_transformers_tpu_torch.data import augment as taug
from cloud_transformers_tpu_torch.data import s3dis as ts3dis

AUGS = [dict(aug=False), dict(aug=True),
        dict(aug=True, aug_elastic=True, aug_dropout=True)]


def _equal_items(jds, tds, epochs=(0, 3)):
    assert len(jds) == len(tds)
    for epoch in epochs:
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            a, b = jds[i], tds[i]
            assert set(a) == set(b) == {"pcd", "label"}
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", AUGS)
def test_synthetic_items_match_jax(train, kw):
    args = dict(train=train, num_points=96, synthetic_items=3, seed=4, **kw)
    jds, tds = js3dis.Indoor3DSemSeg(**args), ts3dis.Indoor3DSemSeg(**args)
    np.testing.assert_array_equal(jds.points, tds.points)
    np.testing.assert_array_equal(jds.labels, tds.labels)
    _equal_items(jds, tds)
    item = tds[0]
    assert item["pcd"].shape == (96, 6) and item["label"].shape == (96,)


def _h5_fixture(root):
    """Two h5 files of 3 blocks each (64 points of 9 channels), the rooms of
    Area_1, Area_5 and Area_2 in turn."""
    import h5py
    rs = np.random.RandomState(7)
    names = []
    for f in range(2):
        name = f"ply_data_all_{f}.h5"
        with h5py.File(root / name, "w") as h:
            data = rs.rand(3, 64, 9).astype(np.float32)
            h["data"] = data
            h["label"] = rs.randint(0, 13, (3, 64)).astype(np.uint8)
        names.append(f"indoor3d_sem_seg_hdf5_data/{name}")
    (root / "all_files.txt").write_text("\n".join(names) + "\n")
    rooms = [f"Area_{a}_office_{i}" for i, a in enumerate([1, 5, 2] * 2)]
    (root / "room_filelist.txt").write_text("\n".join(rooms) + "\n")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kw", AUGS)
def test_h5_items_match_jax(tmp_path, train, kw):
    _h5_fixture(tmp_path)
    args = dict(data_dir=str(tmp_path), train=train, num_points=48,
                test_area="Area_5", **kw)
    jds, tds = js3dis.Indoor3DSemSeg(**args), ts3dis.Indoor3DSemSeg(**args)
    # the test area's two blocks, or the other four
    assert len(tds) == (4 if train else 2)
    assert tds.points.dtype == np.float32 and tds.labels.dtype == np.int32
    np.testing.assert_array_equal(jds.points, tds.points)
    np.testing.assert_array_equal(jds.labels, tds.labels)
    _equal_items(jds, tds)


def test_data_percent_and_the_epoch():
    tds = ts3dis.Indoor3DSemSeg(num_points=32, synthetic_items=8,
                                data_percent=0.5, aug=True)
    assert len(tds) == 4
    first = tds[0]["pcd"]
    tds.set_epoch(1)
    assert np.abs(first - tds[0]["pcd"]).max() > 1e-3


def _twins(fn, *args, seed=3, **kw):
    """The JAX and the port augmentation on the same input and draws; ->
    both results, and the generators' states after them equal."""
    ja, ta = np.random.RandomState(seed), np.random.RandomState(seed)
    got_j = getattr(jaug, fn)(*args, ja, **kw)
    got_t = getattr(taug, fn)(*args, ta, **kw)
    assert ja.randint(1 << 30) == ta.randint(1 << 30)   # as many draws
    return got_j, got_t


@pytest.mark.parametrize("fn,kw", [
    ("rotate_z", {}), ("rotate_y", {}), ("jitter", {}),
    ("random_scale", {}), ("random_flip_xy", {}),
    ("random_flip_xy", {"p": 0.9}),
])
def test_point_augmentations_match_jax(fn, kw):
    pts = np.random.RandomState(0).randn(200, 3).astype(np.float32)
    for seed in range(4):
        j, t = _twins(fn, pts, seed=seed, **kw)
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("fn,kw", [
    ("chromatic_jitter", {"std": 0.05}), ("chromatic_translation",
                                          {"ratio": 0.1}),
    ("chromatic_autocontrast", {}), ("chromatic_autocontrast", {"p": 1.0}),
])
def test_color_augmentations_match_jax(fn, kw):
    colors = np.random.RandomState(1).rand(200, 3).astype(np.float32)
    for seed in range(4):
        j, t = _twins(fn, colors, seed=seed, **kw)
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(j, t)


def test_dropout_elastic_and_hsv_match_jax():
    rs = np.random.RandomState(2)
    pts = rs.rand(300, 6).astype(np.float32)
    labels = rs.randint(0, 13, 300).astype(np.int32)
    for seed in range(3):
        (jp, jl), (tp, tl) = _twins("random_dropout", pts, labels, seed=seed)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(jl, tl)
        j, t = _twins("elastic_distortion", pts[:, :3], 0.2, 0.4, seed=seed)
        assert t.dtype == np.float32
        np.testing.assert_array_equal(j, t)
        ja, ta = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(
            js3dis.hue_saturation_translation(pts[:, 3:], ja),
            ts3dis.hue_saturation_translation(pts[:, 3:], ta))
    # the HSV round trip is the identity on colors in [0, 1]
    rgb = rs.rand(500, 3)
    np.testing.assert_allclose(
        ts3dis._hsv_to_rgb(ts3dis._rgb_to_hsv(rgb)), rgb, atol=1e-12)
    assert ts3dis.CLASS_NAMES == js3dis.CLASS_NAMES
