"""The single-view reconstruction data of the port against the JAX
package's (numpy only on both sides): ``ImageToPoint`` items bit-equal for
the same seed and epoch, synthetic and from a small what3d-style directory
of PNG renderings and PLY clouds; ``resample_pcd``; ``read_ply`` (ascii and
binary_little_endian); ``write_pcd`` read back by ``read_pcd``."""

import numpy as np
import pytest

from cloud_transformers_tpu.data import image_point as jip
from cloud_transformers_tpu.data import pointcloud_io as jio
from cloud_transformers_tpu_torch.data import ImageToPoint
from cloud_transformers_tpu_torch.data import image_point as tip
from cloud_transformers_tpu_torch.data import pointcloud_io as tio


def _equal_items(a, b):
    assert set(a) == set(b) == {"image", "pcd", "class_id"}
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _write_ply(path, xyz, binary, extra=True):
    """A PLY with an rgb property between the coordinates' and a face
    element after the vertices (both are skipped by the reader)."""
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    if extra:
        props.append("property uchar red")
    header = ["ply", "format " + ("binary_little_endian 1.0" if binary
                                  else "ascii 1.0"),
              f"element vertex {n}", *props,
              "element face 0", "property list uchar int vertex_indices",
              "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if extra:
                dtype.append(("red", "u1"))
            rec = np.zeros(n, dtype)
            rec["x"], rec["y"], rec["z"] = xyz.T
            f.write(rec.tobytes())
        else:
            for p in xyz:
                f.write((" ".join(f"{c:.6f}" for c in p)
                         + (" 7" if extra else "") + "\n").encode())


def _what3d(root, rs):
    """Two categories, two objects each, two views an object."""
    from PIL import Image
    for c, cat in enumerate(("02691156", "03001627")):
        (root / "lists" / cat).mkdir(parents=True)
        objects = [f"obj{c}{i}" for i in range(2)]
        for split in ("train", "test"):
            (root / "lists" / cat / f"{split}.txt").write_text(
                "\n".join(objects) + "\n")
        for i, obj in enumerate(objects):
            (root / "renderings" / cat / obj).mkdir(parents=True)
            (root / "points" / cat / obj).mkdir(parents=True)
            for view in ("00", "01"):
                img = rs.randint(0, 256, (20, 24, 3)).astype(np.uint8)
                Image.fromarray(img).save(
                    root / "renderings" / cat / obj / f"{view}.png")
                xyz = rs.rand(40 + 30 * i, 3).astype(np.float32)
                _write_ply(root / "points" / cat / obj / f"{view}.ply", xyz,
                           binary=(view == "00"))
            (root / "renderings" / cat / obj / "notes.txt").write_text("x")


@pytest.mark.parametrize("split,points", [("train", 96), ("test", 300)])
def test_synthetic_items_match_jax(split, points):
    ours = ImageToPoint(split=split, im_size=16, points=points)
    ref = jip.ImageToPoint(split=split, im_size=16, points=points)
    assert len(ours) == len(ref) == 32
    assert ours.class_names == ref.class_names == ["synthetic"]
    for i in (0, 5, 31):
        _equal_items(ours[i], ref[i])
    assert ours[3]["image"].shape == (16, 16, 3)
    assert ours[3]["pcd"].shape == (points, 3)


def test_directory_items_match_jax(tmp_path):
    _what3d(tmp_path, np.random.RandomState(0))
    for split in ("train", "test"):
        ours = ImageToPoint(str(tmp_path), split=split, im_size=32,
                            points=64, seed=3)
        ref = jip.ImageToPoint(str(tmp_path), split=split, im_size=32,
                               points=64, seed=3)
        assert ours.class_names == ref.class_names == ["02691156",
                                                       "03001627"]
        assert len(ours) == len(ref) == 8    # 2 categories x 2 objects x 2
        for epoch in (0, 2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            for i in range(len(ours)):
                _equal_items(ours[i], ref[i])
    ours.set_epoch(0)
    a = ours[1]["pcd"]
    ours.set_epoch(1)
    assert not np.array_equal(a, ours[1]["pcd"])   # reshuffled per epoch
    assert ours[7]["class_id"] == 1


@pytest.mark.parametrize("n_in,n", [(50, 20), (50, 50), (50, 137)])
def test_resample_pcd_matches_jax(n_in, n):
    pcd = np.random.RandomState(1).rand(n_in, 3).astype(np.float32)
    got = tip.resample_pcd(pcd, n, np.random.RandomState(5))
    want = jip.resample_pcd(pcd, n, np.random.RandomState(5))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n, 3)
    # every input point is kept where n allows it
    assert len(np.unique(got, axis=0)) == min(n, n_in)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("extra", [False, True])
def test_read_ply_matches_jax(tmp_path, binary, extra):
    xyz = np.random.RandomState(2).randn(33, 3).astype(np.float32)
    path = tmp_path / "c.ply"
    _write_ply(path, xyz, binary, extra)
    got = tio.read_ply(path)
    np.testing.assert_array_equal(got, jio.read_ply(path))
    assert got.dtype == np.float32 and got.shape == (33, 3)
    np.testing.assert_allclose(got, xyz, atol=0 if binary else 1e-6)
    # one vertex: an ascii body of a single row
    _write_ply(path, xyz[:1], binary, extra)
    np.testing.assert_allclose(tio.read_ply(path), xyz[:1], atol=1e-6)


def test_read_ply_refuses_other_files(tmp_path):
    path = tmp_path / "c.ply"
    path.write_bytes(b"ply\nformat binary_big_endian 1.0\n"
                     b"element vertex 1\nproperty float x\nend_header\n")
    with pytest.raises(ValueError):
        tio.read_ply(path)
    path.write_bytes(b"pcd\n")
    with pytest.raises(ValueError):
        tio.read_ply(path)


def test_write_pcd_round_trip(tmp_path):
    xyz = np.random.RandomState(3).rand(25, 3).astype(np.float32)
    tio.write_pcd(tmp_path / "a.pcd", xyz)
    jio.write_pcd(tmp_path / "b.pcd", xyz)
    assert (tmp_path / "a.pcd").read_bytes() == \
        (tmp_path / "b.pcd").read_bytes()
    np.testing.assert_allclose(tio.read_pcd(tmp_path / "a.pcd"), xyz,
                               atol=5e-7)


def test_load_image_is_imagenet_normalised(tmp_path):
    from PIL import Image
    Image.fromarray(np.full((8, 8, 3), 255, np.uint8)).save(tmp_path / "w.png")
    img = tip.load_image(tmp_path / "w.png", 4)
    assert img.shape == (4, 4, 3) and img.dtype == np.float32
    np.testing.assert_allclose(
        img[0, 0], (1.0 - tip.IMAGENET_MEAN) / tip.IMAGENET_STD, rtol=1e-6)
    np.testing.assert_array_equal(img, jip.load_image(tmp_path / "w.png", 4))
