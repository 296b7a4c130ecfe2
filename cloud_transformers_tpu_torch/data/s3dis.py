"""S3DIS semantic segmentation, 1x1-block protocol (blocks of 4096 points).

Counterpart of ``cloud_transformers_tpu/data/s3dis.py``: pre-blocked h5
files (``all_files.txt``, ``room_filelist.txt``; per point xyz, rgb and the
normalized xyz, of which the model takes the first 6 channels), split by
area, and the training augmentations (rotation about z, an anisotropic
scale, a flip of x, jitter, chromatic autocontrast, translation and jitter,
an HSV shift; elastic distortion and dropout where asked).  Each item draws
from its own ``item_rng``, in the JAX package's order, so a seed, an epoch
and an index give the same arrays in both packages.

Without the h5 files it falls back to synthetic "room" blocks whose labels
follow the height and the color, so that a segmenter has something to
learn.
"""

import os
import pathlib

import numpy as np

from cloud_transformers_tpu_torch.data import augment
from cloud_transformers_tpu_torch.data.loader import item_rng

CLASS_NAMES = ["ceiling", "floor", "wall", "beam", "column", "window", "door",
               "table", "chair", "sofa", "bookcase", "board", "clutter"]


def _rgb_to_hsv(rgb):
    """RGB -> HSV on [N, 3] arrays in [0, 1]."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        rc = (maxc - r) / np.maximum(delta, 1e-12)
        gc = (maxc - g) / np.maximum(delta, 1e-12)
        bc = (maxc - b) / np.maximum(delta, 1e-12)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], -1)


def _hsv_to_rgb(hsv):
    """HSV -> RGB on [N, 3] arrays in [0, 1]."""
    h, s, v = hsv[:, 0], hsv[:, 1], hsv[:, 2]
    i = np.floor(h * 6.0).astype(int)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = (i % 6)[:, None]
    return np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])


def hue_saturation_translation(colors, rng, hue_max=0.5, sat_max=0.2):
    """Shift the hue (cyclically) and the saturation (clipped) by one random
    amount each; colors in [0, 1]."""
    hsv = _rgb_to_hsv(colors)
    hsv[:, 0] = (hsv[:, 0] + (rng.rand() - 0.5) * 2 * hue_max) % 1.0
    hsv[:, 1] = np.clip(hsv[:, 1] + (rng.rand() - 0.5) * 2 * sat_max, 0, 1)
    return _hsv_to_rgb(hsv).astype(colors.dtype)


def _synthetic_blocks(n_items=64, n_points=4096, n_classes=13, seed=0):
    """-> (points [n_items, n_points, 9] float32, labels [n_items,
    n_points] int32): uniform xyz in the unit cube, the label the height's
    band, the color (label / C, 1 - label / C, noise)."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((n_items, n_points, 9), np.float32)
    labels = np.zeros((n_items, n_points), np.int32)
    for i in range(n_items):
        xyz = rng.rand(n_points, 3).astype(np.float32)
        lab = np.clip((xyz[:, 2] * n_classes).astype(np.int32), 0,
                      n_classes - 1)
        color = np.stack([lab / n_classes, 1 - lab / n_classes,
                          rng.rand(n_points)], -1).astype(np.float32)
        pts[i, :, :3] = xyz
        pts[i, :, 3:6] = color
        pts[i, :, 6:9] = xyz
        labels[i] = lab
    return pts, labels


class Indoor3DSemSeg:
    def __init__(self, data_dir=None, num_points=4096, train=True,
                 data_percent=1.0, aug=False, test_area="Area_5", seed=0,
                 synthetic_items=64, aug_elastic=False, aug_dropout=False):
        """``data_dir`` holds the h5 blocks and their two lists; without
        them, ``synthetic_items`` synthetic blocks.  ``aug`` (training
        only) switches the augmentations on, and ``aug_elastic`` /
        ``aug_dropout`` add elastic distortion and dropout to them.
        -> items {"pcd": [num_points, 6] float32, "label": [num_points]
        int32}."""
        self.num_points = num_points
        self.train = train
        self.aug = aug and train
        self.aug_elastic = aug_elastic and self.aug
        self.aug_dropout = aug_dropout and self.aug
        self.seed = seed
        self._epoch = 0
        if data_dir and os.path.exists(
                os.path.join(data_dir, "all_files.txt")):
            self.points, self.labels = self._load(pathlib.Path(data_dir),
                                                  test_area, train)
        else:
            self.points, self.labels = _synthetic_blocks(
                synthetic_items, max(num_points, 8), seed=0 if train else 1)
        self.data_percent = data_percent

    @staticmethod
    def _load(data_dir, test_area, train):
        """The blocks of every h5 file in ``all_files.txt``; a block is in
        the test split where its room (``room_filelist.txt``) names
        ``test_area``."""
        import h5py
        with open(data_dir / "all_files.txt") as fh:
            all_files = [line.rstrip() for line in fh]
        with open(data_dir / "room_filelist.txt") as fh:
            rooms = [line.rstrip() for line in fh]
        datas, labels = [], []
        for f in all_files:
            with h5py.File(data_dir / pathlib.Path(f).name, "r") as h:
                datas.append(h["data"][:])
                labels.append(h["label"][:])
        data = np.concatenate(datas, 0)
        label = np.concatenate(labels, 0)
        sel = [i for i, r in enumerate(rooms) if (test_area in r) != train]
        return data[sel].astype(np.float32), label[sel].astype(np.int32)

    def __len__(self):
        return int(self.points.shape[0] * self.data_percent)

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, idx):
        rng = item_rng(self.seed, self._epoch, idx)
        pt_idx = rng.permutation(self.points.shape[1])[:self.num_points]
        pts = self.points[idx, pt_idx, :6].copy()   # xyz + rgb
        lab = self.labels[idx, pt_idx].copy()
        if self.aug:
            pts[:, :3] = augment.rotate_z(pts[:, :3], rng)
            pts[:, :3] *= rng.uniform(0.8, 1.2, size=3).astype(np.float32)
            if rng.rand() < 0.5:   # x symmetry
                pts[:, 0] = -pts[:, 0]
            pts[:, :3] = augment.jitter(pts[:, :3], rng)
            pts[:, 3:6] = augment.chromatic_autocontrast(pts[:, 3:6], rng)
            pts[:, 3:6] = augment.chromatic_translation(pts[:, 3:6], rng,
                                                        ratio=0.10)
            pts[:, 3:6] = augment.chromatic_jitter(pts[:, 3:6], rng,
                                                   std=0.05)
            pts[:, 3:6] = hue_saturation_translation(pts[:, 3:6], rng)
            if self.aug_elastic:
                # a two-scale field, as the reference's parameters
                pts[:, :3] = augment.elastic_distortion(
                    pts[:, :3], 0.2, 0.4, rng)
                pts[:, :3] = augment.elastic_distortion(
                    pts[:, :3], 0.8, 1.6, rng)
            if self.aug_dropout:
                pts, lab = augment.random_dropout(pts, lab, rng)
        return {"pcd": pts.astype(np.float32), "label": lab.astype(np.int32)}
