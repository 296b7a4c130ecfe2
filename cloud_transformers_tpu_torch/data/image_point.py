"""Single-view reconstruction dataset (what3d renderings + PLY clouds).

Counterpart of ``cloud_transformers_tpu/data/image_point.py``, item for
item: the directory layout ``lists/<category>/<split>.txt``,
``renderings/<category>/<object>/*.png`` and
``points/<category>/<object>/<view>.ply``; images resized to ``im_size``
and normalised with the ImageNet mean and deviation, channel-last
``[H, W, 3]``; clouds resampled to exactly ``points`` with the item's own
``item_rng``.  PIL is imported only where a real image is read.

Without a dataset directory the items are synthetic, made from the item's
index: a blob cloud of five gaussians in [0, 1] and a flat image of their
mean colour.
"""

import os
from pathlib import Path

import numpy as np

from cloud_transformers_tpu_torch.data.loader import item_rng
from cloud_transformers_tpu_torch.data.pointcloud_io import read_ply

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resample_pcd(pcd, n, rng):
    """A permutation, then random duplicates, to exactly ``n`` points."""
    idx = rng.permutation(pcd.shape[0])
    if idx.shape[0] < n:
        idx = np.concatenate(
            [idx, rng.randint(pcd.shape[0], size=n - idx.shape[0])])
    return pcd[idx[:n]]


def load_image(path, im_size):
    """An RGB image file -> ``[im_size, im_size, 3]`` float32, bilinear
    resize, ImageNet normalisation."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    img = img.resize((im_size, im_size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


class ImageToPoint:
    """Items: ``image [H, W, 3]`` (normalised), ``pcd [P, 3]``,
    ``class_id []`` (int32)."""

    def __init__(self, d_path=None, split="train", im_size=128, points=4096,
                 seed=0, synthetic_items=32):
        self.split = split
        self.im_size = im_size
        self.points = points
        self.seed = seed
        self._epoch = 0
        self.data_pairs = []
        self.class_names = []

        if d_path and os.path.isdir(d_path):
            d = Path(d_path)
            for category in sorted((d / "lists").iterdir()):
                if not category.is_dir():
                    continue
                self.class_names.append(category.name)
                cls_id = len(self.class_names) - 1
                with open(category / f"{split}.txt") as fh:
                    objects = [line.strip() for line in fh]
                for object_id in objects:
                    im_obj = d / "renderings" / category.name / object_id
                    pt_obj = d / "points" / category.name / object_id
                    for img in sorted(im_obj.iterdir()):
                        if img.suffix == ".png":
                            self.data_pairs.append(
                                (img, pt_obj / (img.stem + ".ply"), cls_id))
        else:
            self.class_names = ["synthetic"]
            self.data_pairs = [(None, None, 0)] * synthetic_items

    def __len__(self):
        return len(self.data_pairs)

    def _synthetic(self, index):
        srng = np.random.RandomState(index)
        centers = srng.rand(5, 3) * 0.8 + 0.1
        assign = srng.randint(0, 5, self.points)
        pcd = np.clip(centers[assign]
                      + srng.randn(self.points, 3) * 0.03, 0, 1)
        img = np.tile(centers.mean(0)[None, None],
                      (self.im_size, self.im_size, 1))
        img = (img - IMAGENET_MEAN) / IMAGENET_STD
        return img.astype(np.float32), pcd.astype(np.float32)

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, index):
        img_path, pcd_path, cls_id = self.data_pairs[index]
        if img_path is None:
            img, pcd = self._synthetic(index)
        else:
            img = load_image(img_path, self.im_size)
            pcd = resample_pcd(read_ply(pcd_path), self.points,
                               item_rng(self.seed, self._epoch, index))
        return {"image": img.astype(np.float32),
                "pcd": pcd.astype(np.float32),
                "class_id": np.int32(cls_id)}
