"""ScanObjectNN classification dataset (h5 with per-point instance masks).

Counterpart of ``cloud_transformers_tpu/data/scanobjectnn.py``.  Items are
dicts of numpy arrays, channel-last: ``pcd [P, 3]``, ``label []``,
``mask [P]`` (binary foreground mask; -1 background -> 0).

When the h5 file is absent a deterministic synthetic set is generated, the
same clouds as the JAX package makes, so the whole pipeline runs on a
machine without the dataset.  The constructor is the ``setup.data`` span
(``utils/trace.py``).
"""

import os

import numpy as np

from cloud_transformers_tpu_torch.data import augment
from cloud_transformers_tpu_torch.data.loader import item_rng
from cloud_transformers_tpu_torch.utils import trace


def _load_h5(path):
    import h5py
    with h5py.File(path, "r") as f:
        data = f["data"][:]
        label = f["label"][:]
        mask = f["mask"][:]
    return (data.astype(np.float32), label.astype(np.int32),
            (mask != -1).astype(np.float32))


def _synthetic(n_items=256, n_points=2048, n_classes=15, seed=0):
    """Class-dependent gaussian blob mixtures: enough structure for the
    loss to fall and the accuracy to climb."""
    rng = np.random.RandomState(seed)
    data = np.zeros((n_items, n_points, 3), np.float32)
    label = rng.randint(0, n_classes, size=n_items).astype(np.int32)
    mask = np.zeros((n_items, n_points), np.float32)
    for i in range(n_items):
        centers = np.random.RandomState(label[i]).randn(4, 3) * 0.5
        assign = rng.randint(0, 4, n_points)
        data[i] = centers[assign] + rng.randn(n_points, 3) * 0.1
        mask[i] = (assign < 2).astype(np.float32)
    return data, label, mask


class ScanObjectNN:
    def __init__(self, path=None, center=True, normalize=True, train=False,
                 subsample=None, seed=0, synthetic_items=256,
                 num_points=2048):
        with trace.span("setup.data"):
            if path and os.path.exists(path):
                self.data, self.label, self.mask = _load_h5(path)
            else:
                self.data, self.label, self.mask = _synthetic(
                    synthetic_items, num_points, seed=0)
            if center:
                self.data = np.stack([augment.center(p) for p in self.data])
            if normalize:
                self.data = np.stack(
                    [augment.normalize_unit_sphere(p) for p in self.data])
        self.train = train
        self.subsample = subsample
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        return self.data.shape[0]

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, item):
        pcd = self.data[item]
        mask = self.mask[item]
        # one advancing per-(epoch, item) stream for all draws
        rng = item_rng(self.seed, self._epoch, item)
        if self.train:
            pcd = augment.jitter(pcd, rng)
            pcd = augment.rotate_y(pcd, rng)
        if self.subsample is not None:
            idx = rng.choice(pcd.shape[0], size=self.subsample,
                             replace=False)
            pcd, mask = pcd[idx], mask[idx]
        return {"pcd": pcd.astype(np.float32),
                "label": self.label[item],
                "mask": mask.astype(np.float32)}
