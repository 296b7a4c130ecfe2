"""ShapeNet completion dataset (GRNet protocol).

Counterpart of ``cloud_transformers_tpu/data/completion.py``, value for
value: a JSON category index, ``partial_path``/``gt_path`` printf templates
pointing at .pcd/.h5 files, ``n_renders`` partial views per model at train
time, ``random_sample_points`` (permute, truncate, zero-pad: the padding is
what ``partial_postprocess`` strips later) and ``random_mirror``; h5 ground
truth is scaled by 0.9.

Without a category index the items are synthetic: half-space views of
gaussian-mixture shapes, made from the item's index.
"""

import json
import os

import numpy as np

from cloud_transformers_tpu_torch.data.loader import item_rng
from cloud_transformers_tpu_torch.data.pointcloud_io import read_pcd


def random_sample_points(pcd, n, rng):
    """Permute + truncate + zero-pad to ``n`` points."""
    choice = rng.permutation(pcd.shape[0])
    pcd = pcd[choice[:n]]
    if pcd.shape[0] < n:
        pcd = np.concatenate(
            [pcd, np.zeros((n - pcd.shape[0], 3), pcd.dtype)])
    return pcd.astype(np.float32)


def random_mirror(pcd, rnd_value):
    """Mirror about x and/or z by quartile of one shared uniform draw."""
    m = np.eye(3, dtype=pcd.dtype)
    if rnd_value <= 0.25:
        m[0, 0] = -1
        m[2, 2] = -1
    elif rnd_value <= 0.5:
        m[0, 0] = -1
    elif rnd_value <= 0.75:
        m[2, 2] = -1
    return pcd @ m.T


def _synthetic_pair(rng, n_partial_raw=2048, seed_shape=0):
    srng = np.random.RandomState(seed_shape)
    centers = srng.randn(6, 3) * 0.25
    assign = rng.randint(0, 6, 16384)
    full = (centers[assign]
            + rng.randn(16384, 3).astype(np.float32) * 0.05)
    full = np.clip(full, -0.5, 0.5).astype(np.float32)
    # partial: half-space view
    d = rng.randn(3)
    d /= np.linalg.norm(d)
    side = full @ d > 0
    partial = full[side][:n_partial_raw]
    return partial.astype(np.float32), full


class ShapeNetCompletion:
    """Items: ``partial [n_input, 3]`` (zero-padded), ``gt [n_output, 3]``,
    ``taxonomy`` (int32)."""

    def __init__(self, category_path=None, partial_path=None, gt_path=None,
                 split="train", n_renders=8, n_input=2048, n_output=16384,
                 seed=0, synthetic_items=32):
        self.split = split
        self.n_input = n_input
        self.n_output = n_output
        self.n_renders = n_renders if split == "train" else 1
        self.seed = seed
        self._epoch = 0
        self.partial_path = partial_path
        self.gt_path = gt_path
        self.file_list = []
        if category_path and os.path.exists(category_path):
            with open(category_path) as f:
                categories = json.load(f)
            for cat in categories:
                tid = cat["taxonomy_id"]
                for mid in cat[split]:
                    for r in range(self.n_renders):
                        self.file_list.append((tid, mid, r))
        else:
            self.file_list = [("synthetic", str(i), r)
                              for i in range(synthetic_items)
                              for r in range(self.n_renders)]

    def __len__(self):
        return len(self.file_list)

    def _load(self, tid, mid, render):
        if tid == "synthetic":
            return _synthetic_pair(
                np.random.RandomState(int(mid) * 97 + render),
                seed_shape=int(mid))
        partial = read_pcd(self.partial_path % (self.split, tid, mid, render))
        gt_file = self.gt_path % (self.split, tid, mid)
        if gt_file.endswith(".h5"):
            import h5py
            with h5py.File(gt_file, "r") as f:
                gt = f["data"][()] * 0.9  # avoid gridding overflow
        else:
            gt = read_pcd(gt_file)
        return partial.astype(np.float32), gt.astype(np.float32)

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __getitem__(self, idx):
        tid, mid, render = self.file_list[idx]
        partial, gt = self._load(tid, mid, render)
        rng = item_rng(self.seed, self._epoch, idx)
        partial = random_sample_points(partial, self.n_input, rng)
        gt = random_sample_points(gt, self.n_output, rng)
        if self.split == "train":
            rv = rng.uniform()
            partial = random_mirror(partial, rv)
            gt = random_mirror(gt, rv)
        return {"partial": partial, "gt": gt,
                "taxonomy": np.int32(hash(tid) % (2 ** 31))}
