"""Minimal host-side data loader: shuffling and batching in one process.

Counterpart of ``cloud_transformers_tpu/data/loader.py`` for one process and
one device: datasets are map-style (``__len__`` / ``__getitem__`` returning
a dict of numpy arrays), batches are stacked numpy dicts, and for the same
seed and epoch the items come in the same order as in the JAX package.  Its
worker threads, prefetch queue and per-host sharding are not ported.
"""

import numpy as np


def item_rng(seed, epoch, index):
    """Deterministic per-(epoch, item) RandomState: reproducible across
    runs, whatever order the items are built in."""
    return np.random.RandomState(
        (seed * 1000003 + epoch * 7919 + index * 31 + 1) % (2 ** 31 - 1))


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch):
        """Reseed the shuffle (and the dataset's augmentation) per epoch."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _indices(self):
        """The shuffled index sequence, padded to whole batches by its own
        head unless the last partial batch is dropped."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if not self.drop_last:
            per = -(-n // self.batch_size) * self.batch_size
            idx = np.concatenate([idx, idx[:per - n]])
        return idx

    def __iter__(self):
        idx = self._indices()
        for b in range(len(idx) // self.batch_size):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            items = [self.dataset[int(i)] for i in sel]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}
