"""Minimal host-side data loader: shuffling, batching and prefetch.

Counterpart of ``cloud_transformers_tpu/data/loader.py`` for one process and
one device: datasets are map-style (``__len__`` / ``__getitem__`` returning
a dict of numpy arrays), batches are stacked numpy dicts, and for the same
seed and epoch the items come in the same order as in the JAX package.

Batches are built off the consumer's thread: with ``num_workers > 1`` by a
thread pool with a bounded window of batches in flight (numpy releases the
GIL in the augmentation math, so threads overlap), otherwise by one
producer thread that keeps up to ``prefetch`` batches in a queue.  Either
way the batches and their order do not depend on ``num_workers``: each item
draws from its own ``item_rng``.  The JAX loader's per-process index
sharding is not ported (one process).
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def item_rng(seed, epoch, index):
    """Deterministic per-(epoch, item) RandomState: reproducible across
    runs, whatever order the items are built in."""
    return np.random.RandomState(
        (seed * 1000003 + epoch * 7919 + index * 31 + 1) % (2 ** 31 - 1))


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=True, num_workers=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.num_workers = num_workers
        self.prefetch = max(2, num_workers)

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

    def _build_batch(self, idx, b):
        sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
        items = [self.dataset[int(i)] for i in sel]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self):
        idx = self._indices()
        nb = len(idx) // self.batch_size
        if self.num_workers > 1:
            yield from self._pooled(idx, nb)
        else:
            yield from self._queued(idx, nb)

    def _pooled(self, idx, nb):
        """Concurrent batch builders, at most ``num_workers + prefetch``
        batches in flight; the rest are cancelled if the consumer stops."""
        window = self.num_workers + self.prefetch
        ex = ThreadPoolExecutor(self.num_workers)
        try:
            futs = {b: ex.submit(self._build_batch, idx, b)
                    for b in range(min(window, nb))}
            for b in range(nb):
                batch = futs.pop(b).result()
                if b + window < nb:
                    futs[b + window] = ex.submit(self._build_batch, idx,
                                                 b + window)
                yield batch
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    def _queued(self, idx, nb):
        """One producer thread, ``prefetch`` batches ahead; it stops when
        the consumer does."""
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in range(nb):
                    if not put(self._build_batch(idx, b)):
                        return
            except Exception as e:   # raised in the consumer's thread
                put(e)
                return
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
