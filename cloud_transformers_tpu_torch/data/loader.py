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
draws from its own ``item_rng``.  Spans (``utils/trace.py``): a batch's
build is ``loader.build`` on the thread that builds it, the consumer's wait
for the next batch is ``loader.next``, and ``loader.ready`` counts the
batches already built each time the consumer asks.

Across processes (``process_index`` of ``process_count``), as in the JAX
loader, every process shuffles the same index sequence and process p takes
the contiguous rows [p*bs, (p+1)*bs) of global batch b (bs is the
per-process ``batch_size``), so a run over N processes sees, step for
step, the single-process run's batches of N*bs; ``len`` counts global
batches.  At one process the batches are those of the single-process
loader.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from cloud_transformers_tpu_torch.utils import trace


def item_rng(seed, epoch, index):
    """Deterministic per-(epoch, item) RandomState: reproducible across
    runs, whatever order the items are built in."""
    return np.random.RandomState(
        (seed * 1000003 + epoch * 7919 + index * 31 + 1) % (2 ** 31 - 1))


class DataLoader:
    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=True, num_workers=0, process_index=0,
                 process_count=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        self.prefetch = max(2, num_workers)

    def set_epoch(self, epoch):
        """Reseed the shuffle (and the dataset's augmentation) per epoch."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def global_batch_size(self):
        return self.batch_size * self.process_count

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.global_batch_size
        return -(-len(self.dataset) // self.global_batch_size)

    def _indices(self):
        """The shuffled index sequence, the same on every process, padded
        to whole global batches by its own head unless the last partial
        batch is dropped."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if not self.drop_last:
            gbs = self.global_batch_size
            per = -(-n // gbs) * gbs
            idx = np.concatenate([idx, idx[:per - n]])
        return idx

    def _build_batch(self, idx, b):
        """This process's rows of global batch ``b``."""
        base = (b * self.process_count + self.process_index) * \
            self.batch_size
        sel = idx[base:base + self.batch_size]
        with trace.span("loader.build"):
            items = [self.dataset[int(i)] for i in sel]
            return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self):
        idx = self._indices()
        nb = len(idx) // self.global_batch_size
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
                trace.count("loader.ready",
                            sum(f.done() for f in futs.values()))
                with trace.span("loader.next"):
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
                trace.count("loader.ready", q.qsize())
                with trace.span("loader.next"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
