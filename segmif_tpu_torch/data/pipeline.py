"""Host input pipeline (counterpart of ``segmif_tpu/data/pipeline.py``):
a threaded prefetcher of shuffled batches and the eval iterator, numpy on
the host. Augmentation happens on the device afterwards
(``data.augment``), so the host only reads and stacks.

Not ported: the native C++ loader path and the per-process sharding (the
port trains in one process).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


class Prefetcher:
    """Infinite shuffled batch iterator with background reader threads.

    Yields dicts of stacked numpy arrays, in the dataset's dtypes:
      {'ir': [B,H,W,3], 'vis': [B,H,W,3], 'guide': [B,H,W,3],
       'label': [B,H,W] int32}.
    Samples must share one shape. The epoch-e order is
    ``np.random.default_rng([seed, e]).permutation``, the JAX package's,
    and the last partial batch of an epoch is dropped.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_threads: int = 4, prefetch_depth: int = 4,
                 loop: bool = True, start_batch: int = 0):
        """start_batch fast-forwards the deterministic batch sequence: batch
        k of a Prefetcher(seed=s, start_batch=k) is batch k of
        Prefetcher(seed=s, start_batch=0), which is how a resumed phase
        replays the uninterrupted data order."""
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.start_batch = start_batch
        self.loop = loop
        self.indices = np.arange(len(dataset))
        self._q: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _load_batch(self, batch_idx) -> dict:
        samples = list(self._pool.map(self.ds.__getitem__, batch_idx))
        _, irs, viss, guides, labels = zip(*samples)
        return {"ir": np.stack(irs), "vis": np.stack(viss),
                "guide": np.stack(guides),
                "label": np.stack(labels).astype(np.int32)}

    def _producer(self):
        nb_per_epoch = max(len(self.indices) // self.batch_size, 1)
        epoch = self.start_batch // nb_per_epoch
        skip = self.start_batch % nb_per_epoch
        while not self._stop.is_set():
            order = np.random.default_rng(
                [self.seed, epoch]).permutation(self.indices)
            for b in range(skip, len(order) // self.batch_size):
                if self._stop.is_set():
                    return
                self._put(self._load_batch(
                    order[b * self.batch_size:(b + 1) * self.batch_size]))
            skip = 0
            epoch += 1
            if not self.loop:
                self._put(None)
                return

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        """Stop the reader thread and wait for it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
        self._pool.shutdown(wait=True)


def iterate_eval(dataset, batch_size: int = 1, num_threads: int = 4,
                 prefetch_depth: int = 2):
    """Eval iterator yielding (names, true_count, arrays) with background
    reads, so the host's reading overlaps the device. Pads the final
    partial batch by repeating the last sample and reports the true
    count."""
    n = len(dataset)

    def load(start):
        idxs = list(range(start, min(start + batch_size, n)))
        true_count = len(idxs)
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        samples = [dataset[i] for i in idxs]
        names = [s[0] for s in samples]
        arrays = list(zip(*[s[1:] for s in samples]))
        stacked = [np.stack(a) if a[0] is not None else None for a in arrays]
        return names[:true_count], true_count, stacked

    starts = list(range(0, n, batch_size))
    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        pending = [ex.submit(load, s) for s in starts[:prefetch_depth]]
        nxt = prefetch_depth
        while pending:
            fut = pending.pop(0)
            if nxt < len(starts):
                pending.append(ex.submit(load, starts[nxt]))
                nxt += 1
            yield fut.result()
