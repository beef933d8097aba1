"""Host input pipeline (counterpart of ``segmif_tpu/data/pipeline.py``):
a prefetcher of shuffled batches and the eval iterator, numpy on the host.
Augmentation happens on the device afterwards (``data.augment``), so the
host only reads and stacks.

The ``Prefetcher`` reads through one of two readers, and says which in
one log line:
 - the native C++ loader (``data.native.NativeLoader``) when the dataset
   offers ``sample_paths()`` and ``use_native`` is set: decode on native
   threads, the shuffle order the C++ runtime's;
 - Python threads calling ``dataset[i]`` otherwise, in the epoch order
   ``np.random.default_rng([seed, e]).permutation``.
Unlike the JAX package, a native loader that was asked for and cannot run
raises; it never falls back to the Python readers.

Several hosts (``shard_by_process``, the JAX package's name and default):
host h of P (``parallel.dist.host_layout``, the counterpart of
``jax.process_index()`` / ``process_count()``) takes the names
``idx[h::P]``, and only those: the Python readers permute them in the
epoch order above (an epoch is one pass over the host's names, and
``start_batch`` counts the host's batches), and the native loader is
handed only their paths. The caller asks each host for its share of the
global batch (``parallel.mesh``: B/P rows a host, the global batch the
hosts' batches concatenated). Under data parallelism the ranks of one
host read the same batches, in the same order, and keep their rows.
"""
from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from ..parallel.dist import host_layout


class Prefetcher:
    """Infinite shuffled batch iterator with background reader threads.

    Yields dicts of stacked numpy arrays, in the dataset's dtypes:
      {'ir': [B,H,W,3], 'vis': [B,H,W,3], 'guide': [B,H,W,3],
       'label': [B,H,W] int32}.
    Samples must share one shape. On the Python readers the epoch-e order
    is ``np.random.default_rng([seed, e]).permutation``, the JAX
    package's, and the last partial batch of an epoch is dropped. The
    native loader's batches are uint8 images (its float32 output holds
    integers in [0, 255]) and an int32 label from the label file's first
    channel.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_threads: int = 4, prefetch_depth: int = 4,
                 shard_by_process: bool = True, loop: bool = True,
                 use_native: bool = True, start_batch: int = 0):
        """start_batch fast-forwards the deterministic batch sequence: batch
        k of a Prefetcher(seed=s, start_batch=k) is batch k of
        Prefetcher(seed=s, start_batch=0), which is how a resumed phase
        replays the uninterrupted data order. It takes the Python readers
        (the native loader's order lives in C++ and cannot be replayed).

        shard_by_process: on several hosts read host h's names
        ``idx[h::P]`` only (``host_layout``); ``batch_size`` is then the
        host's batch. use_native: read through the native loader when the
        dataset offers ``sample_paths()`` (and ``loop``); raises
        ``RuntimeError`` if the native library did not build or the loader
        cannot be created."""
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.start_batch = start_batch
        self.loop = loop
        self.indices = np.arange(len(dataset))
        host, hosts = host_layout() if shard_by_process else (0, 1)
        if hosts > 1:
            self.indices = self.indices[host::hosts]
        self._native = None
        paths = self._sample_paths() if (use_native and loop
                                         and not start_batch) else None
        log = logging.getLogger("segmif_tpu_torch")
        if paths is not None:
            paths = [paths[i] for i in self.indices]
            self._native = self._open_native(paths, num_threads,
                                             prefetch_depth, seed)
            log.info("Prefetcher: native C++ loader, %d threads, %d samples"
                     " in batches of %d (C++ shuffle, seed %d)", num_threads,
                     len(paths), batch_size, seed + 1)
            return
        log.info("Prefetcher: Python reader threads (%d), %d samples in "
                 "batches of %d (seed %d, from batch %d)", num_threads,
                 len(self.indices), batch_size, seed, start_batch)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _sample_paths(self):
        """The dataset's per-sample (ir, vis, guide, label) paths, or None
        if it offers none."""
        fn = getattr(self.ds, "sample_paths", None)
        try:
            paths = fn() if fn is not None else None
        except AttributeError:   # a wrapper over a dataset without paths
            return None
        return paths if paths and len(paths[0]) == 4 else None

    def _open_native(self, paths, num_threads, prefetch_depth, seed):
        from . import native

        try:
            h, w, _ = native.probe_image(paths[0][0])
            return native.NativeLoader(
                paths, self.batch_size, (h, w), channels=3,
                num_threads=num_threads, queue_depth=prefetch_depth,
                seed=seed + 1, resize=False)
        except (native.NativeUnavailable, IOError) as e:
            raise RuntimeError(
                f"Prefetcher: the native loader was asked for "
                f"(use_native=True) and cannot run: {e}; pass "
                f"use_native=False to read through Python threads") from e

    def _load_batch(self, batch_idx) -> dict:
        samples = list(self._pool.map(self.ds.__getitem__, batch_idx))
        _, irs, viss, guides, labels = zip(*samples)
        return {"ir": np.stack(irs), "vis": np.stack(viss),
                "guide": np.stack(guides),
                "label": np.stack(labels).astype(np.int32)}

    def _producer(self):
        """Read batches into the queue; an error in a read is queued too,
        and the consumer raises it."""
        try:
            self._produce()
        except Exception as e:   # noqa: BLE001 (handed to the consumer)
            self._put(e)

    def _produce(self):
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
        if self._native is not None:
            for arr in self._native:   # [B, 4, H, W, 3] f32 in [0, 255]
                u8 = arr[:, :3].astype(np.uint8)
                yield {"ir": np.ascontiguousarray(u8[:, 0]),
                       "vis": np.ascontiguousarray(u8[:, 1]),
                       "guide": np.ascontiguousarray(u8[:, 2]),
                       "label": arr[:, 3, :, :, 0].astype(np.int32)}
            return
        while True:
            item = self._q.get()
            if isinstance(item, Exception):
                raise RuntimeError("Prefetcher: a reader thread "
                                   "failed") from item
            if item is None:
                return
            yield item

    def close(self):
        """Stop the reader threads and wait for them."""
        if self._native is not None:
            self._native.close()
            return
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
