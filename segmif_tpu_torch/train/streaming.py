"""Disk-backed splits for the interactive trainer (counterpart of
``segmif_tpu/train/streaming.py``; ``TrainConfig.streaming``).

The default trainer stacks whole splits into host RAM as uint8
(``interactive._stack_dataset``). ``StreamingFusionData`` keeps the folder
dataset on disk instead: the ``Prefetcher``'s readers (the native C++
loader or Python threads) decode per batch, and the regenerated fused
images, the one array the trainer must own across the phases, live in a
uint8 ``np.memmap`` under the checkpoint dir (``fused_<tag>.u8``), which
the OS pages in on demand. A memmap left by a run of another geometry is
recreated. The trainer's writer fills a new memmap under a temporary name
(``begin_fused``) and renames it into place (``commit_fused``); the other
ranks then open the file afresh (``ensure_fused(write=False)``), so no
reader sees a half-written file.

It speaks the protocol of ``interactive.InMemoryFusionDataset`` where the
trainer needs it: ``__len__`` / ``__getitem__`` (the 5-tuple with the
STATIC guide, what the fusion phase trains on), ``seg_view()`` (the
5-tuple with the regenerated fused image in slot 3, what the seg phase
trains on and the mIoU eval reads) and ``sample_paths()``, passed through
so that the native loader can own the decode.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np


class StreamingFusionData:
    """A folder dataset whose regenerated fused images live in a disk
    memmap. ``dataset`` yields (name, ir, vis, guide, label) of one image
    shape."""

    def __init__(self, dataset, cache_dir: str | Path, tag: str = "train"):
        self.ds = dataset
        self.names = list(getattr(dataset, "names",
                                  [dataset[i][0] for i in range(len(dataset))]))
        self.cache_path = Path(cache_dir) / f"fused_{tag}.u8"
        self._fused = None
        self._tmp = None   # begin_fused's file until commit_fused

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int):
        return self.ds[i]

    def sample_paths(self):
        fn = getattr(self.ds, "sample_paths", None)
        if fn is None:
            raise AttributeError("underlying dataset has no sample_paths")
        return fn()

    def ensure_fused(self, h: int, w: int, write: bool = True) -> np.memmap:
        """The [N, h, w, 3] uint8 memmap of the latest regenerated fused
        images, created on first use (the writer flushes it). ``write``
        False opens the file another process wrote, read-only, afresh
        (``commit_fused`` put a new file in place)."""
        if not write:
            self._fused = np.memmap(self.cache_path, dtype=np.uint8,
                                    mode="r", shape=(len(self), h, w, 3))
        if self._fused is None:
            self.cache_path.parent.mkdir(parents=True, exist_ok=True)
            mode = "r+" if self.cache_path.exists() else "w+"
            try:
                self._fused = np.memmap(self.cache_path, dtype=np.uint8,
                                        mode=mode,
                                        shape=(len(self), h, w, 3))
            except ValueError:   # a file of another geometry: recreate
                self._fused = np.memmap(self.cache_path, dtype=np.uint8,
                                        mode="w+",
                                        shape=(len(self), h, w, 3))
        return self._fused

    def begin_fused(self, h: int, w: int) -> np.memmap:
        """A new [N, h, w, 3] uint8 memmap under a temporary name beside
        the cache file, for the writer to fill; ``commit_fused`` puts it in
        place."""
        self.cache_path.parent.mkdir(parents=True, exist_ok=True)
        self._tmp = self.cache_path.with_name(
            f"{self.cache_path.name}.tmp{os.getpid()}")
        self._fused = np.memmap(self._tmp, dtype=np.uint8, mode="w+",
                                shape=(len(self), h, w, 3))
        return self._fused

    def commit_fused(self) -> None:
        """Flush ``begin_fused``'s memmap and rename it to the cache
        file."""
        self._fused.flush()
        os.replace(self._tmp, self.cache_path)

    @property
    def fused(self):
        if self._fused is None:
            raise RuntimeError(
                "fused images not generated yet: run regenerate_fused "
                "(InteractiveTrainer.run always runs it before the seg "
                "phase)")
        return self._fused

    def seg_view(self) -> "_StreamingSegView":
        return _StreamingSegView(self)


class _StreamingSegView:
    """The 5-tuple with slot 3 the regenerated fused image (a memmap row),
    as ``interactive._SegPhaseView``."""

    def __init__(self, base: StreamingFusionData):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i: int):
        n, ir, vis, _, label = self.base.ds[i]
        return n, ir, vis, np.asarray(self.base.fused[i]), label
