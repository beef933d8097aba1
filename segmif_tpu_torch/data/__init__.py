"""Data for the interactive trainer and the CLIs (counterpart of
``segmif_tpu/data``): the folder, MFNet, VOC and synthetic datasets
(``datasets``), the ctypes binding of the native C++ decoder and batch
loader (``native``), the ``Prefetcher`` and ``iterate_eval`` (numpy on
the host) and the batched augmentation (``augment``, torch, on the
device)."""
