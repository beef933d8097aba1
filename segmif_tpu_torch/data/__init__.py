"""Data for the interactive trainer (counterpart of ``segmif_tpu/data``):
the synthetic dataset, the threaded ``Prefetcher`` and ``iterate_eval``
(numpy on the host) and the batched augmentation (torch, on the device).
The folder datasets, the MFNet and VOC datasets and the native loader are
not ported yet."""
