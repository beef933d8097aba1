"""Command-line entry points of the port (counterpart of
``segmif_tpu/cli``): ``train``."""
