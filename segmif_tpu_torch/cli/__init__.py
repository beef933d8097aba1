"""Command-line entry points of the port (counterpart of
``segmif_tpu/cli``): ``train``, ``test_fusion``, ``test_segmentation`` and
``convert_checkpoint`` (a key check)."""
