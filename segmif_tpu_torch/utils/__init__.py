"""Helpers of the port (counterpart of ``segmif_tpu/utils``)."""
