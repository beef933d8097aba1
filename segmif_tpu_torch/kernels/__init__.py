"""The port's hand-written CUDA kernels, each behind a PyTorch operator
(``torch.ops.segmif.*``) whose CPU version is the kernel's plain version.

Importing this package registers the eleven operators: ``sr_attention``,
``sr_attention_bwd_dq``, ``sr_attention_bwd_dkv`` (its backward),
``ffm_grams``, ``ffm_apply``, ``ffm_bwd_reduce``, ``ffm_bwd_rows`` (the
FFM's backward), ``drdb_growth``, ``drdb_tail``, ``drdb_int8_growth`` and
``drdb_int8_tail``. A program exported with
``torch.export`` that calls them (``serving.export_serving_artifact``)
needs this import before it is loaded; the CUDA library is built at the
first launch (``_build``).
"""
from . import attention, drdb, ffm, int8  # noqa: F401 (registers the ops)
