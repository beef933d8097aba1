"""Evaluation (counterpart of ``segmif_tpu/eval``): the confusion matrix
and scores (``metrics``), the evaluator functions the trainer and the
CLIs call (``evaluator``), the fused-PNG writer and reader
(``image_io``) and the colormaps and grids (``visual``). ``accuracy.py``
is not ported yet."""
