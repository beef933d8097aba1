"""Evaluation (counterpart of ``segmif_tpu/eval``): the confusion matrix
and scores, and the three evaluator functions the interactive trainer
calls. The PNG writer, ``visual.py`` and ``accuracy.py`` are not ported
yet."""
