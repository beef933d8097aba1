"""Fusion-phase training (counterpart of ``segmif_tpu/train``): the
poly-warmup AdamW, the train state and ``make_fusion_train_step``."""
