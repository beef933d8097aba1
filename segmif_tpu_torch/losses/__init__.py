"""Training losses (counterpart of ``segmif_tpu/losses``): the two
fusion losses the interactive schedule uses, cross-entropy with an ignore
label, and the on-device DWA weighting."""
