"""PyTorch + CUDA port of the segmif_tpu serving path, for NVIDIA Hopper.

Module names mirror ``segmif_tpu`` so each counterpart is easy to find:

 - ``ops.color`` / ``ops.image``: YCrCb conversions, bilinear resize,
   ImageNet normalisation (NHWC in, NHWC out).
 - ``kernels.attention``: MiT spatially-reduced attention; CUDA kernel
   ``kernels/csrc/sr_attention.cu`` on CUDA tensors, plain PyTorch on CPU.
 - ``kernels.ffm``: the folded CrossPath (feature-fusion module) as a
   grams pass and an apply pass, CUDA kernels in ``kernels/csrc/ffm.cu``.
 - ``kernels.drdb``: the dilated residual dense block; CUDA kernels
   ``kernels/csrc/drdb.cu`` (growth chain, concat-free tail).
 - ``kernels.int8``: the calibrated int8 DRDB for serving (quantisers,
   weight packing, the plain version); CUDA kernels
   ``kernels/csrc/drdb_int8.cu`` (entry quantise, int8 growth convs, tail).
 - ``models``: MiT encoder, SegFormer head, fusion network (DRDB quant
   modes "none" | "calibrate" | "int8"), and the joint fuse-then-segment
   pipeline, with the reference PyTorch state-dict keys.
 - ``convert``: JAX ``JointPipeline`` variables (numpy) -> ``state_dict``,
   and the JAX calibration amaxes onto the DRDBs.
 - ``serving``: ``make_serving_fn`` / ``precompute_guide_taps`` /
   ``quantize_for_serving``, on the card unless ``device="cpu"``.

The package imports torch only; the CUDA kernels are compiled with nvcc at
first use (``kernels._build``).
"""
