"""PyTorch + CUDA port of the segmif_tpu serving path, for NVIDIA Hopper.

Module names mirror ``segmif_tpu`` so each counterpart is easy to find:

 - ``ops.color`` / ``ops.image``: YCrCb conversions, bilinear resize,
   ImageNet normalisation (NHWC in, NHWC out).
 - ``kernels.attention``: MiT spatially-reduced attention; CUDA kernel
   ``kernels/csrc/sr_attention.cu`` on CUDA tensors, plain PyTorch on CPU.
 - ``kernels.ffm``: the folded CrossPath (feature-fusion module) as a
   grams pass and an apply pass, CUDA kernels in ``kernels/csrc/ffm.cu``.
 - ``kernels.drdb``: the dilated residual dense block (plain convs).
 - ``models``: MiT encoder, SegFormer head, fusion network, and the joint
   fuse-then-segment pipeline, with the reference PyTorch state-dict keys.
 - ``convert``: JAX ``JointPipeline`` variables (numpy) -> ``state_dict``.
 - ``serving``: ``make_serving_fn`` / ``precompute_guide_taps``.

The package imports torch only; the CUDA kernels are compiled with nvcc at
first use (``kernels._build``).
"""
