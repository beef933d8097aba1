"""PyTorch + CUDA port of segmif_tpu (serving and the interactive
trainer), for NVIDIA Hopper.

Module names mirror ``segmif_tpu`` so each counterpart is easy to find:

 - ``ops.color`` / ``ops.image``: YCrCb conversions, bilinear resize,
   ImageNet normalisation (NHWC in, NHWC out).
 - ``kernels``: each CUDA kernel behind a ``torch.library`` operator
   (``torch.ops.segmif.*``, registered when ``kernels`` is imported)
   whose CPU version is the kernel's plain version.
 - ``kernels.attention``: MiT spatially-reduced attention; CUDA kernel
   ``kernels/csrc/sr_attention.cu`` on CUDA tensors, plain PyTorch on CPU.
 - ``kernels.ffm``: the folded CrossPath (feature-fusion module) as a
   grams pass and an apply pass, CUDA kernels in ``kernels/csrc/ffm.cu``;
   its bf16 backward as two more passes in ``kernels/csrc/ffm_bwd.cu``.
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
   ``quantize_for_serving``, on the card unless ``device="cpu"``, and
   the ``torch.export`` artifacts (``export_serving_artifact`` and its
   save / load / input specs).
 - ``train``: the fusion and seg steps, AdamW, the train states,
   checkpoints and ``InteractiveTrainer`` (the rounds of a fusion phase
   and a seg phase); ``losses``: the fusion losses, CE and DWA.
 - ``data``: the folder, MFNet, VOC and synthetic datasets, the ctypes
   binding of ``runtime/dataloader.cpp`` (``data.native``),
   ``Prefetcher``, ``iterate_eval`` and the batched device-side
   augmentation; ``train.streaming``: the disk-backed splits; ``eval``:
   the confusion matrix, the scores, the evaluator, the fused-PNG writer
   and the colormaps; ``parallel``: data parallelism and the
   row-sharded fusion trunk over ``torch.distributed`` (``dist``,
   ``mesh``, ``spatial``, ``dryrun``); ``config``: the config tree;
   ``cli``: ``train``,
   ``test_fusion``, ``test_segmentation``, ``convert_checkpoint``,
   ``stretch`` (the 1080p/mit_b5 path) and ``export``
   (``python -m segmif_tpu_torch.cli.<name>``); ``disk_check``: the
   checks of the disk-to-disk path that ``chip_smoke.py`` and the tests
   share; ``utils.determinism``: the deterministic mode of repeatable
   training on the card.

The package imports torch only; the CUDA kernels are compiled with nvcc at
first use (``kernels._build``).
"""
