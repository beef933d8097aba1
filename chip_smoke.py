#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

or phases 1-3, 13 and 14 alone: on one card as in the whole run, and on
a host with several cards phase 13 (a), (c)-(f) and phase 14
with one rank per card, over NCCL:

    python3 chip_smoke.py --parallel

Phases (each prints its lines and its seconds; any failure exits non-zero
before the last line; the CPU references of phases 6, 8 (a), 9 (a), 11 (b)
and 12 (c) are computed in a spawned process of their own from phase 4 on,
``CpuReferences``; phases 11 (a), 12 (a), (b) and (d), which time the
card, run first, then 12 (e)'s child and the export's fresh process beside
the untimed 11 (b)-(e) and 12 (c)):
 1. refuse to run without a CUDA device;
 2. print the card's name and power limit (nvidia-smi);
 3. build the hand-written kernels from segmif_tpu_torch/kernels/csrc
    (nvcc, sm_90a) and print the build time;
 4. hold each kernel against its plain PyTorch version at the main-path
    shapes (mit_b3, 480x640, batch 8) in f32 and bf16, and time both on
    the device (held by a sleep kernel while the host enqueues the timed
    calls), with each kernel's bound (the larger of its operations over the
    card's peak for their type and its bytes over the memory rate; the f32
    sr-attention, DRDB growth, DRDB tail, FFM grams and FFM apply, 3xTF32
    on the tensor cores, also with the 3xTF32 bound, 3 x their operations
    at the TF32 peak) and, for sr-attention, the time of
    ``F.scaled_dot_product_attention`` on the same inputs laid out [B, H,
    N, D] and, for information, SDPA's own f32 error against the plain
    version; sr-attention and FFM apply held per element, with planted
    faults (scale x 1.01, the last key row dropped; be zeroed, M1 and M3
    swapped, LayerNorm gamma + 0.01, in both dtypes; in f32 Q, or the
    apply's s, rounded to TF32, which is what a dropped small*big product
    gives) that must fail those checks, two f32 calls bit for bit, and f32
    and bf16 sr-attention at the 1080p stage-1 shape (M = 1980) beside
    SDPA; FFM apply also at B = 8 with N = 1, 40 and 4097 in both dtypes,
    grams (f32 against the plain maths summed in f64) at N = 1 and 40 in
    both dtypes, with planted faults in both (y1's bias zeroed, y1 and y2
    swapped; in f32 also W rounded to TF32, the projection's dropped
    small*big product); the DRDB growth chain, tail and whole block
    (against ``drdb_chain``), held per element, also at an odd 100x172,
    with the block's peak device memory, the growth's five-launch traffic
    floor and cuDNN's five convs on prebuilt concatenations beside it, one 1x1
    conv on a prebuilt concatenation beside the tail (f32 and bf16),
    growth and tail in f32 and bf16 at 17x33, 5x7 and on a channel slice
    of x, the f32 growth twice bit for bit and run on x rounded to TF32
    (conv 1's small*big product dropped), the f32 tail on r1..r5 and on
    its bottleneck rounded to TF32, each of which must fail; the int8 DRDB
    kernels held bit for bit against ``drdb_int8_ref`` (the int8 buffer
    and the output) at the main-path shape, 100x172 and 5x7, with the
    int8 block's peak memory; at 100x172, faults planted in the DRDB
    kernels' arguments (dropped biases, swapped conv taps, a zeroed weight
    chunk, two growth slices swapped at the tail, a wrong requant scale)
    must fail those checks; the FFM's bf16 backward kernels (pass A',
    pass B' and the whole backward) at [8, 307200, 64] and the trainer's
    [2, 102400, 64] against the plain VJP (dyadic tokens; every gradient
    within 2^-7 of its largest magnitude, a repeat bit for bit), each
    pass's ms, the whole backward's and the plain VJP's, and their bound;
    sr-attention's bf16 backward (the dq pass, the dkv pass) at the four
    MiT-B5 stage shapes of the seg cell ([8, N, H, 64], M = 1,024) and at
    mit_b3's four at 480x640 (M = 300) against the plain VJP (every
    gradient within 2^-7 of its largest magnitude and at most 5 % of its
    elements differing, a repeat bit for bit; a backward with P's and dS's
    lo halves dropped fails that check at mit_b3's stage 3), each pass's
    ms, the whole backward's, the plain VJP's and the bound, and their
    sums over a step's blocks;
 5. serve a few batch-8 bf16 480x640 requests through
    ``segmif_tpu_torch.serving.make_serving_fn`` with a seeded random
    mit_b3 ``JointPipeline``, in default mode (guide = VIS, re-encoded per
    pair) and static-guide mode, then calibrated int8 (``quantize_for_
    serving`` on one batch-8 calibration batch) in both modes; check the
    outputs and that every request launched the kernels (sr-attention
    35 / 28 times, FFM grams and apply twice each, DRDB growth and tail 4
    times each, or in int8 the int8 growth and tail 4 times each and the
    bf16 ones never); print and bound the int8-vs-bf16 drift;
 6. hold the batch-1 f32 pipeline on the card (kernels, the DRDB's
    included) against the same weights on the CPU (plain versions), in
    float and in int8 with the same amaxes; then bf16 against f32 end to
    end on the card (mit_b3, batch 8, 480x640, weights at the reference
    modules' scale) under the limits of tests/test_bf16_drift.py
    (``segmif_tpu_torch.drift``), and a bf16 run with DRDB1's tail bias
    dropped, which must fail them;
 7. print pairs/s for the four serving modes, timed with CUDA events;
 8. fusion-phase training (``segmif_tpu_torch.train.steps.
    make_fusion_train_step``; the kernels' autograd.Functions recompute
    their plain versions in the backward, but for the FFM's and
    sr-attention's bf16 backwards, two kernels and two passes): (a) one
    round >= 2 step of a
    mit_b3 model (weights at the reference modules' scale) in f32 on the
    card against the same step on the CPU, batch 2 at 240x320, every
    gradient leaf held to the CPU's, and a DRDB Function that returns a
    zero bottleneck-bias gradient must fail that check; (b) the slice at
    full width, batch 8 at 480x640, bf16 compute with f32 master weights,
    AdamW (poly schedule): 6 round >= 2 steps on one batch, then a round-1
    step, with the kernel launches of every step counted (sr-attention 35
    or 7, FFM 2 + 2, DRDB 4 + 4, int8 0; in the backward the FFM's two
    kernels 2 + 2, sr-attention's two passes 28 + 28 in rounds >= 2 (the
    seg pass; the guide's taps carry no gradient) and 0 in round 1, and
    no plain VJP of either),
    finite losses and loss_fusion falling from step 1 to step 5, and no
    synchronizing CUDA call in a step; (c) one bf16 step against one f32
    step on the card, beside an f32 step with the weights rounded to bf16:
    at that shape the loss within a relative limit and every gradient
    leaf's norm within a range of f32's (cosines printed); at 64x96 every
    leaf's cosine and the whole gradient's above a limit, every norm
    within a tighter range (128x160 printed); the (a) fault must fail both;
    (d) ms per step and pairs/s (CUDA events, three steps after two
    warm-up steps, host-paced), the share of a step spent in the
    Functions' backward, peak device memory, each part's
    seconds;
 9. the interactive trainer (``segmif_tpu_torch.train``): (a) one seg
    step of a mit_b3 ``SegmentationNetwork`` (drop-path and dropout at 0)
    in f32 on the card against the CPU at 2x240x320, every gradient leaf
    and BatchNorm buffer held to the CPU's, and the running variance
    folded as flax folds it (the biased batch variance), which a planted
    unbiased fold must fail; (b) each float kernel once against its plain
    version at the driver's shapes: sr-attention with M = 100 (the fusion
    phase's 2x320x320 crops) and M = 225 (the seg phase's 4x480x480), FFM
    and DRDB at 2x320x320, f32 and bf16, under phase 4's limits; (c)
    ``python -m segmif_tpu_torch.cli.train`` through its ``main`` at full
    width (mit_b3, 8 synthetic 480x640 training pairs and 4 validation
    pairs, the default crops, bf16, 2 rounds of 3 fusion and 3 seg
    iterations, in a temporary checkpoint dir): the best mIoU in [0, 1],
    the kernel launches of every fusion step, seg step, regenerated batch
    and eval batch (int8 0), the static guide unchanged and the fused
    images changed, the role checkpoints reloaded into a fresh port model
    giving the trainer's logits, each phase's seconds; (d) the seg step
    alone at 4x480x480 bf16 (drop-path and dropout on): ms per step over
    steps 3-5 after two warm-ups, seg train pairs/s, the share in
    sr-attention's kernel backward (its two passes 28 + 28 launches a
    step and no plain VJP), peak memory, and no synchronizing CUDA call in
    a step of its own;
10. disk to disk (``segmif_tpu_torch.disk_check``): (a) a train folder of
    16 and a val folder of 8 synthetic pairs written as uint8 PNGs at
    480x640 (Infrared / Visible / Mask2 / Label, ``frame<i>.png``; the val
    labels RGB with the id in R); ``FusionFolderDataset`` gives the
    written arrays in natural order, and every decoder the machine has
    (PIL; the native decoder and ``NativeLoader`` when their library
    builds) the written bytes, with decode rates on 4 threads; (b)
    ``cli.train.main`` on the folders with ``--streaming
    --dump_fused_images``, one round of 3 + 3 iterations, mit_b3 bf16
    (``--no_native_loader`` when the native library did not build), with
    the launches of every call as phase 9 (c); the val memmap and the
    dumped PNGs hold the regenerated arrays, and a fresh regeneration
    from the written fusion checkpoint gives them bit for bit (cuDNN
    deterministic for (b)-(d)); (c) ``cli.test_fusion.main`` over the val
    folder at batch 8, default mode and ``--static_guide`` with the
    reference quantisation: the PNGs equal ``fused_to_uint8`` of
    ``generate_fused`` in memory, the writer handed only real images,
    launches per batch counted, the two modes' PNGs differ; (d)
    ``cli.test_segmentation.main`` on (c)'s PNGs equals
    ``segmentation_eval`` on the decoded arrays; planted faults (a label
    read from the wrong channel, ``sorted`` for the natural order, a last
    batch's padding handed to the stretch) must fail those checks; (e)
    ``cli.test_fusion`` disk to disk over 64 pairs at batch 8 bf16, twice:
    pairs/s and the device's busy share (CUDA events around the fuse
    calls over the wall time), beside the fuse-only pairs/s on the same
    arrays already on the card;
11. the fusion variants and the accuracy artifact: (a) each interaction
    of moam, soam, concat, add, average and none as a mit_b3
    ``JointPipeline(interaction=v)``, bf16, batch 8 at 480x640, served by
    ``make_serving_fn`` in default mode, every request's launches counted
    (sr-attention 35, FFM 0 and 0, DRDB growth and tail 4 each, int8 0;
    'average' also after ``quantize_for_serving``: int8 growth and tail 4
    each, bf16 DRDB 0), the outputs finite, fused_rgb in [0, 1] and pred
    in [0, 9), each variant's peak device memory; (b) each variant's
    batch-1 f32 pipeline, the short tail and ``SimpleFusionNetwork`` on
    the card against the CPU under phase 6's limits (PIPE_RTOL); (c)
    'both' with ``return_attention`` (the modular path: no FFM launch)
    against the folded FFM kernels on the same weights and taps, under
    the same limits, with its two [1, 8, 8, 8] context maps; (d) planted
    faults that must fail (b): moam's context softmax over the wrong
    axis, 'average' with att1 and att2 swapped, a short tail that runs
    conv22; (e) ``segmif_tpu_torch.accuracy``'s overfit at seed 1, cut
    to its first round and that to 300 fusion steps (to keep the script
    within half its time limit),
    under tests/test_learning.py's stable criteria (the round-1 fusion
    loss's minimum below a fifth of its head and its tail below a third,
    best mIoU above the class prior + 0.10, the seg loss falling within
    round 1), then its drift section with int8 under ``drift``'s limits,
    each section's seconds;
    (f) each variant's pairs/s, timed as phase 7.

12. the stretch, serving export and repeatability: (a) each kernel
    against its plain version at the stretch's shapes (mit_b5 at
    1080x1920): sr-attention at the four stage shapes with SDPA beside it,
    FFM grams and apply at [1|2, 2073600, 64], DRDB growth, tail and
    block at [1|2, 64, 1080, 1920] (f32 and bf16, phase 4's limits, the
    block's peak memory), the int8 growth and tail at batch 1 bit for
    bit, each with its time and bound (the f32 rows' 3xTF32 bound with
    the FMA one beside it); (b) ``cli.stretch.main
    --synthetic`` at mit_b5, 1080x1920, bf16, its lines and its launches
    per pair (61 sr-attention, 2 + 2 FFM, 4 + 4 DRDB; 9 sr-attention with
    ``--no_seg``), then fps and peak memory at batch 1 and 2; (c) the
    mit_b5 pipeline in f32 on the card against the CPU at 270x480
    (PIPE_RTOL), and bf16 against f32 at 1080x1920 under ``drift``'s
    limits with DRDB1's tail bias dropped failing them; (d)
    ``serving.export_serving_artifact`` at mit_b3, batch 8, 480x640,
    bf16, in default, static-guide, int8 and fuse-only mode: the
    program's ``segmif::`` nodes equal to phase 5's launches per request,
    the loaded program against ``make_serving_fn`` (bit for bit, or within
    PIPE_RTOL; the line says which) with the same launches, export
    seconds, size and pairs/s beside ``make_serving_fn``'s (as phase 7),
    and the default artifact loaded and run by a fresh process that
    imports only torch and ``segmif_tpu_torch.kernels``; (e) a cut of
    the accuracy overfit (20 fusion and 10 seg steps of round 1) in a
    child process in deterministic mode (``utils.determinism``), twice at
    seed 1: the same logged losses and final weights bit for bit; a run
    at seed 2 must differ;
13. the parallel paths (``segmif_tpu_torch.parallel``), on ranks this
    script spawns after it built the kernels (their launches join the
    kernels line): (b) one f32 fusion step through the data-parallel path
    over NCCL at world size 1, against the plain step; (a) 2 ranks on the
    card over gloo (NCCL refuses two ranks on one device; send/recv and
    all_gather staged through pinned host memory, printed), a round >= 2
    fusion step of PAR_BACKBONE (mit_b3's widths, heads and sr ratios at
    one block a stage) at global batch 8, 480x640, and a seg step at
    4, 480x480 (drop-path, dropout, BatchNorm), in f32 against one
    process on the whole batch (gradients, DWA state, BN buffers, AdamW's
    steps: phase 9 (a)'s limits and a relative L2 over all gradient
    leaves for the seg step, DP_FUSION_* for the fusion step, beside
    a control without ranks: the one-process fusion step on the last
    rank's rows alone against the same rows tiled to the whole batch's
    size) and in bf16 under phase 8 (c)'s
    480x640 limits, the kernel launches of each step on
    each rank, and two planted faults that must fail (the CE averaged per
    rank, BatchNorm on each rank's statistics); (d) the multi-rank dry
    run (``parallel.dryrun``) on those 2 ranks; (c) the 1080p / mit_b5
    stretch pair fused by ``make_spatial_fuse_fn`` on 2 and 7 (blocks of
    uneven height) ranks of the card, f32 and bf16, against one rank, with each rank's launches (9 sr-attention, 2 + 2 FFM, 4 + 4
    DRDB a pair) and two planted faults that must fail (a halo of 8 rows,
    the FFM grams not summed); (f) several hosts: 4 ranks as 2 emulated
    hosts (torchrun nodes) x 2 (``dist.launch(ranks_per_host=2)``), each
    host reading its stride of (a)'s batches through the ``Prefetcher``
    (``shard_by_process``: 4 of the 8 fusion rows, 2 of the 4 seg rows),
    the f32 fusion and seg steps against one process on the hosts'
    batches concatenated under (a)'s f32 limits, the hosts' rows disjoint
    and one epoch, the launches of each step on each rank, a planted fault
    that must fail (every host on host 0's stride); (e) each path's time
    beside one process's, with the card's name and power limit (ranks
    sharing one card measure the parallel paths' overhead, not a
    speed-up). With ``--parallel`` on a host of N >= 2 cards: (a), (d) on
    N ranks, (c) on 2 and N and (f) on 4, one rank a card, over NCCL (on
    fewer than 4 cards (f)'s ranks share them over gloo);
14. tensor parallelism (``segmif_tpu_torch.parallel.tensor``) on 4 ranks
    this script spawns (their launches join the kernels line): ranks 0-1
    one model group (TP 2), all four one model group (TP 4) and a data 2 x
    model 2 mesh; each path first in one process on rank 0, on
    PAR_BACKBONE as phase 13. (a) the f32 forward, batch 8, 480x640
    (reference-scale weights), split over 2 and over 4 ranks against one
    process, fused Y and logits per element (TP_FWD_RTOL), the split's
    parameter count of the whole mit_b3 on the meta device (TP_SPLIT_M,
    the JAX rule's) and three planted faults that must fail
    (proj's and fc2's bias
    added on every rank, kv split contiguously, the decode head's
    linear_c*.proj split by a name-based rule, which ``tensor_parallel``
    refuses; on TP 2); (b) bf16 ``make_serving_fn(mesh=)`` in default,
    static-guide and int8 modes on TP 2 and TP 4 against one process under
    ``drift``'s limits on the fused Y and the class map, the same outputs
    on every rank of the group, the launches per request on every rank (as
    phase 5 at PAR_BACKBONE's depth: sr-attention 6 / 4 at a rank's heads
    or with every head gathered); each kernel at the split path's shapes
    against its plain
    version (sr-attention at a rank's heads, the FFM with weights gathered
    from the ranks, the DRDB and int8 DRDB with a rank's whole weights);
    (c) the f32 fusion step (round >= 2, batch 4, 480x640) and seg step
    (batch 4, 480x480) on TP 2 and on DP 2 x TP 2 against one process
    under phase 13's limits, the gathered leaves, gradients and BN buffers
    the same on every rank (of the model group on TP 2, of the mesh on DP
    2 x TP 2), launches per step per rank, two planted faults (the FFM
    gather's backward a reduce-scatter, the gradients summed over every
    rank); (d) the dry run on the 4 ranks (data 2 x model 2); (e) the
    times beside one process's, with the card's name and power limit (on
    one card: overhead). With ``--parallel`` on 4 cards: one rank a card,
    over NCCL.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W = 480, 640
BATCH = 8
REQUESTS = 3
SEED = 0
# Device cycles held before a timed run: about 35 ms at the H100's boost
# clock, which covers the host's enqueue of ten calls of any function timed
# here (a call that synchronises inside is timed at the host's pace as
# before: the start event fires when the hold ends).
HOLD_CYCLES = 1 << 26

# Tolerances, kernel vs plain on the same card (both compute in f32; TF32
# off). sr-attention and FFM apply, per element: |got - ref| <= atol +
# rtol * |ref|, and at most a share of the elements differ at all (bf16:
# the two sides round f32 values that differ in their last bits, so a few
# elements sit one step apart; a systematic fault moves most of them).
# (rtol, atol, share, why); measured on the H100 at the main-path shapes.
SR_TOL = {
    "float32": (0.0, 1e-5, 1.0, "f32 sums of 64 and 300 terms in another "
                                "order"),
    "bfloat16": (2 ** -7, 2 ** -14, 0.02,
                 "rtol one bf16 step of the output, so any one-step "
                 "difference passes (the kernel's P V is f32-accurate to "
                 "about 2^-17); atol for outputs near zero, where terms of "
                 "order 1 cancel; held over seeds 0-4 by "
                 "tests/test_torch_cuda.py"),
}
APPLY_TOL = {
    "float32": (0.0, 1e-4, 1.0, "f32 sums in another order, scaled by the "
                                "LayerNorm's 1/std"),
    "bfloat16": (2 ** -7, 2 ** -5, 0.01,
                 "rtol one bf16 step of the output; atol: a projection "
                 "activation rounded to bf16 on the other side of a "
                 "boundary moves a context product by one activation step "
                 "times a context entry, then through the LayerNorm; "
                 "held over seeds 0-4 by tests/test_torch_cuda.py"),
}
GRAM_RTOL = {  # relative to the largest gram entry
    "float32": (1e-5, "3xTF32 products (each to about 2^-21) with the "
                      "tensor cores' truncating adds, and non-negative "
                      "summands over 307,200 tokens in another order; the "
                      "kernel's arithmetic emulated on the CPU reads "
                      "1.0e-6, a 1xTF32 gram 1.5e-4 "
                      "(tests/test_torch_tf32x3.py)"),
    "bfloat16": (1e-3, "as f32, plus rare one-step flips where the bf16 "
                       "rounding of an activation meets a boundary"),
}
# DRDB, per element: |got - ref| <= atol + rtol * (|ref| + |ref - x|),
# the second term only for the tail and the block, whose output is x plus
# a bottleneck term rounded on its own. (rtol, atol, why); the measured
# worst cases are from the H100 at [8, 64, 480, 640], 4 seeds. A dropped
# conv or tail bias (up to 0.04 and 0.067 at torch's init) exceeds every
# bf16 limit; phase 4 plants such faults and checks that they fail.
GROWTH_TOL = {
    "float32": (1e-4, 1e-4, "f32 sums in other orders; cuDNN's f32 conv "
                            "algorithms (measured up to 5e-6)"),
    "bfloat16": (2 ** -7, 2 ** -7,
                 "one bf16 step of the element (the kernel rounds "
                 "conv + bias once, cuDNN rounds the conv, then adds the "
                 "bias), plus earlier r's steps carried through the next "
                 "conv (measured up to 3.9e-3)"),
}
TAIL_TOL = {
    "float32": (1e-4, 1e-4, "f32 sums in another order (measured 0)"),
    "bfloat16": (2 ** -7, 2 ** -10,
                 "one bf16 step of the output and of the bottleneck term: "
                 "both sides round the same f32 accumulator, summed in "
                 "another order (measured 0)"),
}
BLOCK_TOL = {
    "float32": (1e-4, 1e-4, "as the growth chain (measured up to 1.5e-6)"),
    "bfloat16": (2 ** -7, 2 ** -6,
                 "the tail's steps, plus the growth chain's steps carried "
                 "through the bottleneck (measured up to 7.4e-3)"),
}
# batch-1 f32 pipeline, card vs CPU, relative to the reference's largest
# magnitude: f32 sums in other orders through ~50 layers on two devices
PIPE_RTOL = {"fused_y": 1e-4, "logits": 1e-3}
# int8 serving against bf16 serving on the same weights and inputs: the
# fused Y's rmse below a quarter of its std, the JAX package's sanity bound
# for int8 against float end to end (tests/test_int8.py:140-145)
INT8_DRIFT_RMSE = 0.25
# Phase 8, training. (a) card f32 against CPU f32, one step: the losses
# within 1e-4 relative (f32 sums in other orders through the network),
# every gradient leaf within 1e-2 of its largest magnitude: those sums,
# and relu inputs within rounding of zero that take the other branch on
# one device (on the CPU at 32x32 one such pixel moved a DRDB bias
# gradient by up to 2.9e-2 of its largest magnitude against JAX; at
# 240x320 a pixel weighs 75 times less). A zeroed gradient reads 1.
TRAIN_HW = (240, 320)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_LEAF_RTOL = 1e-2
# (c) bf16 against f32 on the card, one step each, mit_b3 batch 8. At
# 480x640 no fixed cosine limit holds for this model: its f32 gradient
# moves when only the weights are rounded to bf16 (``compare.bf16_rounded``,
# f32 arithmetic throughout; the FFM's context softmax over grams of
# 307,200 tokens is saturated, and one bf16 step of a weight moves its
# logits by whole units), and the JAX package's own bf16 step departs from
# its f32 step in the same way, and further than the port's, on the CPU
# (tests/test_torch_train_bf16.py). So at 480x640 the loss within 2e-2
# relative (the fused Y moves by up to about 0.008 in bf16 serving, phase
# 6) and every leaf's norm within [0.02, 20] times f32's (a vanished leaf
# reads 0; an order of magnitude above the largest ratio read on the H100,
# 7.0), the cosines printed beside the rounded-weights step's; at 128x160
# both printed; at 64x96, where the rounded-weights step kept every
# leaf's cosine above 0.98 on the H100: every leaf's cosine at or above
# 0.95, all leaves' at or above 0.99, every norm within [0.8, 1.25] times
# f32's. A zeroed leaf reads cosine 0 and norm ratio 0.
BF16_TRAIN_LOSS_RTOL = 2e-2
BF16_TRAIN_RATIO = {"full": (0.02, 20.0), "held": (0.8, 1.25)}
BF16_TRAIN_HELD_HW = (64, 96)
BF16_TRAIN_PRINTED_HW = (128, 160)
BF16_TRAIN_LEAF_COS = 0.95
BF16_TRAIN_ALL_COS = 0.99
TRAIN_LR = 1e-4           # the JAX bench.py train cell's adamw_poly
TRAIN_FUSION_SCALE = 0.2
# Phase 9 (a): the seg step, card f32 against CPU f32, as phase 8 (a): the
# loss within 1e-4 relative, every leaf and buffer within 1e-2 of its
# largest magnitude (the five leaves whose exact gradient is zero:
# ``compare.exact_zero_grad``, both sides within 1e-6 of the largest
# gradient). An unbiased running variance moves the buffer by a 1 / (n - 1)
# share of the folded variance, about 1e-5 of it at n = 2x60x80, far inside
# any card-vs-CPU limit; so the fold itself is held: ``bn_fold_ratio``
# below 1/4 (the unbiased fold reads 1).
SEG_HW = (240, 320)
SEG_FOLD_LIMIT = 0.25
# (c) the trainer at full width; (d) the seg step at the seg phase's crops
TRAINER_ARGS = ["--synthetic", "8", "--synthetic_val", "4", "--rounds", "2",
                "--fusion_iters", "3", "--seg_iters", "3",
                "--backbone", "mit_b3", "--compute_dtype", "bfloat16"]
SEG_BATCH, SEG_CROP = 4, 480
# Phase 10, disk to disk: the folders' sizes, the CLIs' batch, the decode
# threads. A fresh regeneration from the trainer's fusion checkpoint must
# give the trainer's uint8 val images bit for bit (share of differing
# pixels 0): the same kernels (no atomics) and cuDNN in deterministic mode
# on one card, on the same inputs in the same batches.
D2D_TRAIN, D2D_VAL, D2D_TIMED, D2D_BATCH, D2D_THREADS = 16, 8, 64, 8, 4
D2D_FRESH_SHARE = 0.0
D2D_BACKBONE = "mit_b3"
D2D_TRAIN_ARGS = ["--fusion_iters", "3", "--seg_iters", "3"]
# Peaks of one H100 SXM (NVIDIA's datasheet, dense, 700 W) for the bounds.
# f32-accurate work on the tensor cores runs as 3xTF32 (three TF32
# products per f32 product): "tf32x3" counts 3 x the operations at the
# TF32 peak, 164.9 TFLOP/s of f32 work; "f32", the FMA peak of the CUDA
# cores, is printed beside it.
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 494.7e12}
HBM_BYTES_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


_CHILDREN = []


def started(proc):
    """``proc`` (a ``subprocess.Popen``), killed at exit if it still runs:
    a failed phase leaves no process of this script behind."""
    _CHILDREN.append(proc)
    return proc


@atexit.register
def _stop_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _reference_process(results) -> None:
    """The CPU references' process: each ``REFERENCES`` job in turn, its
    result pickled by value onto ``results`` (or its traceback)."""
    import pickle
    import traceback

    # it yields the host's cores to the main process (whose own CPU work,
    # phase 6's int8 forward, the PNG codecs, ran up to 2.3x slower beside
    # it otherwise): the lowest priority, and idle threads that sleep
    # rather than spin (read when torch's thread pool starts)
    os.nice(19)
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))
    for name in REFERENCES:
        try:
            out = (name, True, pickle.dumps(globals()[f"_ref_{name}"]()))
        except Exception:
            out = (name, False, traceback.format_exc())
        results.put(out)
        if not out[1]:
            return


class CpuReferences:
    """The CPU references of phases 6, 8 (a), 9 (a), 11 (b) and 12 (c),
    computed in a process of their own (spawned, so it touches no card)
    while the card runs phase 4 on. Each ``_ref_<name>`` function rebuilds
    its phase's seeded weights and inputs and runs the plain CPU path;
    ``get(name)`` waits for its result. The process is a daemon:
    multiprocessing stops it at exit."""

    def __init__(self):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._proc = ctx.Process(target=_reference_process,
                                 args=(self._results,), daemon=True)
        self._proc.start()
        self._got = {}

    def get(self, name: str, timeout: float = 900.0):
        import pickle
        import queue

        deadline = time.monotonic() + timeout
        while name not in self._got:
            try:
                key, ok, value = self._results.get(timeout=5.0)
            except queue.Empty:
                check(self._proc.is_alive(), "the CPU reference process "
                      f"exited (code {self._proc.exitcode}) before {name}")
                check(time.monotonic() < deadline,
                      f"no CPU reference {name} within {timeout:.0f} s")
                continue
            check(ok, f"the CPU reference {key} failed:\n{value}")
            self._got[key] = pickle.loads(value)
        return self._got.pop(name)


# in the order the phases read them
REFERENCES = ("pipeline", "train", "seg", "variants", "stretch")


def counted(kind, fn, counters, totals, expect, seen):
    """``fn`` with its kernel launches checked per call: every counter set
    to 0 just before the call and read just after, held to
    ``expect[kind]``, added to ``totals``; ``seen[kind]`` counts the
    calls."""
    def call(*args, **kwargs):
        for c in counters.values():
            c.launches = 0
        out = fn(*args, **kwargs)
        counts = {k: c.launches for k, c in counters.items()}
        check(counts == expect[kind], f"{kind}: launches {counts}, "
                                      f"expected {expect[kind]}")
        seen[kind] = seen.get(kind, 0) + 1
        for k, v in counts.items():
            totals[k] += v
        return out
    return call


@contextlib.contextmanager
def counting_factories(module, kinds, counters, totals, expect, seen):
    """Each ``module.<name>`` of ``kinds`` (name -> kind, or a function of
    the factory's keyword arguments giving the kind) replaced for the
    block by a factory whose closures are ``counted``."""
    saved = {}

    def wrap(real, kind):
        def make(*args, **kwargs):
            k = kind(kwargs) if callable(kind) else kind
            return counted(k, real(*args, **kwargs), counters, totals,
                           expect, seen)
        return make

    for name, kind in kinds.items():
        saved[name] = getattr(module, name)
        setattr(module, name, wrap(saved[name], kind))
    try:
        yield seen
    finally:
        for name, real in saved.items():
            setattr(module, name, real)


FLOAT_PATH = {"ffm_grams": 2, "ffm_apply": 2, "drdb_growth": 4,
              "drdb_tail": 4, "drdb_int8_growth": 0, "drdb_int8_tail": 0}
SEG_ONLY = {k: 0 for k in FLOAT_PATH}
# launches per call of each closure the trainer and the CLIs build
TRAINER_EXPECT = {"fusion r1": {"sr_attention": 7, **FLOAT_PATH},
                  "fusion r2": {"sr_attention": 35, **FLOAT_PATH},
                  "seg step": {"sr_attention": 28, **SEG_ONLY},
                  "regenerated batch": {"sr_attention": 7, **FLOAT_PATH},
                  "eval batch": {"sr_attention": 28, **SEG_ONLY}}
TRAINER_MAKERS = {
    "make_fusion_train_step":
        lambda kw: "fusion r1" if kw["round1"] else "fusion r2",
    "make_seg_train_step": "seg step",
    "make_fuse_fn": "regenerated batch",
    "make_segment_fn": "eval batch"}


def _events_ms(fn, iters: int, hold: bool = True) -> float:
    """ms per call over `iters` back-to-back calls, CUDA events. With
    `hold`, a sleep kernel holds the device while the host enqueues the
    calls, so a call shorter than its host-side launch is timed on the
    device and not at the host's pace (which varies with the shared host's
    load)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the plain version, no yardstick of speed, is timed over as many calls
# (at most ``iters``, at least one) as its warm-up says fill this many ms:
# a slow plain version (the int8 DRDB's, 190 ms a call) then costs one
# call a side, not ``iters``
PLAIN_TIMED_MS = 50.0


def time_pair(kernel, plain, iters: int = 10):
    """(kernel ms, plain ms) per call, CUDA events, in the order plain,
    kernel, kernel, plain after one warm-up call of each."""
    import torch

    kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    p_iters = max(1, min(iters, math.ceil(PLAIN_TIMED_MS / warm_ms)))
    p1, k1, k2, p2 = (_events_ms(fn, n) for fn, n in (
        (plain, p_iters), (kernel, iters), (kernel, iters),
        (plain, p_iters)))
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_fn(fn, iters: int = 10, hold: bool = True) -> float:
    """ms per call of one function, CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    return _events_ms(fn, iters, hold)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(ops: float, kind: str, moved: int) -> dict:
    """The least time the card could take: the larger of the operations
    over the peak rate for their type and the bytes (each input read once,
    each output written once) over the memory rate."""
    t_ops = (3 * ops / PEAK_OPS["tf32"] if kind == "tf32x3"
             else ops / PEAK_OPS[kind]) * 1e3
    t_bytes = moved / HBM_BYTES_S * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


def grams_ops(b: int, n: int, c: int) -> int:
    """FFM pass A's operations as the function needs them, over b images
    of n tokens: three C-wide projections (2 C^2 a token each) and three
    grams, symmetric, so only their C (C + 1) / 2 entries on and above the
    diagonal (2 a token each)."""
    return 3 * b * n * (2 * c * c + c * (c + 1))


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def held(got, want, tol):
    """(largest |got - ref| / (atol + rtol |ref|), largest |got - ref|,
    share of elements that differ) over a tensor or a tuple of tensors,
    and whether they are within tol = (rtol, atol, share, why)."""
    import torch

    rtol, atol, share, why = tol
    gs, ws = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    ratio, err = worst(gs, ws, (rtol, atol, why))
    diff = (sum((g != e).sum().item() for g, e in zip(gs, ws))
            / sum(g.numel() for g in gs))
    return ratio, err, diff, ratio <= 1.0 and diff <= share


def verdict(ratio, err, diff, tol) -> str:
    rtol, atol, share, why = tol
    return (f"max_abs_err {err:.3e}, worst error/limit {ratio:.3f}, "
            f"elements differing {diff:.5f} (atol {atol:g} + rtol {rtol:g} "
            f"per element, share {share:g}: {why})")


def kv_halves(randn, b, n, m, h, d, dtype):
    """q, and k and v as the model makes them: the strided halves of one
    [B, M, 2 H D] projection."""
    q = randn((b, n, h, d), dtype)
    kv = randn((b, m, 2 * h * d), dtype)
    return (q, kv[..., :h * d].unflatten(-1, (h, d)),
            kv[..., h * d:].unflatten(-1, (h, d)))


def fault_fails(label, name, got, want, tol):
    ratio, err, diff, ok = held(got, want, tol)
    print(f"planted fault, {label}, {name}: {verdict(ratio, err, diff, tol)}"
          f" (the check fails, as it must)", flush=True)
    check(not ok, f"the {label} check passes a kernel run with the {name}")


def kernel_checks(dev):
    """Phase 4. Returns {kernel: {max_abs_err, ms, plain_ms, ...}}."""
    import torch
    import torch.nn.functional as F

    from segmif_tpu_torch.kernels.attention import (sr_attention,
                                                    sr_attention_ref)
    from segmif_tpu_torch.kernels._build import tf32_big
    from segmif_tpu_torch.kernels.ffm import (crosspath_apply_rows,
                                              crosspath_apply_rows_ref,
                                              crosspath_grams,
                                              crosspath_grams_ref)

    gen = torch.Generator().manual_seed(SEED)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    def sdpa_ms(q, k, v, scale):
        # the one PyTorch call for the same function, on the same values
        # already laid out [B, H, N, D] (the layout it takes)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return time_fn(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale))

    def sdpa_err(q, k, v, scale, want):
        # SDPA's own f32 error against the plain version, for information:
        # whether a tensor-core f32 product holds SR_TOL at these shapes
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        return held(got.transpose(1, 2), want, SR_TOL["float32"])

    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": None}
           for k in ("sr_attention", "ffm_grams", "ffm_apply")}
    # sr-attention at the four mit_b3 stage shapes: (N, heads), M=300, D=64
    sdpa = {}
    ops = moved = f32_moved = 0
    f32_ms = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol = SR_TOL[dname]
        sdpa[dname] = 0.0
        for n, h in ((19200, 1), (4800, 2), (1200, 5), (300, 8)):
            d, m = 64, 300
            q, k, v = kv_halves(randn, BATCH, n, m, h, d, dtype)
            got = sr_attention(q, k, v, d ** -0.5)
            want = sr_attention_ref(q, k, v, d ** -0.5)
            ratio, err, diff, ok = held(got, want, tol)
            ms, pms = time_pair(lambda: sr_attention(q, k, v, d ** -0.5),
                                lambda: sr_attention_ref(q, k, v, d ** -0.5))
            lib = sdpa_ms(q, k, v, d ** -0.5)
            sdpa[dname] += lib
            print(f"sr_attention {dname} B={BATCH} N={n} M={m} H={h} D={d}: "
                  f"{verdict(ratio, err, diff, tol)}; kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, scaled_dot_product_attention "
                  f"{lib:.4f} ms", flush=True)
            check(ok, f"sr_attention {dname} N={n} error {err}")
            label = f"sr_attention {dname} N={n} H={h}"
            if dtype == torch.float32:
                sr, se, sd, sok = sdpa_err(q, k, v, d ** -0.5, want)
                print(f"scaled_dot_product_attention float32 N={n} H={h} "
                      f"against sr_attention_ref (information only): "
                      f"{verdict(sr, se, sd, tol)}; "
                      f"{'within' if sok else 'outside'} the f32 limit",
                      flush=True)
                check(torch.equal(got, sr_attention(q, k, v, d ** -0.5)),
                      f"{label}: two calls differ")
                if n == 4800:
                    # what a dropped small*big product of S gives: Q's
                    # small half lost, i.e. Q rounded to TF32
                    fault_fails(label, "Q's small*big product dropped (Q "
                                "rounded to TF32)",
                                sr_attention(tf32_big(q), k, v, d ** -0.5),
                                want, tol)
            if dtype == torch.bfloat16 and n == 4800:
                fault_fails(label, "scale x 1.01",
                            sr_attention(q, k, v, d ** -0.5 * 1.01), want,
                            tol)
                fault_fails(label, "last key row dropped (M - 1)",
                            sr_attention(q, k[:, :-1], v[:, :-1], d ** -0.5),
                            want, tol)
            r = res["sr_attention"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dtype == torch.bfloat16:
                r["ms"] += ms
                r["plain_ms"] += pms
                ops += 4 * BATCH * n * m * h * d     # two products
                moved += nbytes(q, k, v, got)
            else:
                f32_ms += ms
                f32_moved += nbytes(q, k, v, got)
            del q, k, v, got, want
    res["sr_attention"].update(library_ms=sdpa["bfloat16"],
                               **bound(ops, "bf16", moved))
    fma, tf3 = bound(ops, "f32", f32_moved), bound(ops, "tf32x3", f32_moved)
    res["sr_attention"].update(f32_ms=f32_ms, f32_bound_ms=tf3["bound_ms"],
                               f32_library_ms=sdpa["float32"])
    print(f"sr_attention float32, 4 stage shapes summed: kernel "
          f"{f32_ms:.4f} ms, scaled_dot_product_attention f32 "
          f"{sdpa['float32']:.4f} ms; f32 bounds: 3xTF32 "
          f"{tf3['bound_ms']:.4f} ms ({tf3['bound_by']}, 3 x the operations "
          f"at the TF32 peak), FMA {fma['bound_ms']:.4f} ms "
          f"({fma['bound_by']}, at the CUDA cores' f32 peak)", flush=True)
    print(f"sr_attention, 4 stage shapes summed: kernel "
          f"{res['sr_attention']['ms']:.4f} ms bf16; scaled_dot_product_"
          f"attention {sdpa['float32']:.4f} ms f32, {sdpa['bfloat16']:.4f} "
          f"ms bf16; bf16 bound {res['sr_attention']['bound_ms']:.4f} ms "
          f"({res['sr_attention']['bound_by']})", flush=True)
    # 1080p stage 1: M = 1980 key rows, 31 key tiles (both dtypes stream
    # K/V, so any M is taken)
    b, n, m, h, d = 2, 129600, 1980, 1, 64
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        q, k, v = kv_halves(randn, b, n, m, h, d, dtype)
        got = sr_attention(q, k, v, d ** -0.5)
        want = sr_attention_ref(q, k, v, d ** -0.5)
        tol = SR_TOL[dname]
        ratio, err, diff, ok = held(got, want, tol)
        ms, pms = time_pair(lambda: sr_attention(q, k, v, d ** -0.5),
                            lambda: sr_attention_ref(q, k, v, d ** -0.5))
        lib = sdpa_ms(q, k, v, d ** -0.5)
        ops = 4 * b * n * m * h * d
        bnd = bound(ops, "bf16" if dtype == torch.bfloat16 else "tf32x3",
                    nbytes(q, k, v, got))
        print(f"sr_attention {dname} 1080p stage 1 B={b} N={n} M={m} H={h} "
              f"D={d}: {verdict(ratio, err, diff, tol)}; kernel {ms:.4f} ms,"
              f" plain {pms:.4f} ms, scaled_dot_product_attention {lib:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}"
              f"{', 3xTF32' if dtype == torch.float32 else ''})", flush=True)
        check(ok, f"sr_attention {dname} 1080p error {err}")
        if dtype == torch.float32:
            sr, se, sd, sok = sdpa_err(q, k, v, d ** -0.5, want)
            print(f"scaled_dot_product_attention float32 1080p stage 1 "
                  f"against sr_attention_ref (information only): "
                  f"{verdict(sr, se, sd, tol)}; "
                  f"{'within' if sok else 'outside'} the f32 limit",
                  flush=True)
        res["sr_attention"]["max_abs_err"] = max(
            res["sr_attention"]["max_abs_err"], err)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    # FFM grams and apply at the fusion trunk's shape
    n, c = H * W, 64
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x1, x2, s = (randn((BATCH, n, c), dtype) for _ in range(3))
        wp = randn((3, c, 2 * c), torch.float32, c ** -0.5)
        bp = randn((3, 2 * c), torch.float32, 0.1)
        mats = randn((BATCH, 4, c, c), torch.float32, 0.125)
        be = randn((2, c), torch.float32, 0.1)
        lnp = torch.stack([torch.stack([1 + randn((c,), torch.float32, 0.1),
                                        randn((c,), torch.float32, 0.1)])
                           for _ in range(2)])
        got = crosspath_grams(x1, x2, s, wp, bp)
        want = gram_ref(x1, x2, s, wp, bp)
        err = max_err(got, want)
        scale = want.abs().max().item()
        rtol, why = GRAM_RTOL[dname]
        ms, pms = time_pair(lambda: crosspath_grams(x1, x2, s, wp, bp),
                            lambda: crosspath_grams_ref(x1, x2, s, wp, bp))
        ref, own = "the plain version", ""
        if dtype == torch.float32:
            plain_err = max_err(crosspath_grams_ref(x1, x2, s, wp, bp), want)
            ref = "the plain maths in f64"
            own = f", the f32 plain version's own {plain_err:.3e}"
        print(f"ffm_grams {dname} B={BATCH} N={n} C={c}: against {ref}: "
              f"max_abs_err {err:.3e} of max |gram| {scale:.3e} (rtol "
              f"{rtol:g}: {why}){own}; kernel {ms:.4f} ms, plain {pms:.4f} "
              f"ms", flush=True)
        check(err <= rtol * scale, f"ffm_grams {dname} error {err}")
        check(torch.equal(got, crosspath_grams(x1, x2, s, wp, bp)),
              "ffm_grams is not deterministic")
        faults = [("y1 bias zeroed", (wp, torch.cat([bp[:1] * 0, bp[1:]]))),
                  ("y1 and y2 weights swapped", (wp[[1, 0, 2]], bp))]
        if dtype == torch.float32:
            # W^T is the projection's A operand: its small*big product
            # dropped is the kernel run on W rounded to TF32
            faults.append(("W's small*big product dropped (W rounded to "
                           "TF32)", (tf32_big(wp), bp)))
        for name, bad in faults:
            e = max_err(crosspath_grams(x1, x2, s, *bad), want)
            print(f"planted fault, ffm_grams {dname} N={n}, {name}: "
                  f"max_abs_err {e:.3e}, error/limit "
                  f"{e / (rtol * scale):.3f} (the check fails, as it "
                  f"must)", flush=True)
            check(e > rtol * scale, f"the ffm_grams check passes a "
                                    f"kernel run with the {name}")
        res["ffm_grams"]["max_abs_err"] = max(res["ffm_grams"]["max_abs_err"],
                                              err)
        ops = grams_ops(BATCH, n, c)
        moved = nbytes(x1, x2, s, wp, bp, got)
        if dtype == torch.bfloat16:
            res["ffm_grams"].update(ms=ms, plain_ms=pms,
                                    **bound(ops, "bf16", moved))
        else:
            fma, tf3 = bound(ops, "f32", moved), bound(ops, "tf32x3", moved)
            res["ffm_grams"].update(f32_ms=ms, f32_bound_ms=tf3["bound_ms"])
            print(f"ffm_grams float32: f32 bounds: 3xTF32 "
                  f"{tf3['bound_ms']:.4f} ms ({tf3['bound_by']}, 3 x the "
                  f"operations at the TF32 peak), FMA {fma['bound_ms']:.4f} "
                  f"ms ({fma['bound_by']}, at the CUDA cores' f32 peak); "
                  f"kernel at {tf3['bound_ms'] / ms:.3f} of its 3xTF32 "
                  f"bound", flush=True)

        args = (x1, x2, s, wp, bp, mats, be, lnp)
        got = crosspath_apply_rows(*args)
        want = crosspath_apply_rows_ref(*args)
        tol = APPLY_TOL[dname]
        ratio, err, diff, ok = held(got, want, tol)
        ms, pms = time_pair(lambda: crosspath_apply_rows(*args),
                            lambda: crosspath_apply_rows_ref(*args))
        label = f"ffm_apply {dname} B={BATCH} N={n} C={c}"
        print(f"{label}: {verdict(ratio, err, diff, tol)}; kernel {ms:.4f} "
              f"ms, plain {pms:.4f} ms", flush=True)
        check(ok, f"ffm_apply {dname} error {err}")
        lnp_bad = lnp + torch.tensor([0.01, 0.0], device=dev)[:, None]
        faults = [("be zeroed", (x1, x2, s, wp, bp, mats, be * 0, lnp)),
                  ("M1 and M3 swapped",
                   (x1, x2, s, wp, bp, mats[:, [0, 3, 2, 1]], be, lnp)),
                  ("LayerNorm gamma + 0.01",
                   (x1, x2, s, wp, bp, mats, be, lnp_bad))]
        if dtype == torch.float32:
            # what a dropped small*big product of y3's projection gives:
            # s's small half lost, i.e. s rounded to TF32
            faults.append(("y3's small*big product dropped (s rounded to "
                           "TF32)", (x1, x2, tf32_big(s), wp, bp, mats, be,
                                     lnp)))
        for name, bad in faults:
            fault_fails(label, name, crosspath_apply_rows(*bad), want, tol)
        res["ffm_apply"]["max_abs_err"] = max(res["ffm_apply"]["max_abs_err"],
                                              err)
        # three 64-wide projections and four [64, 64] context products
        ops = 7 * 2 * BATCH * n * c * c
        if dtype == torch.bfloat16:
            res["ffm_apply"].update(ms=ms, plain_ms=pms, **bound(
                ops, "bf16", nbytes(*args, *got)))
        else:
            fma = bound(ops, "f32", nbytes(*args, *got))
            tf3 = bound(ops, "tf32x3", nbytes(*args, *got))
            res["ffm_apply"].update(f32_ms=ms, f32_bound_ms=tf3["bound_ms"])
            print(f"ffm_apply float32: f32 bounds: 3xTF32 "
                  f"{tf3['bound_ms']:.4f} ms ({tf3['bound_by']}; 3 x the "
                  f"operations at the TF32 peak, "
                  f"{3 * ops / PEAK_OPS['tf32'] * 1e3:.4f} ms), FMA "
                  f"{fma['bound_ms']:.4f} ms ({fma['bound_by']}, at the "
                  f"CUDA cores' f32 peak)", flush=True)
        del x1, x2, s, got, want, args, faults
        torch.cuda.empty_cache()
    # the apply with fewer tokens than one 16-token tile per warp, and with
    # a ragged last tile, both dtypes
    for dtype, n in itertools.product((torch.float32, torch.bfloat16),
                                      (1, 40, 4097)):
        dname = str(dtype).split(".")[1]
        args = (*(randn((BATCH, n, c), dtype) for _ in range(3)), wp, bp,
                mats, be, lnp)
        tol = APPLY_TOL[dname]
        ratio, err, diff, ok = held(crosspath_apply_rows(*args),
                                    crosspath_apply_rows_ref(*args), tol)
        print(f"ffm_apply {dname} B={BATCH} N={n}: "
              f"{verdict(ratio, err, diff, tol)}", flush=True)
        check(ok, f"ffm_apply {dname} N={n} error {err}")
        res["ffm_apply"]["max_abs_err"] = max(res["ffm_apply"]["max_abs_err"],
                                              err)
    # the grams with fewer tokens than one 16-token tile per warp (padded
    # tokens must add nothing, although relu(bias) != 0), both dtypes
    for dtype, n in itertools.product((torch.float32, torch.bfloat16),
                                      (1, 40)):
        dname = str(dtype).split(".")[1]
        rtol = GRAM_RTOL[dname][0]
        xs = [randn((BATCH, n, c), dtype) for _ in range(3)]
        got = crosspath_grams(*xs, wp, bp)
        want = gram_ref(*xs, wp, bp)
        err, scale = max_err(got, want), want.abs().max().item()
        print(f"ffm_grams {dname} B={BATCH} N={n}: max_abs_err {err:.3e} "
              f"of max |gram| {scale:.3e} (rtol {rtol:g})", flush=True)
        check(err <= rtol * scale, f"ffm_grams {dname} N={n} error {err}")
        check(torch.equal(got, crosspath_grams(*xs, wp, bp)),
              "ffm_grams is not deterministic")
        res["ffm_grams"]["max_abs_err"] = max(res["ffm_grams"]["max_abs_err"],
                                              err)
    return res


# a bf16 fusion step's kernel backwards: the FFM's two kernels once per
# round; sr-attention's two passes once per block of the seg pass that
# carries a gradient (28 in rounds >= 2; the guide's taps run without
# one); no plain VJP of either
BWD_EXPECT = {r: {"ffm_bwd_reduce": 2, "ffm_bwd_rows": 2,
                  "sr_attention_bwd_dq": sr, "sr_attention_bwd_dkv": sr,
                  "plain_vjp": 0} for r, sr in (("r2", 28), ("r1", 0))}
# the FFM's bf16 backward against the plain VJP in bf16, every gradient
# within this share of its largest magnitude (tests/test_torch_cuda.py's
# GRAD_TOL), on dyadic tokens and projections whose relu inputs no
# summation order moves
FFM_BWD_TOL = 2 ** -7


def ffm_backward_checks(dev):
    """Phase 4: the FFM's bf16 backward (``kffm.crosspath_backward``: pass
    A', the fold's gradient, pass B') at the fusion trunk's shape and at
    the trainer's 2x320x320 crops against the plain VJP it replaces: the
    errors, a repeat bit for bit, each pass's ms, the whole backward's
    beside the plain VJP's and the bound of the function's operations
    (40 64x64 products a token) and bytes (x1 x2 s g1 g2 read, dx1 dx2 ds
    written, once each)."""
    import torch

    from segmif_tpu_torch.kernels import _build
    from segmif_tpu_torch.kernels import ffm as kffm
    from segmif_tpu_torch.models.fusion import CrossPath

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 21)

    def ternary(shape, step):
        return (torch.randint(-1, 2, shape, generator=gen) * step).to(
            dev, bf16)

    for b, n in ((BATCH, H * W), (2, 320 * 320)):
        torch.manual_seed(SEED + 21)
        cp = CrossPath(64).to(dev, bf16)
        with torch.no_grad():
            for i in (1, 2, 3):
                lin = getattr(cp, f"channel_proj{i}")
                for t in (lin.weight, lin.bias):
                    t.copy_(ternary(tuple(t.shape), 1 / 64))
        xs = [ternary((b, n, 64), 1 / 8) for _ in range(3)]
        gs = [torch.randn((b, n, 64), generator=gen).to(dev, bf16)
              for _ in range(2)]
        w = {k: v.detach() for k, v in cp.folded_weights().items()}
        ws = [w[k] for k in kffm.W_KEYS]
        wp, bp = kffm.projections(w)
        with torch.no_grad():
            grams = kffm.crosspath_grams(*xs, wp, bp)
        args = (*xs, grams, ws, *gs, [True] * 20, cp.scale, cp.num_heads)

        def kernel():
            return kffm.crosspath_backward(*args)

        def plain():
            return _build.plain_vjp(
                "bwd/crosspath", lambda x1, x2, s, *ws: kffm.
                crosspath_folded_ref(x1, x2, s, dict(zip(kffm.W_KEYS, ws)),
                                     cp.scale, cp.num_heads),
                [*xs, *ws], [True] * 20, gs)

        got, want = kernel(), plain()
        errs = {name: max_err(g, e) / e.float().abs().max().item()
                for name, g, e in zip(("x1", "x2", "s") + kffm.W_KEYS, got,
                                      want)}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= FFM_BWD_TOL, f"ffm backward error {errs}")
        check(all(torch.equal(a, c) for a, c in zip(got, kernel())),
              "the ffm backward is not deterministic")
        ms, pms = time_pair(kernel, plain)
        mats, be, lnp = kffm.apply_args(grams, w, cp.scale, cp.num_heads)
        sym = torch.randn((b, 3, 64, 64), generator=gen).to(dev) * 1e-3
        a_ms = time_fn(lambda: kffm.crosspath_bwd_reduce(
            *xs, *gs, wp, bp, mats, be, lnp))
        b_ms = time_fn(lambda: kffm.crosspath_bwd_rows(
            *xs, *gs, wp, bp, mats, sym, be, lnp))
        bd = bound(40 * 2 * 64 * 64 * b * n, "bf16", nbytes(*xs, *gs,
                                                             *got[:3]))
        print(f"ffm_backward bfloat16 B={b} N={n} C=64: against the plain "
              f"VJP worst max|err|/max|ref| {errs[worst]:.3e} ({worst}; "
              f"limit {FFM_BWD_TOL:g}), repeats bit for bit; pass A' "
              f"{a_ms:.4f} ms, pass B' {b_ms:.4f} ms, the whole backward "
              f"{ms:.4f} ms (the fold's small ops on the host's pace "
              f"besides), plain VJP {pms:.4f} ms; bound {bd['bound_ms']:.4f}"
              f" ms ({bd['bound_by']}), the two passes at "
              f"{bd['bound_ms'] / (a_ms + b_ms):.3f} of it", flush=True)
        del got, want, xs, gs, grams, args
        torch.cuda.empty_cache()


# sr-attention's bf16 backward against the plain VJP in bf16: every
# gradient within this share of its largest magnitude (tests/test_torch_
# cuda.py's GRAD_TOL), and at most this share of each gradient's elements
# different at all (its SRA_BWD_SHARE: both sides carry every product and
# sum in f32 and round dq, dk and dv once; P and dS taken at bf16 alone
# move 40-44 % of the elements while the largest error stays near one
# rounding)
SRA_BWD_TOL = 2 ** -7
SRA_BWD_SHARE = 0.05
# the stage at which a backward with P's and dS's lo halves dropped is
# held to the same limits, and must fail them: mit_b3's stage 3
SRA_BWD_FAULT_AT = ("mit_b3 480x640", 1200)
# [B, N, H] of each MiT stage, M and the blocks a step runs the stage:
# SegFormer-B5 at 1024x1024 (the seg cell) and mit_b3 at 480x640 (the
# fusion cells' seg pass)
SRA_BWD_SHAPES = (
    ("mit_b5 1024x1024", 1024, ((8, 65536, 1, 3), (8, 16384, 2, 6),
                                (8, 4096, 5, 40), (8, 1024, 8, 3))),
    ("mit_b3 480x640", 300, ((8, 19200, 1, 3), (8, 4800, 2, 4),
                             (8, 1200, 5, 18), (8, 300, 8, 3))))


def sr_attention_backward_checks(dev):
    """Phase 4: sr-attention's bf16 backward (``sr_attention_backward``:
    the dq pass, then the dkv pass and its reduce) at each MiT stage shape
    of the seg cell and of mit_b3 at 480x640 against the plain VJP it
    replaces: the errors, the share of elements that differ, a repeat bit
    for bit, each pass's ms, the whole backward's beside the plain VJP's and
    the bound of the function's five products (10 B N M H D FLOP) and bytes
    (q, k, v, dO read, dq, dk, dv written, once each); then each model's
    sum over the blocks of a step. At one stage a backward with P's and
    dS's lo halves dropped must fail the same check."""
    import torch

    from segmif_tpu_torch.kernels import _build
    from segmif_tpu_torch.kernels import attention as katt

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 23)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    for model, m, stages in SRA_BWD_SHAPES:
        step = {"kernel": 0.0, "plain": 0.0, "bound": 0.0}
        for b, n, h, blocks in stages:
            d = 64
            q, k, v = kv_halves(randn, b, n, m, h, d, bf16)
            g = randn((b, n, h, d), bf16)
            scale = d ** -0.5

            def kernel():
                return katt.sr_attention_backward(q, k, v, g, [True] * 3,
                                                  scale)

            def plain():
                return _build.plain_vjp(
                    "bwd/sr_attention",
                    lambda q, k, v: katt.sr_attention_ref(q, k, v, scale),
                    [q, k, v], [True] * 3, (g,))

            got, want = kernel(), plain()
            errs, share = sra_bwd_errors(got, want)
            worst = max(errs, key=errs.get)
            check(errs[worst] <= SRA_BWD_TOL and share <= SRA_BWD_SHARE,
                  f"sr-attention backward error {errs}, share of elements "
                  f"differing {share}")
            if (model, n) == SRA_BWD_FAULT_AT:
                f_errs, f_share = sra_bwd_errors(
                    sra_bwd_lo_dropped(q, k, v, g, scale), want)
                print(f"planted fault, sr_attention_backward {model} N={n}, "
                      f"P and dS lo halves dropped: worst max|err|/max|ref| "
                      f"{max(f_errs.values()):.3e}, share of elements "
                      f"differing {f_share:.5f} (limits {SRA_BWD_TOL:g}, "
                      f"{SRA_BWD_SHARE:g}; the check fails, as it must)",
                      flush=True)
                check(max(f_errs.values()) > SRA_BWD_TOL
                      or f_share > SRA_BWD_SHARE,
                      "the sr-attention backward check passes a backward "
                      "with P's and dS's lo halves dropped")
            check(all(torch.equal(a, c) for a, c in zip(got, kernel())),
                  "the sr-attention backward is not deterministic")
            ms, pms = time_pair(kernel, plain)
            dq_out = katt.sr_attention_bwd_dq(q, k, v, g, scale)
            dq_ms = time_fn(lambda: katt.sr_attention_bwd_dq(q, k, v, g,
                                                             scale))
            dkv_ms = time_fn(lambda: katt.sr_attention_bwd_dkv(
                q, k, v, g, *dq_out[1:], scale))
            bd = bound(10 * b * n * m * h * d, "bf16",
                       nbytes(q, k, v, g, *got))
            for key, val in (("kernel", ms), ("plain", pms),
                             ("bound", bd["bound_ms"])):
                step[key] += blocks * val
            print(f"sr_attention_backward bfloat16 {model} B={b} N={n} "
                  f"M={m} H={h} D={d}: against the plain VJP worst "
                  f"max|err|/max|ref| {errs[worst]:.3e} ({worst}; limit "
                  f"{SRA_BWD_TOL:g}), share of elements differing "
                  f"{share:.5f} (limit {SRA_BWD_SHARE:g}), repeats bit for "
                  f"bit; dq pass "
                  f"{dq_ms:.4f} ms, dkv pass {dkv_ms:.4f} ms, the whole "
                  f"backward {ms:.4f} ms, plain VJP {pms:.4f} ms; bound "
                  f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}), the "
                  f"backward at {bd['bound_ms'] / ms:.3f} of it", flush=True)
            del got, want, dq_out, q, k, v, g
            torch.cuda.empty_cache()
        print(f"sr_attention_backward bfloat16 {model}, the "
              f"{sum(s[3] for s in stages)} blocks of a step: backward "
              f"{step['kernel']:.2f} ms, plain VJP {step['plain']:.2f} ms, "
              f"bound {step['bound']:.3f} ms", flush=True)


def sra_bwd_errors(got, want):
    """({dq, dk, dv: max|got - want| / max|want|}, the largest share of a
    gradient's elements that differ at all)."""
    errs = {name: max_err(a, e) / e.float().abs().max().item()
            for name, a, e in zip(("dq", "dk", "dv"), got, want)}
    share = max((a != e).float().mean().item() for a, e in zip(got, want))
    return errs, share


def sra_bwd_lo_dropped(q, k, v, g, scale):
    """sr-attention's backward in plain torch, f32, with P and dS entering
    the dv, dq and dk products as their high bf16 halves alone."""
    import torch

    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale, -1)
    dp = torch.einsum("bnhd,bmhd->bhnm", gf, vf)
    ds = p * (dp - (p * dp).sum(-1, True))
    p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    dv = torch.einsum("bhnm,bnhd->bmhd", p, gf)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def drdb_inputs(gen, b, h, w, dtype, dev):
    """x as the trunk holds it (an NCHW view on channels_last memory) and
    the DRDB's weights at torch's default conv init."""
    import torch

    x = torch.randn((b, h, w, 64), generator=gen).to(dev, dtype)

    def conv(o, i, k):
        bound = (i * k * k) ** -0.5
        wt = (torch.rand((o, i, k, k), generator=gen) * 2 - 1) * bound
        bs = (torch.rand((o,), generator=gen) * 2 - 1) * bound
        return wt.to(dev, dtype), bs.to(dev, dtype)

    return (x.permute(0, 3, 1, 2), [conv(32, 64 + 32 * t, 3)
                                    for t in range(5)], conv(64, 224, 1))


def worst(got, want, tol, x=None):
    """(largest |got - ref| / limit, largest |got - ref|) over every
    element of a tensor or of a tuple of tensors, where limit = atol +
    rtol * (|ref| + |ref - x|), the last term only when x is given."""
    import torch

    rtol, atol, _ = tol
    gs, ws = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    ratio = err = 0.0
    for g, e in zip(gs, ws):
        d = (g.float() - e.float()).abs()
        ref = e.float().abs()
        if x is not None:
            ref += (e.float() - x.float()).abs()
        ratio = max(ratio, (d / (atol + rtol * ref)).max().item())
        err = max(err, d.max().item())
    return ratio, err


def compare(label, kernel, plain, tol, timed, x=None):
    """Run kernel() and plain() (a tensor or a tuple of tensors each),
    hold every element to tol = (rtol, atol, why) as ``worst`` does,
    print, and time both if asked. Returns (kernel output, largest error,
    kernel ms, plain ms); the times are None when not timed."""
    got, want = kernel(), plain()
    ratio, err = worst(got, want, tol, x)
    rtol, atol, why = tol
    ms = pms = None
    times = ""
    if timed:
        ms, pms = time_pair(kernel, plain)
        times = f"; kernel {ms:.4f} ms, plain {pms:.4f} ms"
    print(f"{label}: max_abs_err {err:.3e}, worst error/limit {ratio:.3f} "
          f"(atol {atol:g} + rtol {rtol:g} per element: {why}){times}",
          flush=True)
    check(ratio <= 1.0, f"{label} error {err} exceeds its limit")
    return got, err, ms, pms


def planted_faults(x, dconvs, wb, bb, tols, label):
    """Run the kernels with a fault planted in their arguments (a dropped
    conv 1 or conv 5 bias, conv 3's taps (0, 0) and (2, 2) swapped, conv
    5's weights for r4 zeroed, a dropped or channel-shifted tail bias, r2
    and r3 swapped at the tail) against the plain versions on the true
    arguments; each must fail the check."""
    import torch

    from segmif_tpu_torch.kernels.drdb import (drdb_growth, drdb_growth_ref,
                                               drdb_tail, drdb_tail_ref)

    def drop(t):
        return [(w, torch.zeros_like(b) if i == t else b)
                for i, (w, b) in enumerate(dconvs)]

    def with_weight(t, w):
        return [(w, dconvs[t][1]) if i == t else c
                for i, c in enumerate(dconvs)]

    def swap_taps(t):   # conv t's taps (0, 0) and (2, 2) swapped
        w = dconvs[t][0].clone()
        w[..., 0, 0], w[..., 2, 2] = (w[..., 2, 2].clone(),
                                      w[..., 0, 0].clone())
        return with_weight(t, w)

    def zero_last_chunk(t):   # conv t's weights for its last 32 inputs
        w = dconvs[t][0].clone()
        w[:, -32:] = 0
        return with_weight(t, w)

    ref = drdb_growth_ref(x, dconvs)
    rs = drdb_growth(x, dconvs)   # the tail reads the kernel's buffer
    tref = drdb_tail_ref(x, rs, wb, bb)
    faults = (
        ("conv 1 bias dropped", drdb_growth(x, drop(0)), ref, "growth", None),
        ("conv 5 bias dropped", drdb_growth(x, drop(4)), ref, "growth", None),
        ("conv 3 taps (0, 0) and (2, 2) swapped",
         drdb_growth(x, swap_taps(2)), ref, "growth", None),
        ("conv 5 weights of its last 32 inputs (r4) zeroed",
         drdb_growth(x, zero_last_chunk(4)), ref, "growth", None),
        ("tail bias dropped", drdb_tail(x, rs, wb, torch.zeros_like(bb)),
         tref, "tail", x),
        ("tail bias shifted one channel", drdb_tail(x, rs, wb, bb.roll(1)),
         tref, "tail", x),
        ("r2 and r3 passed to the tail in each other's place",
         drdb_tail(x, [rs[0], rs[2], rs[1], *rs[3:]], wb, bb), tref, "tail",
         x),
    )
    for name, got, want, which, resid in faults:
        ratio, err = worst(got, want, tols[which], resid)
        print(f"planted fault, {label}, {name}: max_abs_err {err:.3e}, "
              f"worst error/limit {ratio:.3f} (the {which} check fails, as "
              f"it must)", flush=True)
        check(ratio > 1.0, f"{label}: the {which} check passes a kernel "
                           f"run with the {name}")


def drdb_checks(dev):
    """Phase 4, DRDB. Returns {kernel: {max_abs_err, ms, plain_ms}} for
    the growth chain and the tail (times: bf16 at the main-path shape)."""
    import torch

    from segmif_tpu_torch.kernels._build import tf32_big
    from segmif_tpu_torch.kernels.drdb import (drdb_block, drdb_chain,
                                               drdb_growth, drdb_growth_ref,
                                               drdb_tail, drdb_tail_ref,
                                               pack_growth, pack_tail)

    gen = torch.Generator().manual_seed(SEED + 2)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": None}
           for k in ("drdb_growth", "drdb_tail")}
    for (b, h, w), timed in (((BATCH, H, W), True), ((2, 100, 172), False)):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x, dconvs, (wb, bb) = drdb_inputs(gen, b, h, w, dtype, dev)
            shape = f"{dname} [{b}, 64, {h}, {w}]"
            tols = {"growth": GROWTH_TOL[dname], "tail": TAIL_TOL[dname]}
            # weights packed once, as DRDB.forward passes them
            gpk, tpk = pack_growth(dconvs, dtype), pack_tail(wb, bb, dtype)
            rs, gerr, gms, gpms = compare(
                f"drdb_growth {shape}", lambda: drdb_growth(x, dconvs, gpk),
                lambda: drdb_growth_ref(x, dconvs), tols["growth"], timed)
            # the tail reads the growth buffer's slices, as on the path
            out, terr, tms, tpms = compare(
                f"drdb_tail {shape}",
                lambda: drdb_tail(x, rs, wb, bb, wpk=tpk),
                lambda: drdb_tail_ref(x, rs, wb, bb), tols["tail"], timed,
                x)
            check(out.is_contiguous(memory_format=torch.channels_last),
                  "drdb_tail output is not channels_last")
            npix = b * h * w
            kind = "f32" if dtype == torch.float32 else "bf16"
            growth_ops = 2 * npix * 9 * 32 * (64 + 96 + 128 + 160 + 192)
            growth_bound = bound(growth_ops, kind,
                                 nbytes(x, *rs, *(t for c in dconvs
                                                  for t in c)))
            tail_bound = bound(2 * npix * 224 * 64, kind,
                               nbytes(x, *rs, wb, bb, out))
            if timed and dtype == torch.float32:
                blk = bound(growth_ops + 2 * npix * 224 * 64, kind,
                            nbytes(x, out))
                tf3 = bound(growth_ops, "tf32x3",
                            nbytes(x, *rs, *(t for c in dconvs for t in c)))
                lib = cudnn_growth_ms(x, rs, dconvs)
                res["drdb_growth"].update(f32_ms=gms,
                                          f32_bound_ms=tf3["bound_ms"],
                                          f32_library_ms=lib)
                ttf3 = bound(2 * npix * 224 * 64, "tf32x3",
                             nbytes(x, *rs, wb, bb, out))
                tlib = cudnn_tail_ms(x, rs, wb, bb)
                res["drdb_tail"].update(f32_ms=tms,
                                        f32_bound_ms=ttf3["bound_ms"],
                                        f32_library_ms=tlib)
                print(f"drdb_tail {shape}: kernel {tms:.4f} ms; 3xTF32 "
                      f"bound {ttf3['bound_ms']:.4f} ms ({ttf3['bound_by']};"
                      f" 3 x the operations at the TF32 peak "
                      f"{3 * 2 * npix * 224 * 64 / PEAK_OPS['tf32'] * 1e3:.4f}"
                      f" ms), FMA {tail_bound['bound_ms']:.4f} ms "
                      f"({tail_bound['bound_by']}); one 1x1 F.conv2d on a "
                      f"prebuilt concatenation (f32, no relu, no residual) "
                      f"{tlib:.4f} ms", flush=True)
                print(f"drdb {shape}: f32 bounds (at the f32 peak) growth "
                      f"{growth_bound['bound_ms']:.4f} ms "
                      f"({growth_bound['bound_by']}), tail "
                      f"{tail_bound['bound_ms']:.4f} ms "
                      f"({tail_bound['bound_by']}), block "
                      f"{blk['bound_ms']:.4f} ms ({blk['bound_by']}); growth "
                      f"3xTF32 bound {tf3['bound_ms']:.4f} ms "
                      f"({tf3['bound_by']}, 3 x the operations at the TF32 "
                      f"peak); five-launch f32 traffic "
                      f"{2 * floor_bytes(npix) / HBM_BYTES_S * 1e3:.4f} ms; "
                      f"cuDNN's five convs in f32 on prebuilt concatenations "
                      f"{lib:.4f} ms", flush=True)
                check(all(torch.equal(a, b_) for a, b_ in zip(
                    rs, drdb_growth(x, dconvs, gpk))),
                      f"drdb_growth {shape}: two calls differ")
            for name, err, ms, pms, bnd in (
                    ("drdb_growth", gerr, gms, gpms, growth_bound),
                    ("drdb_tail", terr, tms, tpms, tail_bound)):
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if timed and dtype == torch.bfloat16:
                    r.update(ms=ms, plain_ms=pms, **bnd)
            if timed and dtype == torch.bfloat16:
                res["drdb_growth"]["library_ms"] = cudnn_growth_ms(
                    x, rs, dconvs)
                res["drdb_tail"]["library_ms"] = cudnn_tail_ms(x, rs, wb, bb)
                print(f"drdb_tail {shape}: one 1x1 F.conv2d on a prebuilt "
                      f"concatenation (bf16, no relu, no residual) "
                      f"{res['drdb_tail']['library_ms']:.4f} ms", flush=True)
                floor = floor_bytes(npix)
                print(f"drdb_growth {shape}: bound "
                      f"{growth_bound['bound_ms']:.4f} ms "
                      f"({growth_bound['bound_by']}); five-launch traffic "
                      f"floor {floor / 1e9:.3f} GB, "
                      f"{floor / HBM_BYTES_S * 1e3:.4f} ms; cuDNN's five "
                      f"convs on prebuilt concatenations (no relu, no "
                      f"concat) {res['drdb_growth']['library_ms']:.4f} ms",
                      flush=True)
            del rs, out
            compare(f"drdb_block {shape} vs drdb_chain",
                    lambda: drdb_block(x, dconvs, (wb, bb), (gpk, tpk)),
                    lambda: drdb_chain(x, dconvs, (wb, bb)),
                    BLOCK_TOL[dname], timed, x)
            if not timed:
                planted_faults(x, dconvs, wb, bb, tols, shape)
            if not timed and dtype == torch.float32:
                # what a dropped small*big product of conv 1 gives: x's
                # small half lost, i.e. x rounded to TF32
                ratio, err = worst(drdb_growth(tf32_big(x), dconvs)[0],
                                   drdb_growth_ref(x, dconvs)[0],
                                   tols["growth"])
                print(f"planted fault, {shape}, conv 1's small*big product "
                      f"dropped (x rounded to TF32): max_abs_err {err:.3e}, "
                      f"worst error/limit {ratio:.3f} (the growth check "
                      f"fails, as it must)", flush=True)
                check(ratio > 1.0, f"{shape}: the growth check passes a "
                                   "kernel run without small*big")
                # the tail's: r1..r5 rounded to TF32 (x is its residual
                # too, so rounding it would show in the sum, not the
                # product), and its B, the bottleneck, rounded
                rs = drdb_growth(x, dconvs)
                want = drdb_tail_ref(x, rs, wb, bb)
                for name, bad in (
                        ("small*big product of r1..r5 dropped (r rounded "
                         "to TF32)", ([tf32_big(r) for r in rs], wb)),
                        ("big*small product of the bottleneck dropped (wb "
                         "rounded to TF32)", (rs, tf32_big(wb)))):
                    ratio, err = worst(drdb_tail(x, bad[0], bad[1], bb),
                                       want, tols["tail"], x)
                    print(f"planted fault, {shape}, the tail's {name}: "
                          f"max_abs_err {err:.3e}, worst error/limit "
                          f"{ratio:.3f} (the tail check fails, as it must)",
                          flush=True)
                    check(ratio > 1.0, f"{shape}: the tail check passes a "
                                       f"kernel run with its {name}")
                del rs, want
            if timed and dtype == torch.bfloat16:
                for name, fn in (("drdb_block", drdb_block),
                                 ("drdb_chain", drdb_chain)):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    y = fn(x, dconvs, (wb, bb))
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated(dev) - base
                    print(f"{name} {shape}: peak device memory above its "
                          f"input {peak / 2**20:.1f} MiB", flush=True)
                    del y
            del x, dconvs
            torch.cuda.empty_cache()
    # growth and tail off their tiles (16x16; 128 pixels), and with x a
    # channel slice (16-79) of a wider channels_last tensor (pixel stride
    # 96), bf16 and f32
    for (b, h, w, sliced), dtype in itertools.product(
            ((1, 17, 33, False), (2, 5, 7, False), (2, 17, 33, True)),
            (torch.float32, torch.bfloat16)):
        dname = str(dtype).split(".")[1]
        x, dconvs, (wb, bb) = drdb_inputs(gen, b, h, w, dtype, dev)
        if sliced:
            wide = torch.randn((b, h, w, 96), generator=gen).to(dev, dtype)
            wide[..., 16:80] = x.permute(0, 2, 3, 1)
            x = wide.permute(0, 3, 1, 2)[:, 16:80]
        shape = (f"{dname} [{b}, 64, {h}, {w}]"
                 f"{', x a channel slice' if sliced else ''}")
        rs, err, _, _ = compare(
            f"drdb_growth {shape}", lambda: drdb_growth(x, dconvs),
            lambda: drdb_growth_ref(x, dconvs), GROWTH_TOL[dname], False)
        res["drdb_growth"]["max_abs_err"] = max(
            res["drdb_growth"]["max_abs_err"], err)
        _, err, _, _ = compare(
            f"drdb_tail {shape}", lambda: drdb_tail(x, rs, wb, bb),
            lambda: drdb_tail_ref(x, rs, wb, bb), TAIL_TOL[dname], False,
            x)
        res["drdb_tail"]["max_abs_err"] = max(res["drdb_tail"]["max_abs_err"],
                                              err)
    return res


def floor_bytes(npix: int) -> int:
    """What five bf16 growth launches must move: each conv reads its input
    (64 + 32 t channels) and writes its 32, 2 bytes each (f32: twice)."""
    return npix * (sum(64 + 32 * t for t in range(5)) + 160) * 2


def cudnn_tail_ms(x, rs, wb, bb) -> float:
    """The tail's library yardstick: one 1x1 ``F.conv2d`` (with bias) in
    x's dtype and channels_last on the concatenation [x, r1..r5] built
    beforehand (so without the relu and the residual the tail also
    does). Timed here only; the port never calls it on the card path."""
    import torch
    import torch.nn.functional as F

    cl = torch.channels_last
    feat = torch.cat([x, *rs], 1).contiguous(memory_format=cl)
    w = wb.contiguous(memory_format=cl)
    return time_fn(lambda: F.conv2d(feat, w, bb))


def cudnn_growth_ms(x, rs, dconvs) -> float:
    """The growth's library yardstick: cuDNN's five dilated convs in x's
    dtype and channels_last, on concatenated inputs built beforehand (so without the
    relu and the concat the chain also needs). Timed here only; the port
    never calls it on the card path."""
    import torch
    import torch.nn.functional as F

    cl = torch.channels_last
    feats = [torch.cat([x, *rs[:t]], 1).contiguous(memory_format=cl)
             for t in range(5)]
    ws = [(w.contiguous(memory_format=cl), b) for w, b in dconvs]

    def five():
        for f, (w, b) in zip(feats, ws):
            F.conv2d(f, w, b, padding=2, dilation=2)

    ms = time_fn(five)
    del feats
    torch.cuda.empty_cache()
    return ms


def int8_faults(q):
    """The int8 kernels' arguments with one fault planted in each."""
    import torch

    from segmif_tpu_torch.kernels.int8 import pack_int8_growth

    return (
        ("conv 2 bias dropped", q._replace(bias=torch.cat(
            [q.bias[:32], q.bias[32:64] * 0, q.bias[64:]]))),
        ("r3 requantised with r2's scale", q._replace(invs=torch.cat(
            [q.invs[:3], q.invs[2:3], q.invs[4:]]))),
        ("bottleneck bias dropped", q._replace(bb=q.bb * 0)),
        ("x's channels shifted by one",
         q._replace(wpk=pack_int8_growth((q.kq[0].roll(1, dims=1),)
                                         + q.kq[1:]))),
    )


def drdb_int8_checks(dev):
    """Phase 4, int8 DRDB: the growth (entry quantise + five convs) and
    tail kernels against ``drdb_int8_ref`` bit for bit, the int8 buffer
    and the output, at the main-path shape (timed), 100x172 (planted
    faults) and 5x7. Returns {kernel: {max_abs_err, ms, plain_ms, bounds}}
    and prints the int8 block's times and peak memory."""
    import torch

    from segmif_tpu_torch.kernels.drdb import drdb_growth_ref
    from segmif_tpu_torch.kernels.int8 import (drdb_int8, drdb_int8_growth,
                                               drdb_int8_growth_ref,
                                               drdb_int8_ref, drdb_int8_tail,
                                               drdb_int8_tail_ref,
                                               quantize_drdb, record_amax)

    gen = torch.Generator().manual_seed(SEED + 3)
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": None}
           for k in ("drdb_int8_growth", "drdb_int8_tail")}
    for (b, h, w), timed in (((BATCH, H, W), True), ((2, 100, 172), False),
                             ((1, 5, 7), False)):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            shape = f"{dname} [{b}, 64, {h}, {w}]"
            x, dconvs, bottleneck = drdb_inputs(gen, b, h, w, dtype, dev)
            amax = record_amax([x, *drdb_growth_ref(x, dconvs)])
            q = quantize_drdb(dconvs, bottleneck, amax)
            feat = drdb_int8_growth(x, q)
            want_feat = drdb_int8_growth_ref(x, q)
            out = drdb_int8_tail(x, feat, q)
            want = drdb_int8_tail_ref(x, want_feat, q)
            torch.cuda.synchronize()
            gdiff = (feat != want_feat).sum().item()
            tdiff = (out != want).sum().item()
            gerr, err = max_err(feat, want_feat), max_err(out, want)
            times = ""
            if timed:
                gms, gpms = time_pair(lambda: drdb_int8_growth(x, q),
                                      lambda: drdb_int8_growth_ref(x, q))
                tms, tpms = time_pair(lambda: drdb_int8_tail(x, feat, q),
                                      lambda: drdb_int8_tail_ref(x, feat, q))
                bms, bpms = time_pair(lambda: drdb_int8(x, q),
                                      lambda: drdb_int8_ref(x, q))
                times = (f"; growth kernel {gms:.4f} ms, plain {gpms:.4f} "
                         f"ms; tail kernel {tms:.4f} ms, plain {tpms:.4f} "
                         f"ms; block kernel {bms:.4f} ms, plain "
                         f"{bpms:.4f} ms")
            print(f"drdb_int8 {shape}: int8 buffer elements differing "
                  f"{gdiff} of {feat.numel()}, output {tdiff} of "
                  f"{out.numel()}, max_abs_err {err:.3e} (limit: bit for "
                  f"bit){times}", flush=True)
            check(gdiff == 0 and tdiff == 0,
                  f"drdb_int8 {shape}: kernels differ from the plain version")
            check(out.is_contiguous(memory_format=torch.channels_last),
                  "drdb_int8_tail output is not channels_last")
            npix = b * h * w
            if timed and dtype == torch.float32:
                ops = 2 * npix * 9 * 32 * (64 + 96 + 128 + 160 + 192)
                g32 = bound(ops, "int8", nbytes(x, feat, q.wpk, q.svk,
                                                 q.bias, q.s_in, q.invs))
                t32 = bound(2 * npix * 224 * 64, "int8",
                            nbytes(x, feat, q.kbq, q.svb, q.bb, out))
                b32 = bound(ops + 2 * npix * 224 * 64, "int8",
                            nbytes(x, out))
                print(f"drdb_int8 {shape}: bounds with f32 x (int8 "
                      f"operations at the int8 peak, f32 bytes) growth "
                      f"{g32['bound_ms']:.4f} ms ({g32['bound_by']}), tail "
                      f"{t32['bound_ms']:.4f} ms ({t32['bound_by']}), block "
                      f"{b32['bound_ms']:.4f} ms ({b32['bound_by']})",
                      flush=True)
            if timed and dtype == torch.bfloat16:
                ops = 2 * npix * 9 * 32 * (64 + 96 + 128 + 160 + 192)
                res["drdb_int8_growth"].update(
                    ms=gms, plain_ms=gpms,
                    **bound(ops, "int8", nbytes(x, feat, q.wpk, q.svk,
                                                q.bias, q.s_in, q.invs)))
                res["drdb_int8_tail"].update(
                    ms=tms, plain_ms=tpms,
                    **bound(2 * npix * 224 * 64, "int8",
                            nbytes(x, feat, q.kbq, q.svb, q.bb, out)))
                blk = bound(ops + 2 * npix * 224 * 64, "int8",
                            nbytes(x, out))
                print(f"drdb_int8 block {shape}: bound {blk['bound_ms']:.4f}"
                      f" ms ({blk['bound_by']}); growth bound "
                      f"{res['drdb_int8_growth']['bound_ms']:.4f} ms, tail "
                      f"bound {res['drdb_int8_tail']['bound_ms']:.4f} ms",
                      flush=True)
                del feat, out, want, want_feat
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                y = drdb_int8(x, q)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(dev) - base
                print(f"drdb_int8 {shape}: peak device memory above its "
                      f"input {peak / 2**20:.1f} MiB", flush=True)
                del y
            if (b, h, w) == (2, 100, 172):
                ref = drdb_int8_ref(x, q)
                for name, bad in int8_faults(q):
                    got = drdb_int8(x, bad)
                    n = (got != ref).sum().item()
                    print(f"planted fault, int8 {shape}, {name}: output "
                          f"elements differing {n} of {got.numel()}, "
                          f"max_abs_err {max_err(got, ref):.3e} (the check "
                          f"fails, as it must)", flush=True)
                    check(n > 0, f"the int8 check passes a kernel run with "
                                 f"the {name}")
            for name, e in (("drdb_int8_growth", gerr),
                            ("drdb_int8_tail", err)):
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], e)
            del x, dconvs, q
            torch.cuda.empty_cache()
    return res


def bf16_vs_f32(dev):
    """Phase 6, bf16 against f32 end to end: a mit_b3 ``JointPipeline``
    with weights at the reference modules' scale runs the batch-8 480x640
    pipeline on the card once in f32 and once in bf16 (channels_last, the
    serving form); the bf16 run must hold ``segmif_tpu_torch.drift``'s
    limits (those of tests/test_bf16_drift.py), and a bf16 run with DRDB1's
    tail bias dropped must fail them."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import JointPipeline

    model = drift.init_reference_scale(JointPipeline("mit_b3"),
                                       torch.Generator().manual_seed(SEED + 4))
    ir, vis = requests(torch.Generator().manual_seed(SEED + 5), 1, BATCH,
                       "cpu")[0]
    t0 = time.perf_counter()
    ref = drift.pipeline_outputs(model, ir, vis, torch.float32, dev)
    d = drift.drift(ref, drift.pipeline_outputs(model, ir, vis,
                                                torch.bfloat16, dev))
    torch.cuda.synchronize()
    print(f"bf16 vs f32 pipeline (mit_b3, batch {BATCH}, {H}x{W}, "
          f"reference-scale weights; f32 fused Y in "
          f"[{ref[0].min().item():.4f}, {ref[0].max().item():.4f}], logits "
          f"std {ref[1].std().item():.4f}): {drift.describe(d)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(drift.within_limits(d), "bf16 serving drifts from f32")
    with torch.no_grad():
        model.fusion.DRDB1.conv.bias.zero_()
    bad = drift.drift(ref, drift.pipeline_outputs(model, ir, vis,
                                                  torch.bfloat16, dev))
    print(f"planted fault, bf16 vs f32 pipeline, DRDB1's tail bias dropped:"
          f" {drift.describe(bad)} (the check fails, as it must)", flush=True)
    check(not drift.within_limits(bad), "the bf16-vs-f32 check passes a "
                                        "run with DRDB1's tail bias dropped")
    del model, ref
    torch.cuda.empty_cache()


def pipeline_inputs():
    """Phases 5 and 6's seeded f32 mit_b3 ``JointPipeline`` (on the CPU,
    eval mode), their requests' generator and, drawn from it, phase 6's
    batch-1 request on the CPU."""
    import torch

    from segmif_tpu_torch.models.network import JointPipeline, init_params

    model = init_params(JointPipeline("mit_b3"),
                        torch.Generator().manual_seed(SEED)).eval()
    gen = torch.Generator().manual_seed(SEED + 1)
    return model, gen, requests(gen, 1, 1, "cpu")[0]


def _ref_pipeline():
    """Phase 6's CPU reference: (fused Y, logits, seconds) of the batch-1
    f32 pipeline on the CPU, on phase 6's first request."""
    import torch

    model, _, (ir1, vis1) = pipeline_inputs()
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, y, logits = model(ir1, vis1)
    return y, logits, time.perf_counter() - t0


def requests(gen, n_req, batch, dev):
    import torch

    out = []
    for _ in range(n_req):
        ir = torch.rand((batch, H, W, 1), generator=gen)
        vis = torch.rand((batch, H, W, 3), generator=gen)
        out.append((ir.to(dev), vis.to(dev)))
    return out


def train_batch(gen, b, h, w, dev):
    import torch

    return {"ir": torch.rand((b, h, w, 1), generator=gen).to(dev),
            "vis": torch.rand((b, h, w, 3), generator=gen).to(dev),
            "guide": torch.rand((b, h, w, 3), generator=gen).to(dev),
            "label": torch.randint(0, 9, (b, h, w), generator=gen).to(dev)}


class planted_zero_bias_grad:
    """While active, the DRDB Function's backward returns a zero gradient
    for the bottleneck bias."""

    def __enter__(self):
        from segmif_tpu_torch.kernels import drdb as kdrdb

        self.cls, self.real = kdrdb._DrdbFn, kdrdb._DrdbFn.backward
        real = self.real

        def faulty(ctx, g):
            grads = list(real(ctx, g))
            grads[-1] = grads[-1] * 0
            return tuple(grads)

        self.cls.backward = staticmethod(faulty)

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.real)


def train_inputs():
    """Phase 8's seeded mit_b3 ``JointPipeline`` at the reference modules'
    scale, its batches' generator and, drawn from it, phase 8 (a)'s batch
    of 2 on the CPU."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import JointPipeline

    model = drift.init_reference_scale(
        JointPipeline("mit_b3"), torch.Generator().manual_seed(SEED + 6))
    gen = torch.Generator().manual_seed(SEED + 7)
    return model, gen, train_batch(gen, 2, *TRAIN_HW, "cpu")


def _ref_train():
    """Phase 8 (a)'s CPU reference: (metrics, gradients, seconds) of one
    f32 round >= 2 step on the CPU, on phase 8's first batch."""
    import torch

    from segmif_tpu_torch.train.compare import step_grads

    model, _, small = train_inputs()
    t0 = time.perf_counter()
    want_m, want = step_grads(model, small, False, torch.float32, "cpu",
                              TRAIN_FUSION_SCALE)
    return want_m, want, time.perf_counter() - t0


def train_checks(dev, counters, refs):
    """Phase 8: fusion-phase training; see the module docstring. ``refs``:
    the ``CpuReferences``."""
    import warnings

    import torch

    from segmif_tpu_torch.kernels import _build
    from segmif_tpu_torch.kernels import attention as katt
    from segmif_tpu_torch.kernels import ffm as kffm
    from segmif_tpu_torch.train.compare import (bf16_rounded, leaf_cosines,
                                                leaf_errors, step_grads)
    from segmif_tpu_torch.train.optimizer import adamw_poly
    from segmif_tpu_torch.train.state import FusionTrainState
    from segmif_tpu_torch.train.steps import make_fusion_train_step

    f32, bf16 = torch.float32, torch.bfloat16
    model, gen, small = train_inputs()

    # (a) card f32 against CPU f32
    t0 = time.perf_counter()
    want_m, want, cpu_s = refs.get("train")
    on_card = {k: v.to(dev) for k, v in small.items()}
    got_m, got = step_grads(model, on_card, False, f32, dev,
                            TRAIN_FUSION_SCALE)
    for k in ("loss", "loss_fusion", "loss_seg"):
        a, b = got_m[k].item(), want_m[k].item()
        print(f"train (a) f32 card vs CPU {k}: {a:.6f} vs {b:.6f}, "
              f"relative {abs(a - b) / abs(b):.2e} (limit "
              f"{TRAIN_LOSS_RTOL:g})", flush=True)
        check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b), f"train (a) {k}")
    errs = leaf_errors(got, want)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    print(f"train (a) f32 card vs CPU, mit_b3 batch 2 {TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]}, round >= 2: {len(errs)} gradient leaves, worst "
          f"max|err|/max|ref| {worst[0][1]:.3e} ({worst[0][0]}), next "
          f"{worst[1][1]:.3e} ({worst[1][0]}), median "
          f"{sorted(errs.values())[len(errs) // 2]:.3e} (limit "
          f"{TRAIN_LEAF_RTOL:g}); CPU step {cpu_s:.1f} s", flush=True)
    check(worst[0][1] <= TRAIN_LEAF_RTOL, "train (a) gradients differ")
    with planted_zero_bias_grad():
        _, bad = step_grads(model, on_card, False, f32, dev,
                            TRAIN_FUSION_SCALE)
    bad_worst = max(leaf_errors(bad, want).items(), key=lambda kv: kv[1])
    print(f"planted fault, train (a), DRDB bottleneck-bias gradient "
          f"zeroed: worst {bad_worst[1]:.3e} ({bad_worst[0]}) (the check "
          f"fails, as it must)", flush=True)
    check(bad_worst[1] > TRAIN_LEAF_RTOL, "the train (a) check passes a "
                                          "zeroed DRDB bias gradient")
    del got, bad, want, on_card
    print(f"train (a): {time.perf_counter() - t0:.1f} s", flush=True)

    # (b) the slice at full width
    t0 = time.perf_counter()
    full = train_batch(gen, BATCH, H, W, dev)
    m = copy.deepcopy(model)
    tx = adamw_poly(TRAIN_LR, 0, 20000)
    step = make_fusion_train_step(m, tx, round1=False)
    step1 = make_fusion_train_step(m, tx, round1=True)
    state = FusionTrainState.create(m.fusion, tx)
    float_drdb = {"drdb_growth": 4, "drdb_tail": 4, "drdb_int8_growth": 0,
                  "drdb_int8_tail": 0}
    expect = {r: {"sr_attention": sr, "ffm_grams": 2, "ffm_apply": 2,
                  **float_drdb} for r, sr in (("r2", 35), ("r1", 7))}

    # the kernel backwards: the FFM's two kernels once a round,
    # sr-attention's two passes once a seg block, no plain VJP
    bwd = {"ffm_bwd_reduce": kffm.crosspath_bwd_reduce,
           "ffm_bwd_rows": kffm.crosspath_bwd_rows,
           "sr_attention_bwd_dq": katt.sr_attention_bwd_dq,
           "sr_attention_bwd_dkv": katt.sr_attention_bwd_dkv}

    def counted(fn, which):
        for c in (*counters.values(), *bwd.values()):
            c.launches = 0
        kffm._CrossPathFn.plain_backwards = 0
        katt._SrAttentionFn.plain_backwards = 0
        metrics = fn(state, full, TRAIN_FUSION_SCALE)
        counts = {k: c.launches for k, c in counters.items()}
        check(counts == expect[which], f"train step launches {counts}, "
                                       f"expected {expect[which]}")
        backward = {k: c.launches for k, c in bwd.items()}
        backward["plain_vjp"] = (kffm._CrossPathFn.plain_backwards +
                                 katt._SrAttentionFn.plain_backwards)
        check(backward == BWD_EXPECT[which],
              f"train step kernel backwards {backward}, expected "
              f"{BWD_EXPECT[which]}")
        return metrics

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    losses = [counted(step, "r2")]          # step 1, warm-up
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")     # step 2, warm-up, untimed
        torch.cuda.set_sync_debug_mode("warn")
        try:
            losses.append(counted(step, "r2"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ev[0].record()
    for _ in range(3):                      # steps 3-5, timed
        losses.append(counted(step, "r2"))
    ev[1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    step_ms = ev[0].elapsed_time(ev[1]) / 3
    # step 6: the Functions' backward (the recomputes and the FFM's
    # kernels) timed inside the step
    spans = []

    def timed(real):
        def fn(*a, **k):
            s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s_.record()
            out = real(*a, **k)
            e_.record()
            spans.append((s_, e_))
            return out
        return fn

    reals = (_build.plain_vjp, kffm.crosspath_backward,
             katt.sr_attention_backward)
    (_build.plain_vjp, kffm.crosspath_backward,
     katt.sr_attention_backward) = map(timed, reals)
    try:
        ev[2].record()
        losses.append(counted(step, "r2"))
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        (_build.plain_vjp, kffm.crosspath_backward,
         katt.sr_attention_backward) = reals
    syncs = [w for w in syncs if "called a synchronizing" in str(w.message)]
    recompute_ms = sum(a.elapsed_time(b) for a, b in spans)
    inst_ms = ev[2].elapsed_time(ev[3])
    fus = [mt["loss_fusion"].item() for mt in losses]
    tot = [mt["loss"].item() for mt in losses]
    print(f"train (b) mit_b3 batch {BATCH} {H}x{W}, bf16 compute, f32 "
          f"master weights, AdamW lr {TRAIN_LR:g}: 6 round >= 2 steps, "
          f"loss {' '.join(f'{v:.5f}' for v in tot)}, loss_fusion "
          f"{' '.join(f'{v:.5f}' for v in fus)}; launches per step "
          f"{expect['r2']}, in the backward {BWD_EXPECT['r2']}",
          flush=True)
    check(all(math.isfinite(v) for v in tot + fus), "train losses not "
                                                   "finite")
    check(fus[4] < fus[0], "loss_fusion did not fall over 5 steps")
    r1 = counted(step1, "r1")
    r1_loss = r1["loss"].item()
    check(math.isfinite(r1_loss) and r1["loss_seg"].item() == 0.0,
          "round-1 step")
    check(int(state.step.item()) == 7 and int(state.dwa.step.item()) == 7,
          "train state step counts")
    print(f"train (b) round-1 step: loss {r1_loss:.5f}, launches "
          f"{expect['r1']}", flush=True)
    print(f"train (d) ms per step {step_ms:.2f} (steps 3-5 after two "
          f"warm-up steps, CUDA events, host-paced), "
          f"{BATCH * 1e3 / step_ms:.3f} train pairs/s; peak device memory of "
          f"steps 3-5 above the model and batch {peak / 2**30:.2f} GiB; step "
          f"6 {inst_ms:.2f} ms of which the Functions' backward "
          f"{recompute_ms:.2f} ms ({recompute_ms / inst_ms:.3f} of the step, "
          f"{len(spans)} calls); synchronizing CUDA calls in step 2 "
          f"(torch.cuda.set_sync_debug_mode): {len(syncs)}", flush=True)
    check(not syncs, f"the train step waits for the device: "
                     f"{syncs[0].message if syncs else ''}")
    del m, state, step, step1, losses
    torch.cuda.empty_cache()
    print(f"train (b): {time.perf_counter() - t0:.1f} s", flush=True)

    # (c) bf16 against f32 on the card
    t0 = time.perf_counter()
    rounded = bf16_rounded(model)
    shapes = (("full", (H, W)), ("printed", BF16_TRAIN_PRINTED_HW),
              ("held", BF16_TRAIN_HELD_HW))
    for kind, (h, w) in shapes:
        data = full if kind == "full" else train_batch(gen, BATCH, h, w, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        m32, g32 = step_grads(model, data, False, f32, dev,
                              TRAIN_FUSION_SCALE)
        peak32 = torch.cuda.max_memory_allocated(dev)
        _, gw = step_grads(rounded, data, False, f32, dev, TRAIN_FUSION_SCALE)
        m16, g16 = step_grads(model, data, False, bf16, dev,
                              TRAIN_FUSION_SCALE)
        rel = abs(m16["loss"].item() - m32["loss"].item()) / abs(
            m32["loss"].item())
        cos_w = leaf_cosines(gw, g32)
        label = f"train (c) bf16 vs f32 step, mit_b3 batch {BATCH} {h}x{w}"
        print(f"{label}: loss {m16['loss'].item():.6f} vs "
              f"{m32['loss'].item():.6f}, relative {rel:.3e} (limit "
              f"{BF16_TRAIN_LOSS_RTOL:g}); bf16 step {bf16_summary(g16, g32)}"
              f"; f32 step at bf16-rounded weights "
              f"{bf16_summary(gw, g32)}; f32 step peak device memory "
              f"{peak32 / 2**30:.2f} GiB", flush=True)
        if kind == "full":
            cos = leaf_cosines(g16, g32)
            print(f"{label}: leaves below cosine {BF16_TRAIN_LEAF_COS} (bf16 "
                  f"/ rounded weights): " + ", ".join(
                      f"{k} {c:.3f}/{cos_w[k]:.3f}" for k, c in sorted(
                          cos.items(), key=lambda kv: kv[1])
                      if c < BF16_TRAIN_LEAF_COS), flush=True)
        check(rel <= BF16_TRAIN_LOSS_RTOL, f"{label}: the bf16 loss drifts")
        if kind == "printed":
            continue
        faults = bf16_faults(g16, g32, kind)
        check(not faults, f"{label}: {'; '.join(faults)}")
        with planted_zero_bias_grad():
            _, bad = step_grads(model, data, False, bf16, dev,
                                TRAIN_FUSION_SCALE)
        caught = bf16_faults(bad, g32, kind)
        print(f"planted fault, {label}, DRDB bottleneck-bias gradient "
              f"zeroed: {'; '.join(caught)} (the check fails, as it must)",
              flush=True)
        check(bool(caught), f"{label}: the check passes a zeroed DRDB bias "
                            "gradient")
        del g32, gw, g16, bad
    del full, rounded
    torch.cuda.empty_cache()
    print(f"train (c): {time.perf_counter() - t0:.1f} s", flush=True)


def seg_step_inputs():
    """Phase 9 (a)'s seeded mit_b3 ``SegmentationNetwork`` (regularisers
    0) and its batch of 2 at SEG_HW, on the CPU."""
    import torch

    from segmif_tpu_torch.models.network import (SegmentationNetwork,
                                                 init_params)
    from segmif_tpu_torch.train.compare import without_regularisers

    model = without_regularisers(init_params(
        SegmentationNetwork("mit_b3"),
        torch.Generator().manual_seed(SEED + 8)))
    gen = torch.Generator().manual_seed(SEED + 9)
    b, (h, w) = 2, SEG_HW
    data = {"image": torch.rand((b, h, w, 3), generator=gen),
            "label": torch.randint(0, 9, (b, h, w), generator=gen)}
    return model, data


def _ref_seg():
    """Phase 9 (a)'s CPU reference: ``seg_step_grads`` on the CPU and its
    seconds."""
    import torch

    from segmif_tpu_torch.train.compare import seg_step_grads

    model, data = seg_step_inputs()
    t0 = time.perf_counter()
    out = seg_step_grads(model, data, torch.float32, "cpu")
    return (*out, time.perf_counter() - t0)


def seg_step_checks(dev, refs):
    """Phase 9 (a): the seg step, card against CPU (``refs``: the
    ``CpuReferences``), and the BN fold."""
    import torch

    from segmif_tpu_torch.models import segformer_head
    from segmif_tpu_torch.train.compare import (exact_zero_grad, leaf_errors,
                                                seg_step_grads)

    t0 = time.perf_counter()
    model, data = seg_step_inputs()
    b, (h, w) = 2, SEG_HW
    want_m, want, want_s, want_r, cpu_s = refs.get("seg")
    on_card = {k: v.to(dev) for k, v in data.items()}

    def held_to_cpu(got_m, got, got_s):
        a, e = got_m["loss"].item(), want_m["loss"].item()
        top = max(v.abs().max().item() for v in want.values())
        zero = max(max(got[k].abs().max().item(), want[k].abs().max().item())
                   for k in want if exact_zero_grad(k)) / top
        errs = leaf_errors(
            {k: v for k, v in {**got, **got_s}.items()
             if not exact_zero_grad(k)},
            {k: v for k, v in {**want, **want_s}.items()
             if not exact_zero_grad(k)})
        return abs(a - e) / abs(e), zero, errs

    got_m, got, got_s, ratio = seg_step_grads(model, on_card, torch.float32,
                                              dev)
    rel, zero, errs = held_to_cpu(got_m, got, got_s)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    stat_err = max(v for k, v in errs.items() if k.endswith("running_var"))
    print(f"seg (a) f32 card vs CPU, mit_b3 batch {b} {h}x{w}, regularisers "
          f"0: loss relative {rel:.2e} (limit {TRAIN_LOSS_RTOL:g}); "
          f"{len(errs)} leaves and buffers, worst max|err|/max|ref| "
          f"{worst[0][1]:.3e} ({worst[0][0]}), next {worst[1][1]:.3e} "
          f"({worst[1][0]}) (limit {TRAIN_LEAF_RTOL:g}); the five "
          f"exact-zero leaves at most {zero:.2e} of the largest gradient "
          f"(limit 1e-6); running_var {stat_err:.3e}; BN fold ratio "
          f"{ratio:.4f} (limit {SEG_FOLD_LIMIT}; CPU {want_r:.4f}); CPU "
          f"step {cpu_s:.1f} s", flush=True)
    check(rel <= TRAIN_LOSS_RTOL, "seg (a) loss")
    check(worst[0][1] <= TRAIN_LEAF_RTOL, "seg (a) leaves differ")
    check(zero <= 1e-6, "seg (a) an exact-zero leaf is not")
    check(ratio < SEG_FOLD_LIMIT and want_r < SEG_FOLD_LIMIT,
          "seg (a) the running variance is not flax's fold")
    real = segformer_head.update_running_stats
    segformer_head.update_running_stats = \
        lambda bn, mean, var, n: real(bn, mean, var * n / (n - 1), n)
    try:
        bad_m, bad, bad_s, bad_r = seg_step_grads(model, on_card,
                                                  torch.float32, dev)
    finally:
        segformer_head.update_running_stats = real
    _, _, bad_errs = held_to_cpu(bad_m, bad, bad_s)
    bad_stat = max(v for k, v in bad_errs.items()
                   if k.endswith("running_var"))
    print(f"planted fault, seg (a), unbiased running variance: BN fold "
          f"ratio {bad_r:.4f} (the fold check fails, as it must); its "
          f"running_var against the CPU {bad_stat:.3e}, inside the leaf "
          f"limit: why the fold is held on its own", flush=True)
    check(bad_r >= SEG_FOLD_LIMIT, "the seg (a) fold check passes an "
                                   "unbiased running variance")
    print(f"seg (a): {time.perf_counter() - t0:.1f} s", flush=True)


def driver_kernel_checks(dev, res):
    """Phase 9 (b): each float kernel once against its plain version at
    the driver's shapes, under phase 4's limits; the largest errors join
    ``res``."""
    import torch

    from segmif_tpu_torch.kernels.attention import (sr_attention,
                                                    sr_attention_ref)
    from segmif_tpu_torch.kernels.drdb import (drdb_block, drdb_chain,
                                               drdb_growth, drdb_growth_ref,
                                               drdb_tail, drdb_tail_ref)
    from segmif_tpu_torch.kernels.ffm import (crosspath_apply_rows,
                                              crosspath_apply_rows_ref,
                                              crosspath_grams,
                                              crosspath_grams_ref)

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 10)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    def note(name, err):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

    # mit_b3 stage shapes (N, heads, M): 320x320 crops, batch 2 (the
    # fusion phase's guide taps and seg pass); 480x480, batch 4 (the seg
    # phase)
    for label, b, stages in (
            ("fusion 2x320x320", 2, ((6400, 1, 100), (1600, 2, 100),
                                     (400, 5, 100), (100, 8, 100))),
            ("seg 4x480x480", 4, ((14400, 1, 225), (3600, 2, 225),
                                  (900, 5, 225), (225, 8, 225)))):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            tol = SR_TOL[dname]
            worst_ratio = 0.0
            for n, h, m in stages:
                q, k, v = kv_halves(randn, b, n, m, h, 64, dtype)
                ratio, err, diff, ok = held(sr_attention(q, k, v, 0.125),
                                            sr_attention_ref(q, k, v, 0.125),
                                            tol)
                check(ok, f"sr_attention {dname} {label} N={n} M={m} error "
                          f"{err}")
                note("sr_attention", err)
                worst_ratio = max(worst_ratio, ratio)
            print(f"sr_attention {dname} {label}, 4 stage shapes, M = "
                  f"{stages[0][2]}: worst error/limit {worst_ratio:.3f}",
                  flush=True)
    n, c, b = 320 * 320, 64, 2
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x1, x2, s = (randn((b, n, c), dtype) for _ in range(3))
        wp = randn((3, c, 2 * c), torch.float32, c ** -0.5)
        bp = randn((3, 2 * c), torch.float32, 0.1)
        mats = randn((b, 4, c, c), torch.float32, 0.125)
        be = randn((2, c), torch.float32, 0.1)
        lnp = torch.stack([torch.stack([1 + randn((c,), torch.float32, 0.1),
                                        randn((c,), torch.float32, 0.1)])
                           for _ in range(2)])
        got = crosspath_grams(x1, x2, s, wp, bp)
        want = gram_ref(x1, x2, s, wp, bp)
        err, rtol = max_err(got, want), GRAM_RTOL[dname][0]
        scale = want.abs().max().item()
        print(f"ffm_grams {dname} [{b}, {n}, {c}]: max_abs_err {err:.3e} of "
              f"max |gram| {scale:.3e} (rtol {rtol:g})", flush=True)
        check(err <= rtol * scale, f"ffm_grams {dname} {n} error {err}")
        note("ffm_grams", err)
        args = (x1, x2, s, wp, bp, mats, be, lnp)
        tol = APPLY_TOL[dname]
        ratio, err, diff, ok = held(crosspath_apply_rows(*args),
                                    crosspath_apply_rows_ref(*args), tol)
        print(f"ffm_apply {dname} [{b}, {n}, {c}]: "
              f"{verdict(ratio, err, diff, tol)}", flush=True)
        check(ok, f"ffm_apply {dname} {n} error {err}")
        note("ffm_apply", err)
        x, dconvs, (wb, bb) = drdb_inputs(gen, b, 320, 320, dtype, dev)
        shape = f"{dname} [{b}, 64, 320, 320]"
        rs, err, _, _ = compare(f"drdb_growth {shape}",
                                lambda: drdb_growth(x, dconvs),
                                lambda: drdb_growth_ref(x, dconvs),
                                GROWTH_TOL[dname], False)
        note("drdb_growth", err)
        _, err, _, _ = compare(f"drdb_tail {shape}",
                               lambda: drdb_tail(x, rs, wb, bb),
                               lambda: drdb_tail_ref(x, rs, wb, bb),
                               TAIL_TOL[dname], False, x)
        note("drdb_tail", err)
        compare(f"drdb_block {shape} vs drdb_chain",
                lambda: drdb_block(x, dconvs, (wb, bb)),
                lambda: drdb_chain(x, dconvs, (wb, bb)), BLOCK_TOL[dname],
                False, x)
        del x1, x2, s, got, want, args, x, dconvs, rs
        torch.cuda.empty_cache()
    print(f"seg (b): {time.perf_counter() - t0:.1f} s", flush=True)


def trainer_run(dev, counters, totals):
    """Phase 9 (c): ``cli.train.main`` at full width, instrumented from
    outside: every step and inference closure the driver builds is wrapped
    to read the kernel counters around each call (set to 0 just before,
    read just after; these calls make every launch of the run), and the
    trainer's phases are timed."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from segmif_tpu_torch.cli import train as cli_train
    from segmif_tpu_torch.models.network import JointPipeline
    from segmif_tpu_torch.train import interactive

    expect = TRAINER_EXPECT
    seen = {k: 0 for k in expect}
    wall = {}
    ctx = {}

    def timed(name):
        real = getattr(interactive.InteractiveTrainer, name)

        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(self, *args, **kwargs)
            torch.cuda.synchronize()
            wall.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return real, run

    def capture_run(real):
        def run(self, *args, **kwargs):
            ctx["trainer"] = self
            ctx["guide"] = self.train_data.guide.copy()
            return real(self, *args, **kwargs)
        return run

    def snapshot_save(real):
        def save(self, role):
            real(self, role)
            ctx[role] = {k: v.detach().cpu().clone() for k, v in
                         getattr(self.model, role).state_dict().items()}
        return save

    cls = interactive.InteractiveTrainer
    makers = counting_factories(interactive, TRAINER_MAKERS, counters,
                                totals, expect, seen)
    makers.__enter__()
    methods = {}
    for name in ("train_fusion_phase", "regenerate_fused", "train_seg_phase",
                 "evaluate"):
        methods[name], wrapped = timed(name)
        setattr(cls, name, wrapped)
    methods["run"] = cls.run
    cls.run = capture_run(cls.run)
    methods["save_checkpoint"] = cls.save_checkpoint
    cls.save_checkpoint = snapshot_save(cls.save_checkpoint)
    ckdir = tempfile.mkdtemp(prefix="segmif_trainer_")
    t0 = time.perf_counter()
    try:
        result = cli_train.main(TRAINER_ARGS + ["--checkpoint_dir", ckdir])
        total_s = time.perf_counter() - t0
        t = ctx["trainer"]
        print(f"trainer (c) cli.train.main {' '.join(TRAINER_ARGS)}: best "
              f"mIoU {result['best_mIoU']:.4f}, history "
              f"{[round(h['mIoU'], 4) for h in result['history']]}, val "
              f"SSIM {[round(v, 4) for _, v in t.ssim_history]}, "
              f"{total_s:.1f} s in all; phases (s): " + "; ".join(
                  f"{k} {' '.join(f'{v:.2f}' for v in vs)}"
                  for k, vs in wall.items()), flush=True)
        check(0.0 <= result["best_mIoU"] <= 1.0, "trainer best mIoU")
        want_calls = {"fusion r1": 3, "fusion r2": 3, "seg step": 6,
                      "regenerated batch": 6, "eval batch": 2}
        check(seen == want_calls, f"trainer calls {seen}, expected "
                                  f"{want_calls}")
        print(f"trainer (c) launches per call: " + "; ".join(
            f"{k} ({seen[k]} calls) {expect[k]}" for k in expect),
            flush=True)
        check(np.array_equal(t.train_data.guide, ctx["guide"]),
              "the static guide changed")
        check(t.train_data.fused.dtype == np.uint8 and not np.array_equal(
            t.train_data.fused, ctx["guide"]), "the fused images did not "
                                               "change")
        # the role checkpoints: a fresh port model from the two files
        fresh = JointPipeline(t.cfg.backbone)
        for role, name in interactive.ROLE_FILES.items():
            sd = torch.load(Path(ckdir) / name, map_location="cpu",
                            weights_only=True)
            getattr(fresh, role).load_state_dict(sd, strict=True)
            check(all(torch.equal(sd[k], v) for k, v in ctx[role].items()),
                  f"{name} is not the weights saved")
        live = t.model
        live.seg.load_state_dict(ctx["seg"])    # the best-mIoU weights
        fresh.to(dev, memory_format=torch.channels_last).eval()
        live.eval()
        probe = torch.rand((1, H, W, 3), generator=torch.Generator()
                           .manual_seed(SEED + 11)).to(dev)
        with torch.inference_mode():
            a, b = fresh.seg(probe), live.seg(probe)
            fa, fb = fresh.fuse(probe[..., :1], probe)[1], \
                live.fuse(probe[..., :1], probe)[1]
        err = max(max_err(a, b) / b.abs().max().item(),
                  max_err(fa, fb) / fb.abs().max().item())
        print(f"trainer (c) role checkpoints reloaded into a fresh port "
              f"model: f32 logits and fused Y against the trainer's, "
              f"max_abs_err {err:.3e} of the largest magnitude (limit 1e-6:"
              f" the same weights and kernels)", flush=True)
        check(err <= 1e-6, "the reloaded checkpoints give other outputs")
    finally:
        makers.__exit__(None, None, None)
        for name, real in methods.items():
            setattr(cls, name, real)
        shutil.rmtree(ckdir, ignore_errors=True)
        ctx.clear()
        torch.cuda.empty_cache()


# a bf16 mit_b3 seg step's sr-attention backward: both passes once per
# block (3 + 4 + 18 + 3), no plain VJP
SEG_BLOCKS = 28
SEG_BWD_EXPECT = {"sr_attention_bwd_dq": SEG_BLOCKS,
                  "sr_attention_bwd_dkv": SEG_BLOCKS, "plain_vjp": 0}


def seg_step_timing(dev):
    """Phase 9 (d): the seg step alone at the seg phase's crops."""
    import warnings

    import torch

    from segmif_tpu_torch.config import OptimizerConfig
    from segmif_tpu_torch.kernels import _build
    from segmif_tpu_torch.kernels import attention as katt
    from segmif_tpu_torch.models.network import (SegmentationNetwork,
                                                 init_params)
    from segmif_tpu_torch.train.optimizer import adamw_poly_grouped
    from segmif_tpu_torch.train.state import SegTrainState
    from segmif_tpu_torch.train.steps import make_seg_train_step

    t0 = time.perf_counter()
    model = init_params(SegmentationNetwork("mit_b3"),
                        torch.Generator().manual_seed(SEED + 12))
    opt = OptimizerConfig()
    tx = adamw_poly_grouped([n for n, _ in model.named_parameters()],
                            opt.learning_rate, opt.warmup_iter,
                            opt.max_iters, opt.weight_decay)
    step = make_seg_train_step(model, tx)
    state = SegTrainState.create(model, tx)
    gen = torch.Generator().manual_seed(SEED + 13)
    b, c = SEG_BATCH, SEG_CROP
    batch = {"image": torch.rand((b, c, c, 3), generator=gen).to(dev),
             "label": torch.randint(0, 9, (b, c, c), generator=gen).to(dev)}
    losses = [step(state, batch, SEED)]        # step 1, warm-up
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")        # step 2, warm-up, untimed
        torch.cuda.set_sync_debug_mode("warn")
        try:
            losses.append(step(state, batch, SEED))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in syncs if "called a synchronizing" in str(w.message)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(3):                         # steps 3-5, timed
        losses.append(step(state, batch, SEED))
    ev[1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    step_ms = ev[0].elapsed_time(ev[1]) / 3

    def timed(real, spans):
        def fn(*a, **k):
            s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s_.record()
            out = real(*a, **k)
            e_.record()
            spans.append((s_, e_))
            return out
        return fn

    reals = (_build.plain_vjp, katt.sr_attention_backward)
    recomputes, kernel_bwds, updates = [], [], []
    _build.plain_vjp = timed(reals[0], recomputes)
    katt.sr_attention_backward = timed(reals[1], kernel_bwds)
    tx.update = timed(tx.update, updates)
    for counter in (katt.sr_attention_bwd_dq, katt.sr_attention_bwd_dkv):
        counter.launches = 0
    katt._SrAttentionFn.plain_backwards = 0
    try:
        ev[2].record()
        t_host = time.perf_counter()
        losses.append(step(state, batch, SEED))  # step 6
        host_ms = (time.perf_counter() - t_host) * 1e3
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        _build.plain_vjp, katt.sr_attention_backward = reals
        del tx.update
    backward = {"sr_attention_bwd_dq": katt.sr_attention_bwd_dq.launches,
                "sr_attention_bwd_dkv": katt.sr_attention_bwd_dkv.launches,
                "plain_vjp": katt._SrAttentionFn.plain_backwards}
    recompute = sum(a.elapsed_time(e) for a, e in recomputes)
    kernel_bwd = sum(a.elapsed_time(e) for a, e in kernel_bwds)
    update_ms = sum(a.elapsed_time(e) for a, e in updates)
    inst = ev[2].elapsed_time(ev[3])
    vals = [v["loss"].item() for v in losses]
    print(f"seg (d) mit_b3 batch {b} {c}x{c}, bf16 compute, f32 master "
          f"weights, 3-group AdamW, drop-path and dropout on: loss "
          f"{' '.join(f'{v:.5f}' for v in vals)}; ms per step "
          f"{step_ms:.2f} (steps 3-5 after two warm-up steps, CUDA events, "
          f"host-paced), {b * 1e3 / step_ms:.3f} seg train pairs/s; peak "
          f"device memory of steps 3-5 above the model and batch "
          f"{peak / 2**30:.2f} GiB; step 6 {inst:.2f} ms of which "
          f"sr-attention's kernel backward {kernel_bwd:.2f} ms "
          f"({kernel_bwd / inst:.3f} of the step, {len(kernel_bwds)} calls;"
          f" launches {backward}, expected {SEG_BWD_EXPECT}), the plain "
          f"recompute backward {recompute:.2f} ms ({len(recomputes)} "
          f"recomputes) and the AdamW update "
          f"{update_ms:.2f} ms ({update_ms / inst:.3f}); the host returned "
          f"from step 6 after {host_ms:.2f} ms (the step never waits for "
          f"the device, so a host time near the step's is a host-bound "
          f"step); synchronizing CUDA calls in step 2 "
          f"(torch.cuda.set_sync_debug_mode): {len(syncs)}", flush=True)
    check(all(math.isfinite(v) for v in vals), "seg losses not finite")
    check(backward == SEG_BWD_EXPECT and len(kernel_bwds) == SEG_BLOCKS,
          f"seg step kernel backwards {backward} in {len(kernel_bwds)} "
          f"calls, expected {SEG_BWD_EXPECT} in {SEG_BLOCKS}")
    check(not syncs, f"the seg step waits for the device: "
                     f"{syncs[0].message if syncs else ''}")
    check(int(state.step.item()) == state.host_step == 6, "seg step counts")
    del model, state, step, batch
    torch.cuda.empty_cache()
    print(f"seg (d): {time.perf_counter() - t0:.1f} s", flush=True)


def bf16_summary(got, want) -> str:
    """Cosines and norm ratios of a step's gradients against f32's."""
    from segmif_tpu_torch.train.compare import (leaf_cosines, norm_ratios,
                                                overall_cosine)

    cos, ratio = leaf_cosines(got, want), norm_ratios(got, want)
    low = min(cos, key=cos.get)
    return (f"cosine {overall_cosine(got, want):.4f} overall, lowest leaf "
            f"{cos[low]:.4f} ({low}), median "
            f"{sorted(cos.values())[len(cos) // 2]:.4f}, "
            f"{sum(c >= BF16_TRAIN_LEAF_COS for c in cos.values())} of "
            f"{len(cos)} at or above {BF16_TRAIN_LEAF_COS}; norm ratio "
            f"{min(ratio.values()):.3f}-{max(ratio.values()):.3f}")


def bf16_faults(got, want, kind: str) -> list:
    """The (c) limits that the bf16 gradients break: at "full" the norm
    ratios, at "held" the ratios and the cosines."""
    from segmif_tpu_torch.train.compare import (leaf_cosines, norm_ratios,
                                                overall_cosine)

    lo, hi = BF16_TRAIN_RATIO[kind]
    out = [f"{k} norm ratio {r:.4f} outside [{lo:g}, {hi:g}]"
           for k, r in norm_ratios(got, want).items() if not lo <= r <= hi]
    if kind == "held":
        out += [f"{k} cosine {c:.4f} < {BF16_TRAIN_LEAF_COS}"
                for k, c in leaf_cosines(got, want).items()
                if c < BF16_TRAIN_LEAF_COS]
        whole = overall_cosine(got, want)
        if whole < BF16_TRAIN_ALL_COS:
            out.append(f"overall cosine {whole:.4f} < {BF16_TRAIN_ALL_COS}")
    return out


def cpu_model() -> str:
    """The host's CPU model and core count, for host-paced numbers."""
    import os

    try:
        names = {ln.split(":", 1)[1].strip() for ln in
                 Path("/proc/cpuinfo").read_text().splitlines()
                 if ln.startswith("model name")}
    except OSError:
        names = set()
    return f"{', '.join(sorted(names)) or 'CPU model unknown'}, " \
        f"{os.cpu_count()} cores"


def first_error(log: str) -> str:
    """The first line of a compiler's output that names an error."""
    lines = log.splitlines()
    return next((ln for ln in lines if "error" in ln), lines[-1])[:200]


def disk_to_disk(dev, counters, totals, card: str):
    """Phase 10: the disk-to-disk path at mit_b3 480x640 (see the module
    docstring and ``segmif_tpu_torch.disk_check``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from segmif_tpu_torch import disk_check as dc
    from segmif_tpu_torch.cli import test_fusion
    from segmif_tpu_torch.data.datasets import FusionFolderDataset
    from segmif_tpu_torch.train import interactive, steps

    expect = {**TRAINER_EXPECT,
              "test_fusion batch": {"sr_attention": 7, **FLOAT_PATH},
              "static guide taps": {"sr_attention": 7, **SEG_ONLY},
              "static guide batch": {"sr_attention": 0, **FLOAT_PATH},
              "test_segmentation batch": {"sr_attention": 28, **SEG_ONLY}}
    seen = {}
    host = cpu_model()

    def count_cli():
        stack = contextlib.ExitStack()
        stack.enter_context(counting_factories(
            steps, {"make_fuse_fn": "test_fusion batch",
                    "make_segment_fn": "test_segmentation batch"},
            counters, totals, expect, seen))
        real = test_fusion.make_static_guide_fuse_fn

        def static(*args, **kwargs):
            fuse = counted("static guide taps", real, counters, totals,
                           expect, seen)(*args, **kwargs)
            return counted("static guide batch", fuse, counters, totals,
                           expect, seen)

        stack.enter_context(dc.patched(test_fusion,
                                       "make_static_guide_fuse_fn", static))
        return stack

    tmp = Path(tempfile.mkdtemp(prefix="segmif_d2d_"))
    deterministic = torch.backends.cudnn.deterministic
    try:
        t0 = time.perf_counter()
        train = dc.write_folder(tmp / "train", D2D_TRAIN, (H, W), 0)
        val = dc.write_folder(tmp / "val", D2D_VAL, (H, W), 1,
                              rgb_labels=True)
        print(f"d2d folders: {D2D_TRAIN} train pairs (gray labels) and "
              f"{D2D_VAL} val pairs (RGB labels, the id in R), uint8 PNGs "
              f"at {H}x{W} named frame<i>.png, written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        # (a) the decoders
        for w in (train, val):
            pr = dc.folder_problems(FusionFolderDataset(w["root"]), w)
            check(not pr, f"d2d (a) FusionFolderDataset {w['root'].name}: "
                          f"{pr[:4]}")
        dec = dc.decoder_checks([train, val], threads=D2D_THREADS)
        check(not dec["problems"], f"d2d (a) decoders: "
                                   f"{dec['problems'][:4]}")
        native_ok = dec["native_error"] is None
        rates = "; ".join(f"{k} {v:.1f}" if v else f"{k} unavailable"
                          for k, v in dec["rates"].items())
        print(f"d2d (a) every decoder returns the written bytes, and "
              f"FusionFolderDataset the written arrays in natural order; "
              f"decode images/s on {D2D_THREADS} threads ({host}): "
              f"{rates}", flush=True)
        if not native_ok:
            print(f"d2d (a) the native decoder did not build, so PIL "
                  f"decodes every file and the trainer reads through "
                  f"Python threads (--no_native_loader): "
                  f"{first_error(dec['native_error'])}",
                  flush=True)

        # (b) the trainer on the folders
        torch.backends.cudnn.deterministic = True
        ck = tmp / "ck"
        args = D2D_TRAIN_ARGS + (
            [] if native_ok else ["--no_native_loader"])
        t0 = time.perf_counter()
        with counting_factories(interactive, TRAINER_MAKERS, counters,
                                totals, expect, seen):
            tr = dc.trainer_check(train, val, ck, D2D_BACKBONE, "bfloat16",
                                  dev, args)
        check(not tr["problems"], f"d2d (b) {tr['problems']}")
        calls = {k: seen.get(k, 0) for k in TRAINER_EXPECT}
        iters = {k: int(args[args.index(f"--{k}_iters") + 1])
                 for k in ("fusion", "seg")}
        want = {"fusion r1": iters["fusion"], "fusion r2": 0,
                "seg step": iters["seg"],   # regeneration batch 4
                "regenerated batch": -(-D2D_TRAIN // 4) - (-D2D_VAL // 4),
                "eval batch": -(-D2D_VAL // 4)}
        check(calls == want, f"d2d (b) trainer calls {calls}, expected "
                             f"{want}")
        fresh = tr["fresh"]
        print(f"d2d (b) cli.train.main --data_root --val_root --streaming "
              f"--dump_fused_images (a flag of the port's cli.train) "
              f"--rounds 1 {' '.join(args)} {D2D_BACKBONE} bf16: best mIoU "
              f"{tr['result']['best_mIoU']:.4f}, "
              f"{time.perf_counter() - t0:.1f} s; launches per call as "
              f"phase 9 (c), calls {calls}; the val memmap is _to_uint8 of "
              f"the regenerated arrays and the dumped PNGs fused_to_uint8 "
              f"of them, bit for bit; a fresh generate_fused from "
              f"fusion_params.pth differs on a share {fresh['share']:.3g} "
              f"of the val bytes, by at most {fresh['max']} (limit "
              f"{D2D_FRESH_SHARE}: deterministic kernels and cuDNN)",
              flush=True)
        check(fresh["share"] <= D2D_FRESH_SHARE,
              "d2d (b) a fresh regeneration differs from the trainer's")

        # (c) test_fusion, default and static-guide modes; (d)
        # test_segmentation on the default mode's folder
        guide = val["root"] / "Mask2" / "frame0.png"
        with count_cli():
            fd = dc.fusion_cli_check(val, tmp / "fused", ck, D2D_BACKBONE,
                                     D2D_BATCH, "bfloat16", dev)
            fs = dc.fusion_cli_check(val, tmp / "fused_static", ck,
                                     D2D_BACKBONE, D2D_BATCH, "bfloat16",
                                     dev, static_guide=guide,
                                     reference_quantization=True)
            sg = dc.segmentation_cli_check(tmp / "fused", val, ck,
                                           D2D_BACKBONE, D2D_BATCH,
                                           "bfloat16", dev,
                                           tmp / "val_seg.txt")
        for name, r in (("default", fd), ("static guide", fs),
                        ("test_segmentation", sg)):
            check(not r["problems"], f"d2d {name}: {r['problems']}")
        differ = float((fd["pngs"] != fs["pngs"]).mean())
        check(differ > 0, "d2d (c) the static-guide PNGs equal the default "
                          "mode's")
        print(f"d2d (c) cli.test_fusion.main over {D2D_VAL} val pairs, "
              f"batch {D2D_BATCH}, bf16: default mode (single rounding) "
              f"and --static_guide {guide.name} --reference_quantization: "
              f"the PNGs are fused_to_uint8 of generate_fused in memory, "
              f"bit for bit, the writer handed only real images; launches "
              f"per batch {expect['test_fusion batch']} (default), "
              f"{expect['static guide batch']} (static guide, after "
              f"{expect['static guide taps']} once for the taps); the two "
              f"modes' bytes differ on a share {differ:.4f}", flush=True)
        res = sg["result"]
        print(f"d2d (d) cli.test_segmentation.main on the default mode's "
              f"PNGs: mIoU {res['mIoU']:.4f} pixel_acc "
              f"{res['pixel_acc']:.4f}, per-class IoU and confusion equal "
              f"to segmentation_eval on the decoded arrays in memory; "
              f"launches per batch {expect['test_segmentation batch']}",
              flush=True)

        # the planted faults, which must fail the unchanged checks
        for fault, pr in dc.planted_faults(train, val, tmp / "planted", ck,
                                           D2D_BACKBONE, "bfloat16",
                                           dev).items():
            check(bool(pr), f"planted fault, d2d {fault}: the checks "
                            f"passed")
            print(f"planted fault, d2d {fault}: {pr[0][:160]} (the check "
                  f"fails, as it must)", flush=True)
        torch.backends.cudnn.deterministic = deterministic

        # (e) timing, informational
        timed = dc.write_folder(tmp / "timed", D2D_TIMED, (H, W), 2)
        events = []

        def timing_make(*args, **kwargs):
            fuse = counting_make(*args, **kwargs)

            def call(*a):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fuse(*a)
                end.record()
                events.append((start, end))
                return out
            return call

        runs = []
        with count_cli(), dc.patched(steps, "make_fuse_fn",
                                     timing_make) as counting_make:
            for r in range(2):
                events.clear()
                out = dc.fusion_cli_check(timed, tmp / f"fused_timed{r}", ck,
                                          D2D_BACKBONE, D2D_BATCH,
                                          "bfloat16", dev)
                check(not out["problems"], f"d2d (e) {out['problems']}")
                torch.cuda.synchronize()
                busy = sum(a.elapsed_time(b) for a, b in events) / 1e3
                runs.append((D2D_TIMED / out["seconds"],
                             busy / out["seconds"], out["seconds"],
                             out["read_wait"], out["write"]))
        model = test_fusion.build_model(D2D_BACKBONE, 9, str(ck))
        fuse = steps.make_fuse_fn(model, torch.bfloat16, dev)
        batches = [tuple(torch.from_numpy(a[s:s + D2D_BATCH]).to(dev)
                         .float() / 255.0 for a in
                         (timed["ir"][..., None], timed["vis"],
                          timed["guide"]))
                   for s in range(0, D2D_TIMED, D2D_BATCH)]
        cycle = itertools.cycle(batches)
        ms = time_fn(lambda: fuse(*next(cycle)), 2 * len(batches),
                     hold=False)
        print(f"d2d (e) cli.test_fusion disk to disk, {D2D_TIMED} pairs at "
              f"{H}x{W}, batch {D2D_BATCH}, bf16, {D2D_BACKBONE} ({card}; host "
              f"{host}): " + "; ".join(
                  f"run {i + 1}: {p:.3f} pairs/s ({t:.3f} s: waiting for "
                  f"the prefetch threads' reads {r:.3f}, quantise + encode "
                  f"+ write {wr:.3f}, upload + fuse + fetch and the rest "
                  f"{t - r - wr:.3f}), device busy share {b:.4f}"
                  for i, (p, b, t, r, wr) in enumerate(runs))
              + f"; fuse only on the same arrays already on the card: "
              f"{D2D_BATCH * 1e3 / ms:.3f} pairs/s ({ms:.2f} ms per batch, "
              f"CUDA events, host-paced)", flush=True)
        print(f"d2d: launches of phase 10 by call: {seen}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# Phase 11: the fusion variants and the accuracy artifact. Each variant
# serves with the sr-attention, DRDB growth and DRDB tail kernels; only
# 'both' runs the FFM kernels, and 'both' with return_attention leaves
# them for the modular path, whose maps can be read out.
VARIANTS = ("moam", "soam", "concat", "add", "average", "none")
VARIANT_EXPECT = {"sr_attention": 35, "ffm_grams": 0, "ffm_apply": 0,
                  "drdb_growth": 4, "drdb_tail": 4, "drdb_int8_growth": 0,
                  "drdb_int8_tail": 0}
VARIANT_INT8 = "average"    # also served after quantize_for_serving


def _pairs(gen, n, b, hw, dev):
    import torch

    return [(torch.rand((b, *hw, 1), generator=gen).to(dev),
             torch.rand((b, *hw, 3), generator=gen).to(dev))
            for _ in range(n)]


def _reset(counters):
    for c in counters.values():
        c.launches = 0


def serve_checked(label, serve, reqs, counters, totals, expect):
    """Serve ``reqs`` one by one, each request's launches held to
    ``expect`` (when given) and added to ``totals``; outputs finite,
    fused_rgb in [0, 1], predictions in [0, 9)."""
    import torch

    for i, (ir, vis) in enumerate(reqs):
        _reset(counters)
        rgb, pred = serve(ir, vis)
        if ir.is_cuda:
            torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        if expect is not None:
            check(counts == expect, f"{label} request {i}: launches "
                                    f"{counts}, expected {expect}")
            for k, v in counts.items():
                totals[k] += v
        check(rgb.shape == (*ir.shape[:3], 3) and pred.shape == ir.shape[:3],
              f"{label} output shapes")
        check(bool(torch.isfinite(rgb).all()), f"{label} rgb not finite")
        check(rgb.min().item() >= 0.0 and rgb.max().item() <= 1.0,
              f"{label} fused_rgb outside [0,1]")
        check(pred.min().item() >= 0 and pred.max().item() < 9,
              f"{label} pred outside [0,9)")
    return counts


def variant_serving(dev, counters, totals, backbone="mit_b3", batch=BATCH,
                    hw=(H, W), n_req=REQUESTS):
    """Phase 11 (a) and (f): each variant served by ``make_serving_fn`` in
    default mode, bf16, with its launches per request, peak memory and
    pairs/s; then ``VARIANT_INT8`` once more after
    ``quantize_for_serving``."""
    import torch

    from segmif_tpu_torch.models.network import JointPipeline, init_params
    from segmif_tpu_torch.serving import make_serving_fn, quantize_for_serving

    cuda = dev.type == "cuda"
    gen = torch.Generator().manual_seed(SEED + 11)
    reqs = _pairs(gen, n_req, batch, hw, dev)
    int8_expect = {**VARIANT_EXPECT, "drdb_growth": 0, "drdb_tail": 0,
                   "drdb_int8_growth": 4, "drdb_int8_tail": 4}
    for v in VARIANTS + ("int8 " + VARIANT_INT8,):
        name = v.split()[-1]
        model = init_params(JointPipeline(backbone, interaction=name),
                            torch.Generator().manual_seed(SEED + 12)
                            ).eval().to(torch.bfloat16)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        if v.startswith("int8"):
            serve = make_serving_fn(model, int8_calibration=reqs[0],
                                    device=dev)
        else:
            serve = make_serving_fn(model, device=dev)
        counts = serve_checked(f"variant {v}", serve, reqs, counters, totals,
                               (int8_expect if v.startswith("int8")
                                else VARIANT_EXPECT) if cuda else None)
        rate = ""
        if cuda:
            batches = itertools.cycle(reqs)
            ms = time_fn(lambda: serve(*next(batches)), 2 * n_req,
                         hold=False)
            rate = (f"; {batch * 1e3 / ms:.3f} pairs/s ({ms:.2f} ms per "
                    f"batch, CUDA events after warm-up, host-paced); peak "
                    f"device memory "
                    f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        print(f"variant {v} ({backbone}, batch {batch}, {hw[0]}x{hw[1]}, "
              f"bf16, default mode): {n_req} requests, launches per request "
              f"{counts}; outputs finite, fused_rgb in [0,1], pred in [0,9)"
              f"{rate}", flush=True)
        del serve, model
    del reqs


def pipe_error(got, want):
    """(largest |got - ref|, largest |ref|)."""
    return max_err(got.cpu(), want), want.abs().max().item()


def held_pipe(label, pairs) -> bool:
    """Each (name, got, ref) within PIPE_RTOL[name] of the reference's
    largest magnitude; prints the errors. Returns whether all are held."""
    import torch

    ok = True
    for name, got, want in pairs:
        err, scale = pipe_error(got, want)
        ok &= bool(torch.isfinite(got).all()) and \
            err <= PIPE_RTOL[name] * scale
        print(f"{label} {name} {tuple(got.shape)}: max_abs_err {err:.3e} of "
              f"max |ref| {scale:.3e} (rtol {PIPE_RTOL[name]:g})", flush=True)
    return ok


def _wrong_axis_softmax(ctx, num_heads):
    """A planted fault: the per-head context softmax over the value
    feature (axis -1) instead of the key feature."""
    import torch

    c = ctx.shape[-1]
    blk = torch.arange(c, device=ctx.device) // (c // num_heads)
    mask = blk[:, None] == blk[None, :]
    return torch.softmax(ctx.masked_fill(~mask, float("-inf")), dim=-1)


def variant_inputs(backbone="mit_b3", hw=(H, W)):
    """Phase 11 (b)'s seeded batch-1 pair and stage-1/2 taps (on the CPU),
    and its models: each variant's ``JointPipeline``, the short tail and
    ``SimpleFusionNetwork`` as (name, a function making it)."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.fusion import (FusionNetwork,
                                                SimpleFusionNetwork)
    from segmif_tpu_torch.models.mit import MIT_VARIANTS
    from segmif_tpu_torch.models.network import JointPipeline, init_params

    gen = torch.Generator().manual_seed(SEED + 13)
    (ir, vis), = _pairs(gen, 1, 1, hw, "cpu")
    dims = MIT_VARIANTS[backbone].embed_dims
    taps = (torch.randn((1, hw[0] // 4, hw[1] // 4, dims[0]), generator=gen),
            torch.randn((1, hw[0] // 8, hw[1] // 8, dims[1]), generator=gen))
    models = [(v, lambda v=v: init_params(
        JointPipeline(backbone, interaction=v),
        torch.Generator().manual_seed(SEED + 14)).eval()) for v in VARIANTS]
    # SimpleFusionNetwork at the reference modules' scale: it clips to
    # [0, 1] before its stretch, so its largest magnitude is 1 whatever it
    # clipped, and at the JAX initialisers' scale (values of order 10-100
    # before the clip) the limit would hold their f32 sums to 1e-4
    # absolute
    models += [
        ("short tail", lambda: init_params(
            FusionNetwork(tap_channels=dims[:2], tail="short"),
            torch.Generator().manual_seed(SEED + 15)).eval()),
        ("SimpleFusionNetwork", lambda: drift.init_reference_scale(
            SimpleFusionNetwork(),
            torch.Generator().manual_seed(SEED + 16)).eval())]
    return (ir, vis, taps), models


def _variant_args(name, ir, vis, taps):
    """A phase 11 (b) model's inputs: the pair for a pipeline; the IR and
    VIS Y (and the taps, for the short tail) for a fusion network."""
    if name in VARIANTS:
        return ir, vis
    return (ir, vis[..., :1]) + (taps if name == "short tail" else ())


def _ref_variants():
    """Phase 11 (b)'s CPU references: {name: the model's f32 outputs on
    the CPU} and their seconds."""
    import torch

    t0 = time.perf_counter()
    (ir, vis, taps), models = variant_inputs()
    out = {}
    for name, build in models:
        with torch.inference_mode():
            out[name] = build()(*_variant_args(name, ir, vis, taps))
    return out, time.perf_counter() - t0


def variant_card_vs_cpu(dev, refs):
    """Phase 11 (b) and (d): each variant's batch-1 f32 pipeline, the short
    tail and ``SimpleFusionNetwork`` on the card against the same weights
    on the CPU (``refs``: the ``CpuReferences``), under PIPE_RTOL; then the
    planted faults, which must fail the same check."""
    import torch

    from segmif_tpu_torch.kernels import attention
    from segmif_tpu_torch.models.network import init_params

    cl = torch.channels_last
    t0 = time.perf_counter()
    (ir, vis, taps), models = variant_inputs()
    cpu, cpu_s = refs.get("variants")
    faults, nets = {}, {}
    for name, build in models:
        net = build().to(dev, memory_format=cl)
        with torch.inference_mode():
            got = net(*(a.to(dev) for a in _variant_args(name, ir, vis,
                                                         taps)))
        if name in VARIANTS:
            (_, y, logits), (_, y_cpu, l_cpu) = got, cpu[name]
            check(held_pipe(f"variant {name} b1 f32 card vs CPU",
                            (("fused_y", y, y_cpu),
                             ("logits", logits, l_cpu))),
                  f"variant {name}: card and CPU differ")
            if name in ("moam", "average"):
                faults[name] = (net, y_cpu)
        else:
            check(held_pipe(f"{name} b1 f32 card vs CPU",
                            (("fused_y", got, cpu[name]),)),
                  f"{name}: card and CPU differ")
            nets[name] = net
        del net
    print(f"phase 11 (b): card vs CPU, {time.perf_counter() - t0:.1f} s "
          f"(the CPU references {cpu_s:.1f} s, in their own process)",
          flush=True)

    # (d) planted faults, each against the CPU reference of (b)
    def fails(label, run, want):
        with torch.inference_mode():
            got = run()
        ok = held_pipe(f"planted fault, {label}:", (("fused_y", got, want),))
        check(not ok, f"the card-vs-CPU check passes {label}")
        print(f"planted fault, {label}: the check fails, as it must",
              flush=True)

    model, y_cpu = faults["moam"]
    real = attention._blockdiag_softmax
    attention._blockdiag_softmax = _wrong_axis_softmax
    try:
        fails("moam with the context softmax over the wrong axis",
              lambda: model.fuse(ir.to(dev), vis.to(dev))[1], y_cpu)
    finally:
        attention._blockdiag_softmax = real
    model, y_cpu = faults["average"]
    f = model.fusion
    sd = {k: v.clone() for k, v in f.state_dict().items()}
    swapped = {k.replace("att1.", "att@.").replace("att2.", "att1.")
               .replace("att@.", "att2."): v for k, v in sd.items()}
    f.load_state_dict(swapped)
    fails("'average' with att1 and att2 swapped",
          lambda: model.fuse(ir.to(dev), vis.to(dev))[1], y_cpu)
    f.load_state_dict(sd)
    net = nets["short tail"]
    net.conv22 = init_params(torch.nn.Conv2d(1, 1, 3, padding=1),
                             torch.Generator().manual_seed(SEED + 17)
                             ).to(dev, memory_format=cl)
    fails("a short tail that runs conv22",
          lambda: net(ir.to(dev), vis[..., :1].to(dev),
                      *(t.to(dev) for t in taps)), cpu["short tail"])
    del faults, nets, model, net


def attention_maps(dev, counters, totals, backbone="mit_b3", hw=(H, W)):
    """Phase 11 (c): 'both' with ``return_attention`` (the modular path,
    no FFM launch) against the folded FFM-kernel path on the same weights
    and taps, f32 batch 1 on the card, under PIPE_RTOL; two [B, 8, 8, 8]
    context maps, each head's a softmax over the key feature."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.fusion import FusionNetwork
    from segmif_tpu_torch.models.mit import MIT_VARIANTS
    from segmif_tpu_torch.models.network import JointPipeline

    cuda = dev.type == "cuda"
    cl = torch.channels_last
    model = drift.init_reference_scale(
        JointPipeline(backbone), torch.Generator().manual_seed(SEED + 18))
    maps_net = FusionNetwork(tap_channels=MIT_VARIANTS[backbone]
                             .embed_dims[:2], return_attention=True)
    maps_net.load_state_dict(model.fusion.state_dict())
    model.eval().to(dev, memory_format=cl)
    maps_net.eval().to(dev, memory_format=cl)
    (ir, vis), = _pairs(torch.Generator().manual_seed(SEED + 19), 1, 1, hw,
                        dev)
    seen = {}
    with torch.inference_mode():
        taps = model.guide_taps_raw(vis)
        for label, net in (("folded", model.fusion), ("modular", maps_net)):
            _reset(counters)
            seen[label] = net(ir, vis[..., :1], *taps)
            if cuda:
                torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            ffm = {k: counts[k] for k in ("ffm_grams", "ffm_apply")}
            want = 2 if label == "folded" else 0
            if cuda:
                check(ffm == {"ffm_grams": want, "ffm_apply": want},
                      f"'both' {label}: FFM launches {ffm}, expected {want}")
                for k, v in counts.items():
                    totals[k] += v
            print(f"'both' {label} fusion net: launches {counts}",
                  flush=True)
    y_mod, maps = seen["modular"]
    check(held_pipe("'both' return_attention (modular) vs folded FFM "
                    "kernels, b1 f32", (("fused_y", y_mod,
                                         seen["folded"].cpu()),)),
          "'both' with return_attention differs from the folded path")
    check(len(maps) == 2, f"{len(maps)} attention maps, expected 2")
    for i, m in enumerate(maps, start=1):
        check(m.shape == (1, 8, 8, 8), f"map {i} shape {tuple(m.shape)}")
        col = (m.sum(-2) - 1).abs().max().item()
        check(bool(torch.isfinite(m).all()) and col < 1e-5,
              f"map {i}: columns sum to 1 within {col:.2e}")
        print(f"attention map round {i}: {tuple(m.shape)}, values in "
              f"[{m.min().item():.4f}, {m.max().item():.4f}], each "
              f"column's sum within {col:.2e} of 1", flush=True)


def overfit_cut(seed, dev, rounds, iters=None):
    """``segmif_tpu_torch.accuracy``'s overfit at ``seed`` cut to
    ``rounds`` rounds and, with ``iters`` = (fusion, seg), to that many
    steps of round 1's phases. Returns (the trainer after its run, the
    training samples)."""
    import tempfile

    from segmif_tpu_torch import accuracy
    from segmif_tpu_torch.train.interactive import InteractiveTrainer

    train_ds, val_ds = accuracy.overfit_data()
    with tempfile.TemporaryDirectory() as ckpt:
        cfg = accuracy.overfit_config(seed, ckpt)
        cfg.rounds = rounds
        if iters is not None:
            cfg.fusion.iters_round1 = iters[0]
            cfg.seg.iters = cfg.seg.eval_every = iters[1]
        trainer = InteractiveTrainer(cfg, train_ds, val_ds, device=dev)
        trainer.run()
    return trainer, train_ds


# Phase 11 (e): the overfit's round 1 cut to these fusion and seg steps
# (600 and 200 in accuracy.py). In two whole runs on the H100 the round-1
# fusion loss (logged every 10 steps; head 5.46-5.48) was below a fifth of
# its head by step 50-90, and every logged loss after step 250 below 1.3
# (a third of the head is 1.82), so 300 steps keep both criteria with
# margin; the seg steps, where the mIoU is made, stay whole.
ACCURACY_ITERS = (300, 200)


def accuracy_checks(dev):
    """Phase 11 (e): ``segmif_tpu_torch.accuracy``'s overfit at one seed,
    its first round only and that cut to ACCURACY_ITERS (the second round,
    60 fusion and 200 seg steps whose fields are chaotic and not gated, is
    cut to keep the script within half its time limit;
    ``ACCURACY_torch.json`` holds both whole rounds of four seeds), under
    tests/test_learning.py's stable criteria; then the drift section with
    int8, under drift's limits."""
    from segmif_tpu_torch import accuracy

    t0 = time.perf_counter()
    trainer, train_ds = overfit_cut(1, dev, rounds=1, iters=ACCURACY_ITERS)
    f = accuracy.overfit_fields(trainer, train_ds)
    overfit_s = time.perf_counter() - t0
    s1 = [loss for rnd, _, loss in trainer.seg_loss_history if rnd == 1]
    print(f"accuracy overfit, seed 1, round 1 ({overfit_s:.1f} s): "
          f"{json.dumps(accuracy.rounded(f))}; seg loss round 1 "
          f"{sum(s1[:3]) / 3:.4f} -> {sum(s1[-3:]) / 3:.4f}", flush=True)
    head = f["fusion_r1_head"]
    check(f["fusion_r1_min"] < head / 5, "overfit: the round-1 fusion loss "
          "never reached a fifth of its head")
    check(f["fusion_r1_tail"] < head / 3, "overfit: the round-1 fusion "
          "loss did not stay below a third of its head")
    check(f["best_mIoU"] > f["class_prior_mIoU"] + 0.10,
          "overfit: best mIoU not 0.10 above the class prior")
    check(sum(s1[-3:]) < sum(s1[:3]), "overfit: the seg loss did not fall "
          "within round 1")
    t0 = time.perf_counter()
    d = accuracy.run_drift(True, dev)
    print(f"accuracy drift (mit_b1, batch 2, 480x640, reference-scale "
          f"weights; {time.perf_counter() - t0:.1f} s): {json.dumps(d)}",
          flush=True)
    for pair, vals in d.items():
        check(vals["within_limits"], f"drift {pair} outside drift's limits")


# Phase 12: the stretch (mit_b5 at 1080x1920), serving export and the
# trainer's repeatability. The kernels at the stretch's shapes are held to
# phase 4's limits (SR_TOL, GRAM_RTOL, APPLY_TOL, GROWTH_TOL, TAIL_TOL,
# BLOCK_TOL); their times are CUDA events over 3 calls after a warm-up.
STRETCH_HW = (1080, 1920)
STRETCH_CLASSES = 15
# mit_b5 at 1080x1920, per stage: (tokens N, key rows M, heads); D = 64
STRETCH_SR = ((129600, 1980, 1), (32400, 1980, 2), (8160, 2040, 5),
              (2040, 2040, 8))
# launches per stretch pair: the guide taps (stages 1-2, 3 + 6 blocks) and
# the seg pass (3 + 6 + 40 + 3 blocks) of mit_b5
STRETCH_PAIR = {"sr_attention": 61, **FLOAT_PATH}
STRETCH_FUSE = {"sr_attention": 9, **FLOAT_PATH}
STRETCH_CPU_HW = (270, 480)     # (c): the card against the CPU, f32
# (d): export, at the main path's shape; nodes of each program = the
# launches per request of phase 5
EXPORT_MODES = {
    "default": ({}, {"sr_attention": 35, "ffm_grams": 2, "ffm_apply": 2,
                     "drdb_growth": 4, "drdb_tail": 4}),
    "static_guide": ({"guide": True},
                     {"sr_attention": 28, "ffm_grams": 2, "ffm_apply": 2,
                      "drdb_growth": 4, "drdb_tail": 4}),
    "int8": ({"int8": True},
             {"sr_attention": 35, "ffm_grams": 2, "ffm_apply": 2,
              "drdb_int8_growth": 4, "drdb_int8_tail": 4}),
    "fuse_only": ({"with_seg": False},
                  {"sr_attention": 7, "ffm_grams": 2, "ffm_apply": 2,
                   "drdb_growth": 4, "drdb_tail": 4}),
}
# (e): a cut of accuracy.py's overfit (its first round only), run in a
# child process in deterministic mode
REPEAT_ITERS = (20, 10)         # fusion, seg steps (a loss logged every 10)
REPEAT_SEEDS = (1, 2)


def _randn_on(dev, seed):
    """randn(shape, dtype, std) drawn on the card (1080p inputs are too
    large to draw on the host in the time of the phase), and conv(o, i, k,
    dtype): a conv's (weight, bias) at torch's default init."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(
            dtype)

    def conv(o, i, k, dtype):
        lim = (i * k * k) ** -0.5
        w, b = (torch.rand(shape, generator=gen, device=dev) * 2 - 1
                for shape in ((o, i, k, k), (o,)))
        return (w * lim).to(dtype), (b * lim).to(dtype)
    return randn, conv


def fma_bound(dtype, ops, moved) -> dict:
    """{"fma_bound_ms": the f32 bound at the CUDA cores' FMA peak} beside
    an f32 row's 3xTF32 bound; {} for bf16."""
    import torch

    return ({} if dtype == torch.bfloat16 else
            {"fma_bound_ms": bound(ops, "f32", moved)["bound_ms"]})


def _grams_f64(x1, x2, s, wp, bp):
    """``crosspath_grams_ref``'s maths (``_grams_plain``) in f64, on the
    inputs and weight halves as the kernel takes them (the f64 reference
    of tests/test_torch_cuda.py and tests/test_torch_tf32x3.py too)."""
    from segmif_tpu_torch.kernels.ffm import (_GRAM_PICKS, _grams_plain,
                                              _halves)

    w, b = _halves(wp, bp, x1.dtype, _GRAM_PICKS)
    return _grams_plain(*(t.double() for t in (x1, x2, s, w, b)))


def gram_ref(x1, x2, s, wp, bp):
    """The grams a kernel run is held to under GRAM_RTOL: in bf16 the
    plain version's; in f32 its maths summed in f64 (``_grams_f64``),
    since the f32 plain version's own sums over 10^5-10^6 tokens drift by
    more than the f32 limit on the H100 (phase 4 and phase 12 (a) print
    by how much)."""
    import torch

    from segmif_tpu_torch.kernels.ffm import crosspath_grams_ref

    if x1.dtype == torch.bfloat16:
        return crosspath_grams_ref(x1, x2, s, wp, bp)
    return _grams_f64(x1, x2, s, wp, bp)


def stretch_kernel_checks(dev):
    """Phase 12 (a): each float kernel against its plain version at the
    stretch's shapes (sr-attention at mit_b5's four stages, with SDPA
    beside it; FFM and DRDB at batch 1 and 2), f32 and bf16, and the int8
    DRDB bit for bit at batch 1. Returns {row: numbers} for the record."""
    import torch
    import torch.nn.functional as F

    from segmif_tpu_torch.kernels.attention import (sr_attention,
                                                    sr_attention_ref)
    from segmif_tpu_torch.kernels.drdb import (drdb_block, drdb_chain,
                                               drdb_growth, drdb_growth_ref,
                                               drdb_tail, drdb_tail_ref,
                                               pack_growth, pack_tail)
    from segmif_tpu_torch.kernels.ffm import (crosspath_apply_rows,
                                              crosspath_apply_rows_ref,
                                              crosspath_grams,
                                              crosspath_grams_ref)
    from segmif_tpu_torch.kernels.int8 import (drdb_int8_growth,
                                               drdb_int8_growth_ref,
                                               drdb_int8_tail,
                                               drdb_int8_tail_ref,
                                               quantize_drdb, record_amax)

    t0 = time.perf_counter()
    randn, conv = _randn_on(dev, SEED + 40)
    rows = {}
    hh, ww = STRETCH_HW
    d = 64
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        kind = "bf16" if dtype == torch.bfloat16 else "tf32x3"
        tol = SR_TOL[dname]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ops": 0,
               "bytes": 0, "err": 0.0}
        for n, m, h in STRETCH_SR:
            q, k, v = kv_halves(randn, 1, n, m, h, d, dtype)
            got = sr_attention(q, k, v, d ** -0.5)
            want = sr_attention_ref(q, k, v, d ** -0.5)
            ratio, err, diff, ok = held(got, want, tol)
            ms, pms = time_pair(lambda: sr_attention(q, k, v, d ** -0.5),
                                lambda: sr_attention_ref(q, k, v, d ** -0.5),
                                iters=3)
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = time_fn(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, scale=d ** -0.5), iters=3)
            ops, moved = 4 * n * m * h * d, nbytes(q, k, v, got)
            bnd = bound(ops, kind, moved)
            print(f"stretch sr_attention {dname} B=1 N={n} M={m} H={h} "
                  f"D={d}: {verdict(ratio, err, diff, tol)}; kernel "
                  f"{ms:.4f} ms, plain {pms:.4f} ms, scaled_dot_product_"
                  f"attention {lib:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']}{', 3xTF32' if kind != 'bf16' else ''}"
                  f")", flush=True)
            check(ok, f"stretch sr_attention {dname} N={n} error {err}")
            if dtype == torch.float32:
                sdpa = F.scaled_dot_product_attention(qh, kh, vh,
                                                      scale=d ** -0.5)
                sr, se, sd, sok = held(sdpa.transpose(1, 2), want, tol)
                print(f"stretch scaled_dot_product_attention float32 N={n} "
                      f"against sr_attention_ref (information only): "
                      f"{verdict(sr, se, sd, tol)}; "
                      f"{'within' if sok else 'outside'} the f32 limit",
                      flush=True)
                del sdpa
            for key, val in (("ms", ms), ("plain_ms", pms),
                             ("library_ms", lib), ("ops", ops),
                             ("bytes", moved)):
                tot[key] += val
            tot["err"] = max(tot["err"], err)
            del q, k, v, qh, kh, vh, got, want
        rows[f"sr_attention {dname}, 4 mit_b5 stages at 1080p, B=1"] = {
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "library_ms": tot["library_ms"], "max_abs_err": tot["err"],
            **bound(tot["ops"], kind, tot["bytes"]), **fma_bound(
                dtype, tot["ops"], tot["bytes"])}
    torch.cuda.empty_cache()
    n, c = hh * ww, 64
    for b in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            x1, x2, s = (randn((b, n, c), dtype) for _ in range(3))
            wp = randn((3, c, 2 * c), torch.float32, c ** -0.5)
            bp = randn((3, 2 * c), torch.float32, 0.1)
            mats = randn((b, 4, c, c), torch.float32, 0.125)
            be = randn((2, c), torch.float32, 0.1)
            lnp = torch.stack([torch.stack([1 + randn((c,), torch.float32,
                                                      0.1),
                                            randn((c,), torch.float32, 0.1)])
                               for _ in range(2)])
            got = crosspath_grams(x1, x2, s, wp, bp)
            # over 2,073,600 tokens the plain version's own f32 sums drift
            # (at B=2 by 1.1e3 of 1.9e6 against f64 sums on an NVIDIA H100
            # 80GB HBM3 at 700 W, the kernel's chunked sums by 1.0), so
            # both are held to the plain maths in f64 (in bf16 without
            # r's rounding to bf16, which alone moves a gram of 65,536 to
            # 524,288 tokens by 6e-5 to 3e-5 of its largest entry, a 30th
            # of the bf16 limit or less)
            want = _grams_f64(x1, x2, s, wp, bp)
            plain_err = max_err(crosspath_grams_ref(x1, x2, s, wp, bp),
                                want)
            err, scale = max_err(got, want), want.abs().max().item()
            rtol, why = GRAM_RTOL[dname]
            ms, pms = time_pair(lambda: crosspath_grams(x1, x2, s, wp, bp),
                                lambda: crosspath_grams_ref(x1, x2, s, wp,
                                                            bp), iters=3)
            gops = grams_ops(b, n, c)
            moved = nbytes(x1, x2, s, wp, bp, got)
            bnd = bound(gops, "bf16" if kind == "bf16" else "tf32x3", moved)
            fma = fma_bound(dtype, gops, moved)
            print(f"stretch ffm_grams {dname} B={b} N={n} C={c}: against "
                  f"the plain maths in f64: max_abs_err {err:.3e} of max "
                  f"|gram| {scale:.3e} (rtol {rtol:g}: {why}), the f32 "
                  f"plain version's own {plain_err:.3e}; kernel {ms:.4f} "
                  f"ms, plain {pms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']}{', 3xTF32' if fma else ''})"
                  + (f", FMA {fma['fma_bound_ms']:.4f} ms" if fma else ""),
                  flush=True)
            check(err <= rtol * scale, f"stretch ffm_grams {dname} B={b} "
                                       f"error {err}")
            rows[f"ffm_grams {dname} B={b} N={n}"] = {
                "ms": ms, "plain_ms": pms, "library_ms": None,
                "max_abs_err": err, **bnd, **fma}
            args = (x1, x2, s, wp, bp, mats, be, lnp)
            got = crosspath_apply_rows(*args)
            want = crosspath_apply_rows_ref(*args)
            tol = APPLY_TOL[dname]
            ratio, err, diff, ok = held(got, want, tol)
            ms, pms = time_pair(lambda: crosspath_apply_rows(*args),
                                lambda: crosspath_apply_rows_ref(*args),
                                iters=3)
            aops = 7 * 2 * b * n * c * c
            bnd = bound(aops, "bf16" if kind == "bf16" else "tf32x3",
                        nbytes(*args, *got))
            fma = fma_bound(dtype, aops, nbytes(*args, *got))
            print(f"stretch ffm_apply {dname} B={b} N={n} C={c}: "
                  f"{verdict(ratio, err, diff, tol)}; kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                  f"({bnd['bound_by']}{', 3xTF32' if fma else ''})"
                  + (f", FMA {fma['fma_bound_ms']:.4f} ms" if fma else ""),
                  flush=True)
            check(ok, f"stretch ffm_apply {dname} B={b} error {err}")
            rows[f"ffm_apply {dname} B={b} N={n}"] = {
                "ms": ms, "plain_ms": pms, "library_ms": None,
                "max_abs_err": err, **bnd, **fma}
            del x1, x2, s, got, want, args
            torch.cuda.empty_cache()
    cl = torch.channels_last
    for b in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            kind = "bf16" if dtype == torch.bfloat16 else "f32"
            shape = f"{dname} [{b}, 64, {hh}, {ww}]"
            x = randn((b, hh, ww, 64), dtype).permute(0, 3, 1, 2)
            dconvs = [conv(32, 64 + 32 * t, 3, dtype) for t in range(5)]
            wb, bb = conv(64, 224, 1, dtype)
            gpk, tpk = pack_growth(dconvs, dtype), pack_tail(wb, bb, dtype)
            rs, gerr, gms, gpms = compare(
                f"stretch drdb_growth {shape}",
                lambda: drdb_growth(x, dconvs, gpk),
                lambda: drdb_growth_ref(x, dconvs), GROWTH_TOL[dname], True)
            out, terr, tms, tpms = compare(
                f"stretch drdb_tail {shape}",
                lambda: drdb_tail(x, rs, wb, bb, wpk=tpk),
                lambda: drdb_tail_ref(x, rs, wb, bb), TAIL_TOL[dname], True,
                x)
            check(out.is_contiguous(memory_format=cl),
                  "stretch drdb_tail output is not channels_last")
            npix = b * hh * ww
            gops = 2 * npix * 9 * 32 * (64 + 96 + 128 + 160 + 192)
            gb = bound(gops, "tf32x3" if kind == "f32" else kind,
                       nbytes(x, *rs, *(t for cv in dconvs for t in cv)))
            tops = 2 * npix * 224 * 64
            tb = bound(tops, "tf32x3" if kind == "f32" else kind,
                       nbytes(x, *rs, wb, bb, out))
            rows[f"drdb_growth {shape}"] = {
                "ms": gms, "plain_ms": gpms, "library_ms": None,
                "max_abs_err": gerr, **gb, **fma_bound(
                    dtype, gops, nbytes(x, *rs, *(t for cv in dconvs
                                                  for t in cv)))}
            tfma = fma_bound(dtype, tops, nbytes(x, *rs, wb, bb, out))
            rows[f"drdb_tail {shape}"] = {
                "ms": tms, "plain_ms": tpms, "library_ms": None,
                "max_abs_err": terr, **tb, **tfma}
            print(f"stretch drdb_tail {shape}: bound {tb['bound_ms']:.4f} ms"
                  f" ({tb['bound_by']}{', 3xTF32' if tfma else ''})"
                  + (f", FMA {tfma['fma_bound_ms']:.4f} ms" if tfma else ""),
                  flush=True)
            del rs, out
            _, berr, bms, bpms = compare(
                f"stretch drdb_block {shape} vs drdb_chain",
                lambda: drdb_block(x, dconvs, (wb, bb), (gpk, tpk)),
                lambda: drdb_chain(x, dconvs, (wb, bb)), BLOCK_TOL[dname],
                True, x)
            rows[f"drdb_block {shape}"] = {
                "ms": bms, "plain_ms": bpms, "library_ms": None,
                "max_abs_err": berr,
                **bound(gops + 2 * npix * 224 * 64, kind, 2 * nbytes(x))}
            if b == 1 and dtype == torch.bfloat16:
                for name, fn in (("drdb_block", drdb_block),
                                 ("drdb_chain", drdb_chain)):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                    y = fn(x, dconvs, (wb, bb))
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated(dev) - base
                    print(f"stretch {name} {shape}: peak device memory "
                          f"above its input {peak / 2**20:.1f} MiB",
                          flush=True)
                    del y
                # int8 at batch 1, bit for bit
                amax = record_amax([x, *drdb_growth_ref(x, dconvs)])
                q = quantize_drdb(dconvs, (wb, bb), amax)
                feat = drdb_int8_growth(x, q)
                out = drdb_int8_tail(x, feat, q)
                want_feat = drdb_int8_growth_ref(x, q)
                gdiff = (feat != want_feat).sum().item()
                want = drdb_int8_tail_ref(x, want_feat, q)
                tdiff = (out != want).sum().item()
                del want_feat, want
                gms = time_fn(lambda: drdb_int8_growth(x, q), iters=3)
                tms = time_fn(lambda: drdb_int8_tail(x, feat, q), iters=3)
                print(f"stretch drdb_int8 {shape}: int8 buffer elements "
                      f"differing {gdiff} of {feat.numel()}, output {tdiff} "
                      f"of {out.numel()} (limit: bit for bit); growth "
                      f"kernel {gms:.4f} ms, tail kernel {tms:.4f} ms",
                      flush=True)
                check(gdiff == 0 and tdiff == 0, f"stretch drdb_int8 {shape}"
                      ": kernels differ from the plain version")
                rows[f"drdb_int8_growth {shape}"] = {
                    "ms": gms, "plain_ms": None, "library_ms": None,
                    "max_abs_err": 0.0, **bound(gops, "int8", nbytes(
                        x, feat, q.wpk, q.svk, q.bias, q.s_in, q.invs))}
                rows[f"drdb_int8_tail {shape}"] = {
                    "ms": tms, "plain_ms": None, "library_ms": None,
                    "max_abs_err": 0.0, **bound(
                        2 * npix * 224 * 64, "int8",
                        nbytes(x, feat, q.kbq, q.svb, q.bb, out))}
                del feat, out, q
            del x, dconvs, wb, bb, gpk, tpk
            torch.cuda.empty_cache()
    print(f"phase 12 (a): {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def _launches(counters):
    return {k: c.launches for k, c in counters.items()}


def stretch_cli_checks(dev, counters, totals):
    """Phase 12 (b): ``cli.stretch.main`` with ``--synthetic`` at mit_b5,
    1080x1920, bf16 (two reps: a warm-up and the steady state), with and
    without ``--no_seg``: its printed lines and its launches per pair;
    then fps and peak device memory at batch 1 and 2 through the same
    fuse and seg functions."""
    import io

    import torch

    from segmif_tpu_torch.cli import stretch
    from segmif_tpu_torch.models.network import JointPipeline, init_params

    t0 = time.perf_counter()
    hh, ww = STRETCH_HW
    for extra, per_pair in (([], STRETCH_PAIR), (["--no_seg"],
                                                 STRETCH_FUSE)):
        buf = io.StringIO()
        _reset(counters)
        with contextlib.redirect_stdout(buf):
            fused, logits = stretch.main(["--config",
                                          "configs/stretch_1080p.yaml",
                                          "--synthetic"] + extra)
        torch.cuda.synchronize()
        counts = _launches(counters)
        out = buf.getvalue()
        print(out.rstrip(), flush=True)
        want = {k: 2 * v for k, v in per_pair.items()}
        check(counts == want, f"stretch {extra}: launches over its two "
                              f"pairs {counts}, expected {want}")
        for k, v in counts.items():
            totals[k] += v
        check("stretch 1080p OK" in out and "backbone=mit_b5" in out,
              "stretch: lines missing")
        shape = f"fused shape (1, {hh}, {ww}, 3)"
        if not extra:
            shape += (f", logits shape (1, {hh // 4}, {ww // 4}, "
                      f"{STRETCH_CLASSES})")
            check(bool(torch.isfinite(logits).all()), "stretch logits")
        check(shape in out, f"stretch: no line {shape!r}")
        check(bool(torch.isfinite(fused).all()) and fused.min() >= 0
              and fused.max() <= 1, "stretch fused_rgb")
        print(f"stretch CLI {' '.join(extra) or '(fuse and seg)'}: "
              f"launches per pair {per_pair}", flush=True)
        del fused, logits
    model = init_params(JointPipeline("mit_b5", STRETCH_CLASSES),
                        torch.Generator().manual_seed(0))
    fuse, seg = stretch.make_stretch_fns(model, torch.bfloat16, dev)
    for b in (1, 2):
        ir, vis = (t.to(dev) for t in stretch.synthetic_pair(hh, ww, b))
        seg(fuse(ir, vis, vis)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset(counters)
        ms = time_fn(lambda: seg(fuse(ir, vis, vis)[0]), iters=3,
                     hold=False)
        counts = _launches(counters)
        want = {k: 4 * v for k, v in STRETCH_PAIR.items()}
        check(counts == want, f"stretch batch {b}: launches {counts}")
        print(f"stretch mit_b5 {hh}x{ww} bf16 batch {b}: {b * 1e3 / ms:.3f} "
              f"fps ({ms:.1f} ms per call of fuse then seg, CUDA events "
              f"over 3 calls after a warm-up, host-paced); peak device "
              f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
              f"GiB", flush=True)
        del ir, vis
    del model, fuse, seg
    torch.cuda.empty_cache()
    print(f"phase 12 (b): {time.perf_counter() - t0:.1f} s", flush=True)


def stretch_cpu_inputs():
    """Phase 12 (c)'s seeded mit_b5 ``JointPipeline`` (15 classes, eval)
    and its batch-1 pair at STRETCH_CPU_HW, on the CPU."""
    import torch

    from segmif_tpu_torch.models.network import JointPipeline, init_params

    model = init_params(JointPipeline("mit_b5", STRETCH_CLASSES),
                        torch.Generator().manual_seed(SEED + 41)).eval()
    (ir, vis), = _pairs(torch.Generator().manual_seed(SEED + 42), 1, 1,
                        STRETCH_CPU_HW, "cpu")
    return model, ir, vis


def _ref_stretch():
    """Phase 12 (c)'s CPU reference: (fused Y, logits, seconds)."""
    import torch

    model, ir, vis = stretch_cpu_inputs()
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, y, logits = model(ir, vis)
    return y, logits, time.perf_counter() - t0


def stretch_pipeline_checks(dev, refs):
    """Phase 12 (c): the mit_b5 pipeline (15 classes) in f32, the card
    against the CPU (``refs``: the ``CpuReferences``) at STRETCH_CPU_HW
    under PIPE_RTOL; then at 1080x1920 bf16 against f32 on the card under
    ``drift``'s limits (weights at the reference modules' scale), and a
    bf16 run with DRDB1's tail bias dropped, which must fail them."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import JointPipeline

    t0 = time.perf_counter()
    model, ir, vis = stretch_cpu_inputs()
    y_cpu, l_cpu, cpu_s = refs.get("stretch")
    model.to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        _, y, logits = model(ir.to(dev), vis.to(dev))
    check(held_pipe(f"stretch mit_b5 b1 f32 {STRETCH_CPU_HW[0]}x"
                    f"{STRETCH_CPU_HW[1]} card vs CPU (CPU forward "
                    f"{cpu_s:.1f} s)", (("fused_y", y, y_cpu),
                                        ("logits", logits, l_cpu))),
          "stretch mit_b5: card and CPU differ")
    del model, y, logits
    model = drift.init_reference_scale(
        JointPipeline("mit_b5", STRETCH_CLASSES),
        torch.Generator().manual_seed(SEED + 43))
    (ir, vis), = _pairs(torch.Generator().manual_seed(SEED + 44), 1, 1,
                        STRETCH_HW, "cpu")
    ref = drift.pipeline_outputs(model, ir, vis, torch.float32, dev)
    d = drift.drift(ref, drift.pipeline_outputs(model, ir, vis,
                                                torch.bfloat16, dev))
    print(f"stretch bf16 vs f32 pipeline (mit_b5, batch 1, "
          f"{STRETCH_HW[0]}x{STRETCH_HW[1]}, reference-scale weights): "
          f"{drift.describe(d)}", flush=True)
    check(drift.within_limits(d), "stretch: bf16 drifts from f32")
    with torch.no_grad():
        model.fusion.DRDB1.conv.bias.zero_()
    bad = drift.drift(ref, drift.pipeline_outputs(model, ir, vis,
                                                  torch.bfloat16, dev))
    print(f"planted fault, stretch bf16 vs f32, DRDB1's tail bias dropped: "
          f"{drift.describe(bad)} (the check fails, as it must)", flush=True)
    check(not drift.within_limits(bad), "the stretch bf16-vs-f32 check "
                                        "passes a run with DRDB1's tail "
                                        "bias dropped")
    del model, ref
    torch.cuda.empty_cache()
    print(f"phase 12 (c): {time.perf_counter() - t0:.1f} s", flush=True)


_LOADER = """
import json, sys
import numpy as np
import torch
import segmif_tpu_torch.kernels
fn = torch.export.load(sys.argv[1]).module()
io = np.load(sys.argv[2])
with torch.inference_mode():
    rgb, pred = fn(torch.from_numpy(io["ir"]).cuda(),
                   torch.from_numpy(io["vis"]).cuda())
np.savez(sys.argv[3], rgb=rgb.float().cpu().numpy(), pred=pred.cpu().numpy())
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("segmif_tpu_torch", "jax",
                                               "segmif_tpu"))))
"""


def export_checks(dev, counters, totals, tmp):
    """Phase 12 (d): ``serving.export_serving_artifact`` at mit_b3, 480x640,
    batch 8, bf16, in the four modes, saved under ``tmp``: the program's
    ``segmif::`` nodes against phase 5's launches per request, the loaded
    program against ``make_serving_fn`` on the same inputs (its launches
    too), export seconds, artifact size and pairs/s beside
    ``make_serving_fn``'s (timed as phase 7). After its last timed request
    it starts a fresh process that imports only torch and
    ``segmif_tpu_torch.kernels`` and runs the default artifact, and
    returns it for ``fresh_process_check``."""
    import numpy as np
    import torch

    from segmif_tpu_torch import serving
    from segmif_tpu_torch.models.network import JointPipeline, init_params

    t0 = time.perf_counter()
    model = init_params(JointPipeline("mit_b3"),
                        torch.Generator().manual_seed(SEED + 50)
                        ).eval().to(torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED + 51)
    reqs = requests(gen, REQUESTS, BATCH, dev)
    guide = torch.rand((BATCH, H, W, 3), generator=gen).to(dev)
    cal = requests(gen, 1, BATCH, dev)[0]
    for mode, (spec, nodes) in EXPORT_MODES.items():
        kw = {"with_seg": spec.get("with_seg", True)}
        if spec.get("guide"):
            kw["guide_rgb"] = guide
        if spec.get("int8"):
            kw["int8_calibration"] = cal
        t1 = time.perf_counter()
        data = serving.export_serving_artifact(model, BATCH, H, W,
                                               device=dev, **kw)
        export_s = time.perf_counter() - t1
        path = Path(tmp) / f"{mode}.pt2"
        serving.save_serving_artifact(path, data)
        t1 = time.perf_counter()
        loaded = serving.load_serving_artifact(path)
        load_s = time.perf_counter() - t1
        got_nodes = serving.segmif_nodes(loaded)
        check(got_nodes == nodes, f"export {mode}: nodes {got_nodes}, "
                                  f"expected {nodes}")
        serve = serving.make_serving_fn(model, device=dev, **kw)

        def run(ir, vis):
            with torch.inference_mode():
                return loaded(ir, vis)

        bitwise, worst_rel, agree = True, 0.0, 1.0
        for ir, vis in reqs:
            _reset(counters)
            want = serve(ir, vis)
            torch.cuda.synchronize()
            want_counts = _launches(counters)
            _reset(counters)
            got = run(ir, vis)
            torch.cuda.synchronize()
            counts = _launches(counters)
            check(counts == want_counts, f"export {mode}: launches "
                  f"{counts}, make_serving_fn's {want_counts}")
            check({k: v for k, v in counts.items() if v} == nodes,
                  f"export {mode}: launches {counts}, nodes {nodes}")
            for k, v in counts.items():
                totals[k] += v
            if not kw["with_seg"]:
                got, want = (got,), (want,)
            bitwise &= all(torch.equal(g, w) for g, w in zip(got, want))
            worst_rel = max(worst_rel, max_err(got[0], want[0])
                            / want[0].abs().max().item())
            if kw["with_seg"]:
                agree = min(agree, (got[1] == want[1]).float().mean()
                            .item())
        how = ("bit for bit" if bitwise else
               f"fused_rgb within {worst_rel:.3e} of its largest "
               f"magnitude, class maps agreeing on {agree:.5f}")
        check(bitwise or (worst_rel <= PIPE_RTOL["fused_y"]
                          and agree >= 0.999),
              f"export {mode}: the loaded program differs from "
              f"make_serving_fn ({how})")
        batches = itertools.cycle(reqs)
        ms_fn = time_fn(lambda: serve(*next(batches)), 2 * REQUESTS,
                        hold=False)
        ms_pt2 = time_fn(lambda: run(*next(batches)), 2 * REQUESTS,
                         hold=False)
        print(f"export {mode} (mit_b3, batch {BATCH}, {H}x{W}, bf16): "
              f"{export_s:.1f} s to export, {len(data) / 1e6:.1f} MB, "
              f"{load_s:.1f} s to load; nodes {got_nodes} = launches "
              f"per request; the loaded program vs make_serving_fn over "
              f"{REQUESTS} requests: {how}; "
              f"{BATCH * 1e3 / ms_pt2:.3f} pairs/s loaded, "
              f"{BATCH * 1e3 / ms_fn:.3f} pairs/s make_serving_fn "
              f"(CUDA events, host-paced, as phase 7)", flush=True)
        if mode == "default":   # for the fresh process
            ir, vis = reqs[0]
            with torch.inference_mode():
                rgb0, pred0 = loaded(ir, vis)
            fresh = (rgb0.float().cpu().numpy(), pred0.cpu().numpy())
            np.savez(Path(tmp) / "in.npz", ir=ir.cpu().numpy(),
                     vis=vis.cpu().numpy())
            fresh_path = path
        del loaded, serve, data
        torch.cuda.empty_cache()
    del model, reqs, guide, cal
    torch.cuda.empty_cache()
    print(f"phase 12 (d): {time.perf_counter() - t0:.1f} s", flush=True)
    # started after the last timed request; ``fresh_process_check`` reads
    # its result
    proc = started(subprocess.Popen(
        [sys.executable, "-c", _LOADER, str(fresh_path),
         str(Path(tmp) / "in.npz"), str(Path(tmp) / "out.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT))
    return proc, Path(tmp) / "out.npz", fresh, time.perf_counter()


def fresh_process_check(pending) -> None:
    """Phase 12 (d), last part: the default artifact, loaded and run by
    the fresh process ``export_checks`` started, gave this process's
    outputs bit for bit, and that process imported only torch and
    ``segmif_tpu_torch.kernels``."""
    import numpy as np

    proc, out_path, (rgb0, pred0), t1 = pending
    out, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"export: the fresh process failed: {err}")
    mods = json.loads(out.strip().splitlines()[-1])
    check("segmif_tpu_torch.kernels" in mods and not any(
        m.startswith(("segmif_tpu_torch.models", "segmif_tpu_torch.serving",
                      "jax", "segmif_tpu.")) for m in mods),
          f"export: the fresh process imported {mods}")
    got = np.load(out_path)
    check(np.array_equal(got["rgb"], rgb0) and
          np.array_equal(got["pred"], pred0),
          "export: the fresh process's outputs differ")
    print(f"export default: loaded and run in a fresh process importing "
          f"{mods} (done {time.perf_counter() - t1:.1f} s after its start, "
          f"beside phases 11 (b)-(e) and 12 (c)); its outputs equal this "
          f"process's bit for bit", flush=True)


def repeat_child(seeds) -> None:
    """In a fresh process (deterministic mode must be on before the first
    cuBLAS call): the cut overfit once per seed, on the card, printing one
    JSON line per run with its logged losses and a digest of its final
    weights. Run by ``repeatability``."""
    import hashlib

    import torch

    from segmif_tpu_torch.utils import determinism

    determinism.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in seeds:
        t0 = time.perf_counter()
        trainer, _ = overfit_cut(seed, dev, rounds=1, iters=REPEAT_ITERS)
        h = hashlib.sha256()
        for name, t in sorted(trainer.model.state_dict().items()):
            h.update(name.encode())
            h.update(t.detach().cpu().numpy().tobytes())
        print(json.dumps({
            "seed": seed, "seconds": round(time.perf_counter() - t0, 1),
            "fusion_losses": [loss for _, _, loss in
                              trainer.fusion_loss_history],
            "seg_losses": [loss for _, _, loss in trainer.seg_loss_history],
            "weights_sha256": h.hexdigest()}), flush=True)


def start_repeatability():
    """Phase 12 (e)'s child process (``repeat_child``), started early:
    main starts it after the last section that times the card (12 (d)),
    so that it runs beside the untimed checks of phases 11 (b)-(e) and
    12 (c)."""
    seeds = [REPEAT_SEEDS[0], REPEAT_SEEDS[0], REPEAT_SEEDS[1]]
    return started(subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         f"chip_smoke.repeat_child({seeds})"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)), time.perf_counter()


def repeatability(pending):
    """Phase 12 (e): the cut overfit (REPEAT_ITERS of its first round) at
    seed REPEAT_SEEDS[0] twice and at REPEAT_SEEDS[1] once, in one child
    process in deterministic mode (``start_repeatability``'s): the two
    runs at one seed give the same logged losses and final weights bit for
    bit; the run at the other seed differs (the planted fault: it shows
    that the check can fail)."""
    t0 = time.perf_counter()
    proc, t_start = pending
    out, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"repeatability: the child failed: "
                                f"{err[-4000:]}")
    runs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    check(len(runs) == 3, f"repeatability: {len(runs)} runs")

    def same(a, b):
        return all(a[k] == b[k] for k in ("fusion_losses", "seg_losses",
                                          "weights_sha256"))

    a, b, other = runs
    for r in runs:
        print(f"repeatability: seed {r['seed']} ({r['seconds']} s): fusion "
              f"losses {r['fusion_losses'][:2]} ... "
              f"{r['fusion_losses'][-1]}, seg losses {r['seg_losses'][:1]}"
              f" ... {r['seg_losses'][-1:]}, weights sha256 "
              f"{r['weights_sha256'][:16]}", flush=True)
    check(same(a, b), f"repeatability: seed {a['seed']} gave two results")
    print(f"repeatability: seed {a['seed']} twice gives the same "
          f"{len(a['fusion_losses'])} fusion and {len(a['seg_losses'])} seg "
          f"logged losses and the same final weights, bit for bit",
          flush=True)
    check(not same(a, other), "repeatability: the check passes two runs at "
                              "different seeds")
    print(f"planted fault, repeatability: seed {other['seed']} against seed "
          f"{a['seed']} differs (the check fails, as it must)", flush=True)
    print(f"phase 12 (e): {time.perf_counter() - t0:.1f} s (its child "
          f"started {t0 - t_start:.1f} s before, after phase 12 (d))",
          flush=True)


# Phase 13: the parallel paths (segmif_tpu_torch.parallel), ranks spawned
# on this one card (gloo: NCCL refuses two ranks on one device), after
# the parent built the kernels. Ranks that share a card measure what the
# sharding costs, not a speed-up.
DP_WORLD = 2
DP_FUSION = (8, H, W)          # global batch, rows, columns
DP_SEG = (4, 480, 480)
DP_TIMED = 1                   # timed steps, after one warm-up
# Phases 13 and 14 run their steps and split models at mit_b3's widths,
# heads and sr ratios with one block a stage (28 blocks -> 4): every
# sr-attention head shape a rank runs, at a seventh of the depth (phase 5
# serves the whole mit_b3)
PAR_BACKBONE = "mit_b3_shallow"
PAR_DEPTHS = (1, 1, 1, 1)
# the kernels each DP step launches on each rank (rows 4 and 2 a rank):
# the guide taps (stages 1-2) and the seg pass, one sr-attention a block
DP_EXPECT = {"fusion": {"sr_attention": sum(PAR_DEPTHS[:2]) +
                        sum(PAR_DEPTHS), **FLOAT_PATH},
             "seg": {"sr_attention": sum(PAR_DEPTHS), **SEG_ONLY}}
# f32 against one process: phase 8 (a)'s limits (TRAIN_LOSS_RTOL,
# TRAIN_LEAF_RTOL) and the seg step's relative L2 below, except the
# fusion step's leaves. The f32 fusion step of one process is not the same
# at a rank's batch as at the whole batch's: controls without ranks
# (``f32_control``) ran the same maths at both shapes of the whole mit_b3
# on the H100 and read, for the rows with 97 % of their labels ignored (where
# the CE through the frozen seg net weighs most), 6.25e-2 of relu.weight's
# largest gradient, a relative L2 of 1.49e-2 over all leaves and 2.05e-2
# of the AdamW steps more than 1 % apart; the same batch again read
# 2.5e-7 in L2, its rows reversed 4.2e-6. The DP step against one process
# read 1.29e-2 (DRDB1.Dcov5.bias), 6.6e-3 in L2 and 7.65e-3 of the
# steps, inside that spread; so the fusion step is held to 4e-2 per leaf
# and 3e-2 of the steps (the CE averaged per rank read 8.2e-2 and
# 8.0e-2), and its L2 is printed, not held: the CE fault's 6.9e-3 lies
# inside the shape spread. Exact on CPU ranks: f64 at 1e-9
# (test_torch_parallel.py), f32 equal to grad_accum's micro-batches
# (test_torch_parallel_f32.py). The seg step read 8.0e-6 per leaf.
DP_FUSION_LEAF_RTOL = 4e-2
DP_FUSION_FLIP_SHARE = 3e-2
# the seg step, f32: sqrt(sum |got - ref|^2 / sum |ref|^2) over all
# gradient leaves together (read 5.9e-7; the planted faults 0.84 and 0.99)
DP_L2_RTOL = 1e-3
# bf16 against bf16 (rank rows against one process): phase 8 (c)'s
# limits for bf16 against f32 at 480x640
DP_BF16_LOSS = 2e-2
DP_BF16_NORM = (0.02, 20.0)
# AdamW's first step moves an element by lr g / (|g| + eps) (plus its
# weight decay): the same step, the group's lr, wherever |g| is far above
# eps. Updated weights are held by their steps, leaf by leaf: no element's
# step apart by more than a flipped step (2.02 times the leaf's largest
# step), and at most this share of elements apart by more than 1 % of it
# (elements whose gradient lies within rounding of zero step either way)
DP_FLIP_SHARE = 1e-3
# ranks of the spatial fuse on one card: 2, and 7 for blocks of uneven
# height (155 and 154 rows) and interior ranks with two halo neighbours.
# 4 ranks run with --parallel on 4 cards and on CPU ranks
# (tests/test_torch_spatial.py); 8, even blocks of 135 rows, no longer run
SPATIAL_WORLDS = (2, 7)
SPATIAL_EXPECT = {"sr_attention": 9, **FLOAT_PATH}   # per rank, per pair
# N ranks against one, on the fused Y, relative to its largest magnitude:
# f32, phase 6's PIPE_RTOL; bf16, phase 4's bf16 DRDB block limits
# (rtol 2^-7, atol 2^-6), the rtol of the largest |ref|: a context entry
# one bf16 step apart (the grams summed in another order) moves elements
# of any size through the rest of the trunk
SPATIAL_TOL = {"float32": (PIPE_RTOL["fused_y"], 0.0),
               "bfloat16": (2 ** -7, 2 ** -6)}
SPATIAL_TIMED = 1
SHARED_NOTE = "; ranks sharing one card measure overhead, not speed-up"
# (f) several hosts: 2 emulated hosts (torchrun nodes) of 2 ranks
# (``dist.launch(ranks_per_host=)``), each host reading its stride of the
# 8 (fusion) or 4 (seg) rows of (a)'s batches through the Prefetcher,
# seeded HOSTS_SEED: the global batch is the hosts' batches concatenated
HOSTS, PER_HOST = 2, 2
HOSTS_SEED = SEED + 135


def par_backbone() -> str:
    """PAR_BACKBONE, registered among the MiT variants of this process
    (spawned ranks call it too): mit_b3 at PAR_DEPTHS."""
    from segmif_tpu_torch.models import mit

    mit.MIT_VARIANTS.setdefault(PAR_BACKBONE, dataclasses.replace(
        mit.MIT_VARIANTS["mit_b3"], depths=PAR_DEPTHS))
    return PAR_BACKBONE


def _counters():
    from segmif_tpu_torch.kernels.attention import sr_attention
    from segmif_tpu_torch.kernels.drdb import drdb_growth, drdb_tail
    from segmif_tpu_torch.kernels.ffm import (crosspath_apply_rows,
                                              crosspath_grams)
    from segmif_tpu_torch.kernels.int8 import (drdb_int8_growth,
                                               drdb_int8_tail)

    return {"sr_attention": sr_attention, "ffm_grams": crosspath_grams,
            "ffm_apply": crosspath_apply_rows, "drdb_growth": drdb_growth,
            "drdb_tail": drdb_tail, "drdb_int8_growth": drdb_int8_growth,
            "drdb_int8_tail": drdb_int8_tail}


def _dp_batches(fusion_b: int = DP_FUSION[0]):
    """Phase 13 (a)'s global batches, the same in every process (a
    seeded CPU generator), the fusion batch of ``fusion_b`` rows: labels
    10 % ignored in the first half of each batch and 97 % in the second
    (the ranks' counts of valid pixels differ 30-fold, so a CE averaged
    per rank moves the step), and the seg batch's second half brighter
    (the ranks' BatchNorm statistics differ)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 130)
    b, h, w = fusion_b, DP_FUSION[1], DP_FUSION[2]

    def ignore(label):
        b, h, w = label.shape
        share = torch.tensor([0.1] * (b // 2) + [0.97] * (b - b // 2))
        label[torch.rand((b, h, w), generator=gen)
              < share[:, None, None]] = 255
        return label

    fusion = train_batch(gen, b, h, w, "cpu")
    fusion["label"] = ignore(fusion["label"])
    b, h, w = DP_SEG
    image = torch.rand((b, h, w, 3), generator=gen)
    image[b // 2:] = 0.5 + 0.5 * image[b // 2:]
    label = ignore(torch.randint(0, 9, (b, h, w), generator=gen))
    return fusion, {"image": image, "label": label}


def _dp_models():
    """(JointPipeline for the fusion step, at the reference modules'
    scale; SegmentationNetwork for the seg step), seeded."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import (JointPipeline,
                                                 SegmentationNetwork,
                                                 init_params)

    joint = drift.init_reference_scale(
        JointPipeline(par_backbone()),
        torch.Generator().manual_seed(SEED + 131))
    seg = init_params(SegmentationNetwork(par_backbone()),
                      torch.Generator().manual_seed(SEED + 132))
    return joint, seg


def dp_steps(models, dev, dtype, shard=None, timed=0, counters=None,
             kinds=("fusion", "seg"), fusion_batch=None, mesh=None,
             seg_batch=None):
    """One round >= 2 fusion step and one seg step (3-group AdamW,
    drop-path, dropout, BatchNorm) of copies of ``models``
    (``_dp_models``) on phase 13's batches (replaced by ``fusion_batch``
    and ``seg_batch`` when given: under ``shard``, the host's batches), in
    ``dtype``; under ``shard`` on this rank's rows; with ``mesh`` the
    copies split over its model groups
    (phase 14); the steps of ``kinds`` only. Returns
    {'fusion' | 'seg': {'metrics', 'grads', 'before', 'after', 'dwa' |
    'stats', 'launches', 'ms'}} with tensors on the CPU, split leaves
    gathered whole; ``timed`` more steps give 'ms' per step (host clock
    around synchronised steps)."""
    import torch

    from segmif_tpu_torch.parallel.tensor import gather_tree, tensor_parallel
    from segmif_tpu_torch.train.compare import RecordGrads
    from segmif_tpu_torch.train.optimizer import (adamw_poly,
                                                  adamw_poly_grouped)
    from segmif_tpu_torch.train.state import FusionTrainState, SegTrainState
    from segmif_tpu_torch.train.steps import (make_fusion_train_step,
                                              make_seg_train_step)

    joint, seg = (copy.deepcopy(m) for m in models)
    if mesh is not None:
        tensor_parallel(joint, mesh)
        tensor_parallel(seg, mesh)
    fusion_default, seg_default = _dp_batches()
    if fusion_batch is None:
        fusion_batch = fusion_default
    if seg_batch is None:
        seg_batch = seg_default
    if shard is not None:
        fusion_batch = shard[0].take(fusion_batch)
        seg_batch = shard[1].take(seg_batch)
    kw = [{} if shard is None else {"shard": s} for s in (shard or (0, 0))]
    out = {}
    for kind in kinds:
        if kind == "fusion":
            tx = RecordGrads(adamw_poly(TRAIN_LR, 0, 20000))
            step = make_fusion_train_step(joint, tx, False,
                                          compute_dtype=dtype, device=dev)
            state = FusionTrainState.create(joint.fusion, tx)
            batch = {k: v.to(dev) for k, v in fusion_batch.items()}
            args, extra = (batch, TRAIN_FUSION_SCALE), kw[0]
        else:
            names = [k for k, _ in seg.named_parameters()]
            tx = RecordGrads(adamw_poly_grouped(names, TRAIN_LR, 0, 20000))
            step = make_seg_train_step(seg, tx, compute_dtype=dtype,
                                       device=dev)
            state = SegTrainState.create(seg, tx)
            batch = {k: v.to(dev) for k, v in seg_batch.items()}
            args, extra = (batch, SEED), kw[1]
        def whole(tree):
            return {k: v.detach().cpu().clone() for k, v in
                    gather_tree(tree, state.splits).items()}

        before = whole(state.params)
        for c in (counters or {}).values():
            c.launches = 0
        metrics = step(state, *args, **extra)
        torch.cuda.synchronize()
        res = {"launches": {k: c.launches for k, c in
                            (counters or {}).items()},
               "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
               "grads": whole(tx.grads), "before": before,
               "after": whole(state.params)}
        if kind == "fusion":
            res["dwa"] = {k: getattr(state.dwa, k).cpu() for k in
                          ("prev", "prev2")}
        else:
            res["stats"] = {k: v.cpu() for k, v in
                            state.batch_stats.items()}
        if timed:
            t0 = time.perf_counter()
            for _ in range(timed):
                step(state, *args, **extra)
            torch.cuda.synchronize()
            res["ms"] = (time.perf_counter() - t0) * 1e3 / timed
        out[kind] = res
        del step, state, batch
        torch.cuda.empty_cache()
    return out


def _flip_check(got, want):
    """(largest |step_got - step_want| over the leaf's largest step, share
    of elements whose steps are more than 1 % of it apart) over the
    updated weights."""
    worst, far, n = 0.0, 0, 0
    for k, w in want["after"].items():
        step = w - want["before"][k]
        top = step.abs().max().item()
        if top == 0.0:
            continue
        d = ((got["after"][k] - got["before"][k]) - step).abs()
        worst = max(worst, d.max().item() / top)
        far += (d > 0.01 * top).sum().item()
        n += d.numel()
    return worst, far / n


def _losses_rel(g, e, kind) -> float:
    keys = ("loss", "loss_fusion", "loss_seg") if kind == "fusion" \
        else ("loss",)
    return max(abs(g["metrics"][k].item() - e["metrics"][k].item())
               / max(abs(e["metrics"][k].item()), 1e-30) for k in keys)


def _state_leaves(res, kind) -> dict:
    """The DWA state (fusion) or the BN buffers (seg) of a step."""
    if kind == "fusion":
        return {f"dwa.{k}": v for k, v in res["dwa"].items()}
    return res["stats"]


def f32_errors(g, e, kind) -> dict:
    """Phase 13 (a)'s f32 measures of step result ``g`` against ``e``
    (``dp_steps``' entries): the losses' relative error, the worst leaf
    of the gradients and the DWA state or BN buffers (max|err|/max|ref|,
    the exact-zero leaves apart), those leaves' largest magnitude over
    the largest gradient's, the relative L2 error of all gradient leaves
    together, and AdamW's steps (``_flip_check``)."""
    from segmif_tpu_torch.train.compare import exact_zero_grad, leaf_errors

    keep = [k for k in e["grads"] if not exact_zero_grad(k)]
    errs = leaf_errors({**{k: g["grads"][k] for k in keep},
                        **_state_leaves(g, kind)},
                       {**{k: e["grads"][k] for k in keep},
                        **_state_leaves(e, kind)})
    top = max(v.abs().max().item() for v in e["grads"].values())
    diff2 = sum((g["grads"][k].double() - e["grads"][k].double())
                .pow(2).sum().item() for k in keep)
    ref2 = sum(e["grads"][k].double().pow(2).sum().item() for k in keep)
    flip, share = _flip_check(g, e)
    return {"rel": _losses_rel(g, e, kind), "leaves": len(errs),
            "worst": max(errs.items(), key=lambda kv: kv[1]),
            "zero": max((max(g["grads"][k].abs().max().item(),
                             e["grads"][k].abs().max().item()) / top
                         for k in e["grads"] if exact_zero_grad(k)),
                        default=0.0),
            "l2": math.sqrt(diff2 / ref2), "flip": flip, "share": share}


def f32_line(m, kind, limits=None) -> str:
    """``f32_errors``' measures as text; ``limits``: (worst leaf, relative
    L2 or None, share of AdamW steps apart) of a check, printed with the
    other limits."""
    leaf, l2, share = limits or (None, None, None)

    def lim(x):
        return "" if limits is None or x is None else f" (limit {x:g})"

    return (f"losses relative {m['rel']:.2e}{lim(TRAIN_LOSS_RTOL)}; "
            f"{m['leaves']} gradient leaves, "
            f"{'DWA state' if kind == 'fusion' else 'BN buffers'}: worst "
            f"max|err|/max|ref| {m['worst'][1]:.3e} ({m['worst'][0]})"
            f"{lim(leaf)}; all gradient leaves' relative L2 "
            f"{m['l2']:.3e}{lim(l2)}; exact-zero leaves "
            f"{m['zero']:.1e} of the largest gradient{lim(1e-6)}; updated "
            f"weights: worst step difference {m['flip']:.3f} of the "
            f"leaf's largest step{lim(2.02)}, share beyond 1% of it "
            f"{m['share']:.2e}{lim(share)}")


def dp_compare(label, got, want, dtype):
    """Phase 13 (a)'s checks of a DP run against one process: one
    (passed, line) per step."""
    from segmif_tpu_torch.train.compare import exact_zero_grad, norm_ratios

    out = []
    for kind in got:
        g, e = got[kind], want[kind]
        if dtype == "float32":
            m = f32_errors(g, e, kind)
            limits = ((DP_FUSION_LEAF_RTOL, None, DP_FUSION_FLIP_SHARE)
                      if kind == "fusion" else
                      (TRAIN_LEAF_RTOL, DP_L2_RTOL, DP_FLIP_SHARE))
            leaf, l2, share = limits
            good = (m["rel"] <= TRAIN_LOSS_RTOL and m["worst"][1] <= leaf
                    and (l2 is None or m["l2"] <= l2)
                    and m["zero"] <= 1e-6 and m["flip"] <= 2.02
                    and m["share"] <= share)
            line = f"{label} {kind}: " + f32_line(m, kind, limits)
        else:
            rel = _losses_rel(g, e, kind)
            extra, extra_e = _state_leaves(g, kind), _state_leaves(e, kind)
            grads = {k: v for k, v in g["grads"].items()
                     if not exact_zero_grad(k)}
            grads_e = {k: v for k, v in e["grads"].items()
                       if not exact_zero_grad(k)}
            steps = {k: g["after"][k] - g["before"][k] for k in e["after"]
                     if not exact_zero_grad(k)}
            steps_e = {k: e["after"][k] - e["before"][k] for k in steps}
            ratios = norm_ratios({**grads, **extra}, {**grads_e, **extra_e})
            ratios.update({f"step {k}": v for k, v in
                           norm_ratios(steps, steps_e).items()})
            # leaves whose reference is all zeros (the aux classifier's
            # gradient) have no ratio
            ratios = {k: v for k, v in ratios.items() if math.isfinite(v)}
            lo, hi = min(ratios.values()), max(ratios.values())
            good = (rel <= DP_BF16_LOSS and lo >= DP_BF16_NORM[0]
                    and hi <= DP_BF16_NORM[1])
            line = (
                f"{label} {kind}: losses relative {rel:.2e} (limit "
                f"{DP_BF16_LOSS:g}); {len(ratios)} gradient leaves, "
                f"buffers and weight steps, norm ratio in [{lo:.4f}, "
                f"{hi:.4f}] (limits {DP_BF16_NORM})")
        out.append((good, line))
    return out


def _agree(comm, tree) -> bool:
    """Whether every rank holds the same values: an f64 checksum of the
    tree (sum, then sum of squares of the element-wise ranks) gathered."""
    import torch

    flat = torch.cat([v.double().flatten()
                      for _, v in sorted(tree.items())])
    pos = torch.arange(flat.numel(), dtype=torch.float64)
    mine = torch.stack([flat.sum(), (flat * pos).sum()]).to(comm.device)
    got = comm.all_gather_rows(mine[None], [1] * comm.world)
    return bool((got == got[0]).all())


def _step_leaves(res) -> dict:
    """A ``dp_steps`` result's gradients, updated leaves and BN buffers
    (seg) under distinct names, for ``_agree``."""
    return {f"{kind} {part} {k}": v for kind, r in res.items()
            for part in ("grads", "after", "stats")
            for k, v in r.get(part, {}).items()}


def f32_control(models, dev, world) -> str:
    """Phase 13 (a)'s control, without ranks: the f32 fusion step of one
    process on the last rank's B / ``world`` rows (97 % of their labels
    ignored) alone against the same rows tiled ``world`` times (batch B):
    every loss is a mean and the CE a sum over a count that the tiling
    multiplies alike, so this is the same maths at a rank's shape and at
    one process's, and shows how far the batch shape alone moves the step
    (the whole batch again and its rows reversed moved the whole mit_b3's
    step by 2.5e-7 and 4.2e-6 in L2 on the H100). Returns its line."""
    import torch

    per = DP_FUSION[0] // world
    rows = {k: v[-per:] for k, v in _dp_batches()[0].items()}

    def run(b):
        return dp_steps(models, dev, torch.float32, kinds=("fusion",),
                        fusion_batch=b)["fusion"]

    got = run(rows)
    want = run({k: torch.cat([v] * world) for k, v in rows.items()})
    return (f"dp (a) control, no ranks, f32 fusion step, rank {world - 1}'s "
            f"{per} rows against the same rows tiled to batch "
            f"{DP_FUSION[0]}: " + f32_line(f32_errors(got, want, "fusion"),
                                           "fusion"))


def dp_rank(comm):
    """Phase 13 (a) and (d) on one of the DP ranks: rank 0 first runs the
    one-process steps on the whole batches (f32 and bf16) and the f32
    control while the other ranks wait, then every rank runs the DP steps
    in f32 and bf16 (the bf16 ones counted and timed), the two planted
    faults in f32, and the dry run. Rank 0 returns the lines and
    verdicts."""
    import torch

    from segmif_tpu_torch.models import segformer_head
    from segmif_tpu_torch.parallel import dryrun
    from segmif_tpu_torch.parallel.mesh import batch_shard, make_mesh
    from segmif_tpu_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    counters = _counters()
    mesh = make_mesh(comm=comm)
    shard = (batch_shard(mesh, DP_FUSION[0]), batch_shard(mesh, DP_SEG[0]))
    models = _dp_models()
    one = {}
    secs = [time.perf_counter()]
    if comm.rank == 0:
        for name in ("float32", "bfloat16"):
            timed = DP_TIMED if name == "bfloat16" else 0
            one[name] = dp_steps(models, dev, getattr(torch, name),
                                 timed=timed)
        control = f32_control(models, dev, comm.world)
    comm.barrier()
    secs.append(time.perf_counter())
    out = {"transport": comm.transport, "lines": [], "ok": True}
    if comm.rank == 0:
        out["lines"].append(control)
    for name in ("float32", "bfloat16"):
        got = dp_steps(models, dev, getattr(torch, name), shard,
                       timed=DP_TIMED if name == "bfloat16" else 0,
                       counters=counters)
        same = all(_agree(comm, {**got[k]["grads"], **got[k]["after"]})
                   for k in ("fusion", "seg"))
        if name == "bfloat16":
            out["launches"] = {k: got[k]["launches"] for k in got}
            out["ms"] = {k: (got[k]["ms"], one.get(name, got)[k]["ms"])
                         for k in got}
        if comm.rank == 0:
            res = dp_compare(f"dp (a) {name}, {comm.world} ranks", got,
                             one[name], name)
            out["lines"] += [ln for _, ln in res] + [
                f"dp (a) {name}: every rank's gradients and weights the "
                f"same: {same}"]
            out["ok"] = out["ok"] and same and all(ok for ok, _ in res)
        del got
    secs.append(time.perf_counter())
    real_ce, real_bs = steps.ce_share, segformer_head.batch_stats
    faults = {
        "CE averaged per rank": (steps, "ce_share", lambda lg, lb, ig, s: (
            steps.cross_entropy(lg, lb, ig) * s.share)),
        "BatchNorm on local statistics": (
            segformer_head, "batch_stats",
            lambda x, shard=None: real_bs(x))}
    for label, (mod, attr, fake) in faults.items():
        setattr(mod, attr, fake)
        try:
            bad = dp_steps(models, dev, torch.float32, shard)
        finally:
            steps.ce_share, segformer_head.batch_stats = real_ce, real_bs
        if comm.rank == 0:
            res = dp_compare(f"planted fault, dp (a), {label}", bad,
                             one["float32"], "float32")
            out["lines"] += [ln + (" (holds: the fault does not reach this "
                                   "step)" if ok else
                                   " (the check fails, as it must)")
                             for ok, ln in res]
            out["ok"] = out["ok"] and not all(ok for ok, _ in res)
        del bad
    torch.cuda.empty_cache()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.dryrun(comm)
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_launches"] = {k: c.launches for k, c in counters.items()}
    secs += [t0, time.perf_counter()]
    out["lines"].append(
        "dp (a) seconds on rank 0: one process and its control "
        f"{secs[1] - secs[0]:.1f}, DP steps {secs[2] - secs[1]:.1f}, planted "
        f"faults {secs[3] - secs[2]:.1f}, dry run {secs[4] - secs[3]:.1f}")
    return out


class _Rows:
    """A batch of tensors {'ir', 'vis', 'guide', 'label'} as a dataset of
    its rows (name, ir, vis, guide, label), for the ``Prefetcher``."""

    def __init__(self, batch):
        self.b = {k: v.numpy() for k, v in batch.items()}

    def __len__(self):
        return len(self.b["label"])

    def __getitem__(self, i):
        b = self.b
        return str(i), b["ir"][i], b["vis"][i], b["guide"][i], b["label"][i]


def host_read(batch, hosts, host=None):
    """This host's first ``Prefetcher`` batch of a global ``batch``
    (B / ``hosts`` rows from its stride, the labels in their own dtype)
    and the rows it took; with ``host`` given, host ``host``'s
    (``pipeline.host_layout`` patched while it reads)."""
    import torch

    from segmif_tpu_torch.data import pipeline

    real = pipeline.host_layout
    if host is not None:
        pipeline.host_layout = lambda: (host, hosts)
    try:
        pf = pipeline.Prefetcher(_Rows(batch), len(batch["label"]) // hosts,
                                 seed=HOSTS_SEED, use_native=False)
        try:
            got = next(iter(pf))
        finally:
            pf.close()
    finally:
        pipeline.host_layout = real
    got["label"] = got["label"].astype(batch["label"].numpy().dtype)
    return {k: torch.from_numpy(v) for k, v in got.items()}, \
        pf.indices.tolist()


def hosts_rank(comm):
    """Phase 13 (f) on one rank of ``HOSTS`` emulated hosts of
    ``PER_HOST`` ranks: rank 0 first runs the one-process f32 steps on the
    hosts' ``Prefetcher`` batches of (a)'s batches concatenated in host
    order (timed) while the others wait; then every rank reads its host's
    batches, runs the DP f32 steps on its rows of them (counted, timed) and
    the planted fault (every host on host 0's stride, the fusion step).
    Rank 0 returns the lines and verdicts; every rank its layout, its
    host's rows and its launches."""
    import torch

    from segmif_tpu_torch.parallel import dist
    from segmif_tpu_torch.parallel.mesh import batch_shard, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    counters = _counters()
    host, hosts = dist.host_layout()
    mesh = make_mesh(comm=comm)
    fusion, seg = _dp_batches()
    seg = {"ir": seg["image"], "vis": seg["image"], "guide": seg["image"],
           "label": seg["label"]}

    def seg_step(b):
        return {"image": b["guide"], "label": b["label"]}

    models = _dp_models()
    f32 = torch.float32
    out = {"transport": comm.transport, "lines": [], "ok": True,
           "layout": (host, hosts, mesh.host, mesh.hosts, mesh.local_rank)}
    secs = [time.perf_counter()]
    if comm.rank == 0:
        whole = [{k: torch.cat([host_read(b, hosts, h)[0][k]
                                for h in range(hosts)]) for k in b}
                 for b in (fusion, seg)]
        one = dp_steps(models, dev, f32, timed=DP_TIMED,
                       fusion_batch=whole[0], seg_batch=seg_step(whole[1]))
    comm.barrier()
    secs.append(time.perf_counter())
    mine, out["rows"] = host_read(fusion, hosts)
    mine_seg, _ = host_read(seg, hosts)
    shard = (batch_shard(mesh, DP_FUSION[0]), batch_shard(mesh, DP_SEG[0]))
    got = dp_steps(models, dev, f32, shard, timed=DP_TIMED,
                   counters=counters, fusion_batch=mine,
                   seg_batch=seg_step(mine_seg))
    same = all(_agree(comm, {**got[k]["grads"], **got[k]["after"]})
               for k in got)
    out["launches"] = {k: got[k]["launches"] for k in got}
    if comm.rank == 0:
        out["ms"] = {k: (got[k]["ms"], one[k]["ms"]) for k in got}
        res = dp_compare(f"hosts (f) float32, {hosts} hosts x "
                         f"{comm.world // hosts} ranks", got, one, "float32")
        out["lines"] += [ln for _, ln in res] + [
            f"hosts (f): every rank's gradients and weights the same: "
            f"{same}"]
        out["ok"] = same and all(ok for ok, _ in res)
    del got
    secs.append(time.perf_counter())
    bad_batch, out["fault_rows"] = host_read(fusion, hosts, host=0)
    bad = dp_steps(models, dev, f32, shard, kinds=("fusion",),
                   fusion_batch=bad_batch)
    if comm.rank == 0:
        res = dp_compare("planted fault, hosts (f), every host on host 0's "
                         "stride", bad, one, "float32")
        out["lines"] += [ln + (" (holds)" if ok else
                               " (the check fails, as it must)")
                         for ok, ln in res]
        out["ok"] = out["ok"] and not all(ok for ok, _ in res)
    del bad
    torch.cuda.empty_cache()
    secs.append(time.perf_counter())
    out["lines"].append(
        f"hosts (f) seconds on rank 0: one process {secs[1] - secs[0]:.1f},"
        f" DP steps {secs[2] - secs[1]:.1f}, planted fault "
        f"{secs[3] - secs[2]:.1f}")
    return out


def spatial_rank(comm, worlds):
    """Phase 13 (c) on one of the spatial ranks: rank 0 first fuses the
    stretch pair on its own (f32 and bf16) while the others wait; then
    each group of the first N ranks (N in ``worlds``) fuses it with
    ``make_spatial_fuse_fn`` in f32 and bf16 (launches counted) and times
    the bf16 fuse; with N = 2 the planted faults run in f32."""
    import torch

    from segmif_tpu_torch._device import place
    from segmif_tpu_torch.cli.stretch import synthetic_pair
    from segmif_tpu_torch.models.network import JointPipeline, init_params
    from segmif_tpu_torch.parallel import spatial
    from segmif_tpu_torch.parallel.mesh import make_mesh
    from segmif_tpu_torch.train.steps import make_fuse_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    counters = _counters()
    model = init_params(JointPipeline("mit_b5", STRETCH_CLASSES),
                        torch.Generator().manual_seed(0))
    ir, vis = (t.to(dev) for t in synthetic_pair(*STRETCH_HW))
    ref = {}
    out = {"lines": [], "ok": True, "launches": {}, "ms": {}}
    if comm.rank == 0:
        for name in SPATIAL_TOL:
            fuse = make_fuse_fn(model, getattr(torch, name), dev)
            ref[name] = fuse(ir, vis, vis)[1].float().cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPATIAL_TIMED):
            fuse(ir, vis, vis)
        torch.cuda.synchronize()
        out["ms"][1] = (time.perf_counter() - t0) * 1e3 / SPATIAL_TIMED
        del fuse
    comm.barrier()
    groups = {n: comm.subgroup(range(n)) for n in worlds}

    def held_to_one(label, y, name, fault=False):
        if comm.rank != 0:
            return
        rtol, atol = SPATIAL_TOL[name]
        want = ref[name]
        err = (y.float().cpu() - want).abs().max().item()
        limit = atol + rtol * want.abs().max().item()
        ok = err <= limit and bool(torch.isfinite(y).all())
        out["lines"].append(
            f"{label}: fused Y {tuple(y.shape)} max_abs_err {err:.3e} of "
            f"max |ref| {want.abs().max().item():.3e} (limit {limit:.3e})"
            + (" (the check fails, as it must)" if fault else ""))
        out["ok"] = out["ok"] and (ok != fault)

    for n, sub in groups.items():
        t_n = time.perf_counter()
        if sub is not None:
            mesh = make_mesh(comm=sub)
            for name in SPATIAL_TOL:
                fuse = spatial.make_spatial_fuse_fn(
                    mesh, model, getattr(torch, name), dev)
                for c in counters.values():
                    c.launches = 0
                _, y = fuse(ir, vis, vis)
                torch.cuda.synchronize()
                counts = {k: c.launches for k, c in counters.items()}
                out["launches"][(n, name)] = counts
                rows = sorted({b - a for a, b in
                               spatial.row_blocks(STRETCH_HW[0], n)})
                held_to_one(f"spatial (c) {name}, {n} ranks (blocks of "
                            f"{rows} rows)", y, name)
                if name == "bfloat16":
                    sub.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(SPATIAL_TIMED):
                        fuse(ir, vis, vis)
                    torch.cuda.synchronize()
                    sub.barrier()
                    out["ms"][n] = ((time.perf_counter() - t0) * 1e3
                                    / SPATIAL_TIMED)
                del fuse, y
            if n == 2:
                infer = place(copy.deepcopy(model), dev).eval()
                with torch.inference_mode():
                    taps = infer.seg.encode_taps_raw(vis)
                    y = spatial.spatial_fuse_batched(
                        mesh, infer.fusion, ir, vis[..., 0:1], *taps,
                        halo=8)
                held_to_one("planted fault, spatial (c) f32, 2 ranks, a "
                            "halo of 8 rows", y, "float32", fault=True)
                real = spatial.all_reduce_grams
                spatial.all_reduce_grams = lambda c, g: g
                try:
                    with torch.inference_mode():
                        y = spatial.spatial_fuse_batched(
                            mesh, infer.fusion, ir, vis[..., 0:1], *taps)
                finally:
                    spatial.all_reduce_grams = real
                held_to_one("planted fault, spatial (c) f32, 2 ranks, the "
                            "FFM grams not summed over the ranks", y,
                            "float32", fault=True)
                del infer, taps, y
            torch.cuda.empty_cache()
        comm.barrier()
        out["lines"].append(f"spatial (c) {n} ranks: "
                            f"{time.perf_counter() - t_n:.1f} s")
    out["transport"] = comm.transport
    return out


def parallel_checks(dev, totals, card: str):
    """Phase 13: the parallel paths; see the module docstring."""
    import torch

    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        nccl_check(dev, tmp)
        dp_checks(totals, card, tmp)
        hosts_checks(totals, card, tmp)
        spatial_checks(totals, card, tmp)
    print(f"phase 13: {time.perf_counter() - t_all:.1f} s", flush=True)


def nccl_check(dev, tmp):
    """Phase 13 (b): NCCL at world size 1, one fusion step through the
    DP path against the plain step."""
    import os

    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import JointPipeline
    from segmif_tpu_torch.parallel import dist
    from segmif_tpu_torch.parallel.mesh import batch_shard, make_mesh
    from segmif_tpu_torch.train.compare import (KeepGrads, leaf_errors,
                                                step_grads)
    from segmif_tpu_torch.train.state import FusionTrainState
    from segmif_tpu_torch.train.steps import make_fusion_train_step

    t0 = time.perf_counter()
    comm = dist.init(1, 0, device="cuda",
                     init_method="file://" + os.path.join(tmp, "nccl"))
    try:
        check(comm.backend == "nccl", f"world 1 on the card took "
                                      f"{comm.backend}, not nccl")
        model = drift.init_reference_scale(
            JointPipeline("mit_b3"),
            torch.Generator().manual_seed(SEED + 133))
        batch = train_batch(torch.Generator().manual_seed(SEED + 134),
                            2, *TRAIN_HW, dev)
        want_m, want = step_grads(model, batch, False, torch.float32,
                                  dev, TRAIN_FUSION_SCALE)
        shard = batch_shard(make_mesh(comm=comm), 2)
        m = copy.deepcopy(model)
        tx = KeepGrads()
        step = make_fusion_train_step(m, tx, False,
                                      compute_dtype=torch.float32,
                                      device=dev)
        state = FusionTrainState.create(m.fusion, tx)
        got_m = step(state, batch, TRAIN_FUSION_SCALE, shard=shard)
        rel = abs(got_m["loss"].item() - want_m["loss"].item()) / abs(
            want_m["loss"].item())
        worst = max(leaf_errors(state.opt_state, want).values())
        print(f"parallel (b) NCCL, world 1 ({comm.transport}): one "
              f"f32 round >= 2 fusion step, mit_b3 batch 2 "
              f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, through the DP path "
              f"against the plain step: loss relative {rel:.2e}, worst "
              f"leaf {worst:.3e} (limits {TRAIN_LOSS_RTOL:g}, "
              f"{TRAIN_LEAF_RTOL:g}); {time.perf_counter() - t0:.1f} s",
              flush=True)
        check(rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_LEAF_RTOL,
              "parallel (b): the NCCL step differs")
    finally:
        dist.leave()
    torch.cuda.empty_cache()


def dp_checks(totals, card, tmp, world=DP_WORLD):
    """Phase 13 (a), (d) and their part of (e): DP and the dry run on
    ``world`` ranks (on one card, or one card each)."""
    from segmif_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    dp = dist.launch(dp_rank, world, (), device="cuda", timeout=600,
                     workdir=tmp)
    r0 = dp[0]
    print(f"parallel (a) ranks: {world} on {card}: {r0['transport']}",
          flush=True)
    for ln in r0["lines"]:
        print(ln, flush=True)
    check(r0["ok"], "parallel (a): a DP check failed, or a planted "
                    "fault passed")
    for r, res in enumerate(dp):
        for kind, counts in res["launches"].items():
            check(counts == DP_EXPECT[kind],
                  f"parallel (a) rank {r} {kind}: launches {counts}, "
                  f"expected {DP_EXPECT[kind]}")
            for k, v in counts.items():
                totals[k] += v
        for k, v in res["dryrun_launches"].items():
            totals[k] += v
        check(res["dryrun_launches"]["ffm_grams"] > 0,
              "parallel (d): the dry run launched no FFM kernel")
    print(f"parallel (a) launches per rank per bf16 step: "
          f"{r0['launches']}", flush=True)
    note = SHARED_NOTE if r0["transport"].startswith("gloo") else ""
    for kind, (ms, one_ms) in r0["ms"].items():
        print(f"parallel (e) {kind} step bf16, {world} ranks "
              f"({r0['transport']}; {card}): {ms:.1f} ms per step on "
              f"rank 0 against {one_ms:.1f} ms for one process on the "
              f"whole batch{note}", flush=True)
    print(f"parallel (d) {r0['dryrun']} ({r0['dryrun_s']:.1f} s)",
          flush=True)
    check(dp[1]["dryrun"] == r0["dryrun"],
          "parallel (d): the ranks' dry-run lines differ")
    print(f"parallel (a)+(d): {time.perf_counter() - t0:.1f} s",
          flush=True)
    return r0["transport"]


def hosts_checks(totals, card, tmp):
    """Phase 13 (f) and its part of (e): ``HOSTS`` emulated hosts of
    ``PER_HOST`` ranks (on one card, or one card each)."""
    from segmif_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    world = HOSTS * PER_HOST
    res = dist.launch(hosts_rank, world, (), device="cuda", timeout=600,
                      workdir=tmp, ranks_per_host=PER_HOST)
    r0 = res[0]
    print(f"parallel (f) ranks: {HOSTS} hosts x {PER_HOST} on {card}: "
          f"{r0['transport']}", flush=True)
    for ln in r0["lines"]:
        print(ln, flush=True)
    check(r0["ok"], "parallel (f): a multi-host check failed, or the "
                    "planted fault passed")
    for r, out in enumerate(res):
        h = r // PER_HOST
        check(tuple(out["layout"]) == (h, HOSTS, h, HOSTS, r % PER_HOST),
              f"parallel (f) rank {r}: layout {out['layout']}")
        check(out["rows"] == res[h * PER_HOST]["rows"] and
              out["fault_rows"] == res[0]["rows"],
              f"parallel (f) rank {r}: rows {out['rows']}, fault rows "
              f"{out['fault_rows']}")
        for kind, counts in out["launches"].items():
            check(counts == DP_EXPECT[kind],
                  f"parallel (f) rank {r} {kind}: launches {counts}, "
                  f"expected {DP_EXPECT[kind]}")
            for k, v in counts.items():
                totals[k] += v
    rows = [res[h * PER_HOST]["rows"] for h in range(HOSTS)]
    union = sorted(x for r in rows for x in r)
    check(union == list(range(DP_FUSION[0])),
          f"parallel (f): the hosts' rows {rows} are not one epoch, "
          "disjoint")
    print(f"parallel (f) the hosts' fusion rows {rows}: disjoint, one "
          f"epoch of {DP_FUSION[0]}; launches per rank per step: "
          f"{r0['launches']}", flush=True)
    note = SHARED_NOTE if r0["transport"].startswith("gloo") else ""
    for kind, (ms, one_ms) in r0["ms"].items():
        print(f"parallel (e) {kind} step f32, {HOSTS} hosts x {PER_HOST} "
              f"ranks ({r0['transport']}; {card}): {ms:.1f} ms per step on "
              f"rank 0 against {one_ms:.1f} ms for one process on the "
              f"hosts' batches concatenated{note}", flush=True)
    print(f"parallel (f): {time.perf_counter() - t0:.1f} s", flush=True)
    return r0["transport"]


def spatial_checks(totals, card, tmp, worlds=SPATIAL_WORLDS):
    """Phase 13 (c) and its part of (e): the spatial fuse on each count
    of ranks in ``worlds`` (on one card, or one card each)."""
    from segmif_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    sp = dist.launch(spatial_rank, max(worlds), (worlds,), device="cuda",
                     timeout=600, workdir=tmp)
    r0 = sp[0]
    print(f"parallel (c) ranks: {r0['transport']}", flush=True)
    for ln in r0["lines"]:
        print(ln, flush=True)
    check(r0["ok"], "parallel (c): a spatial check failed, or a "
                    "planted fault passed")
    for r, res in enumerate(sp):
        for (n, name), counts in res["launches"].items():
            check(counts == SPATIAL_EXPECT,
                  f"parallel (c) rank {r} of {n}, {name}: launches "
                  f"{counts}, expected {SPATIAL_EXPECT}")
            for k, v in counts.items():
                totals[k] += v
    print(f"parallel (c) launches per rank per pair: "
          f"{SPATIAL_EXPECT}", flush=True)
    curve = ", ".join(f"{n} rank{'s' * (n > 1)} {ms:.1f} ms"
                      for n, ms in sorted(r0["ms"].items()))
    note = SHARED_NOTE if r0["transport"].startswith("gloo") else ""
    print(f"parallel (e) spatial fuse bf16, mit_b5 {STRETCH_HW[0]}x"
          f"{STRETCH_HW[1]} batch 1 ({r0['transport']}; {card}): "
          f"{curve} (rank 0, host clock over {SPATIAL_TIMED} pairs{note})",
          flush=True)
    print(f"parallel (c): {time.perf_counter() - t0:.1f} s", flush=True)
    return r0["transport"]


# Phase 14: tensor parallelism (segmif_tpu_torch.parallel.tensor) on ranks
# spawned after the build: ranks 0 and 1 form one model group (TP 2), all
# four ranks one model group (TP 4: the q / k / v gather of stages 1-3,
# stage 4 at two heads a rank) and a data 2 x model 2 mesh (DP 2 x TP 2).
# On one card they share it over gloo and measure overhead, not speed-up;
# with --parallel on 4 cards each rank has a card of its own (NCCL).
TP_WORLD, TP_MODEL = 4, 2
TP_REQUESTS = 1
TP_TIMED = 1
# the steps' global fusion batch (phase 13's 8 halved: four ranks' f32
# steps share the card), at 480x640; the seg step's as phase 13's
TP_FUSION_B = 4
# (a) the f32 split forward against one process, per element, within
# these shares of the largest |ref| (PIPE_RTOL: the card-vs-CPU limits;
# here only the order of the row-parallel sums differs)
TP_FWD_RTOL = PIPE_RTOL
# the split of the whole mit_b3 JointPipeline at model 2 (counted on its
# shapes, on the meta device): millions of parameters by column and by row,
# the JAX rule's count (tests/test_torch_tp_specs.py)
TP_SPLIT_M = (19.00, 13.55)
# sr-attention at the heads a rank runs: (stage tokens N, heads a rank) of
# stages 2 and 4 at model 2 and stage 4 at model 4; M = 300 key rows
TP_SR_SHAPES = ((4800, 1), (300, 4), (300, 2))


def serving_expect(backbone="mit_b3") -> dict:
    """Phase 5's launches per request of each serving mode, for
    ``backbone``'s MiT stage depths (phase 14 serves PAR_BACKBONE):
    sr-attention once a block of the guide taps (stages 1-2, default mode)
    and the seg pass."""
    from segmif_tpu_torch.models import mit

    depths = mit.MIT_VARIANTS[backbone].depths
    float_drdb = {"drdb_growth": 4, "drdb_tail": 4, "drdb_int8_growth": 0,
                  "drdb_int8_tail": 0}
    expect = {}
    for mode, sr in (("default", sum(depths[:2]) + sum(depths)),
                     ("static_guide", sum(depths))):
        expect[mode] = {"sr_attention": sr, "ffm_grams": 2, "ffm_apply": 2,
                        **float_drdb}
        expect["int8_" + mode] = {**expect[mode], **{
            k: 4 - v for k, v in float_drdb.items()}}
    return expect


def _full_weight_reduce_scatter(lin):
    """Planted fault: the FFM's gathered weights summed over the group in
    the backward (a reduce-scatter where the slice belongs)."""
    import torch

    from segmif_tpu_torch.parallel import tensor

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, comm, dim):
            ctx.args = (comm, dim)
            return tensor.join(comm.all_gather(x, dim), comm.world, dim)

        @staticmethod
        def backward(ctx, g):
            comm, dim = ctx.args
            return comm.reduce_scatter(g.contiguous(), dim), None, None

    split = tensor._split(lin)
    if split is None:
        return lin.weight
    return Fn.apply(lin.weight, split[0], split[1])


def _bias_every_rank(x, lin, comm):
    """Planted fault: a row-parallel linear's bias added on every rank."""
    import torch.nn.functional as F

    from segmif_tpu_torch.parallel import tensor

    return tensor.reduce(F.linear(x, lin.weight, lin.bias), comm)


def _name_rule(key):
    """Planted fault: the split rule keyed by the port's own names."""
    *mods, leaf = key.split(".")
    return mods + ["kernel" if leaf == "weight" else leaf]


@contextlib.contextmanager
def _patched(module, name, fake):
    real = getattr(module, name)
    setattr(module, name, fake)
    try:
        yield
    finally:
        setattr(module, name, real)


def _split_outputs(model, mesh, x, dev, dtype):
    """(fused Y, logits) of a copy of ``model`` in ``dtype``, split over
    ``mesh`` (whole without one), as f32 on the CPU."""
    import torch

    from segmif_tpu_torch._device import place
    from segmif_tpu_torch.parallel.tensor import tensor_parallel

    m = place(copy.deepcopy(model), dev).to(dtype).eval()
    if mesh is not None:
        tensor_parallel(m, mesh)
    with torch.inference_mode():
        _, y, logits = m(*(t.to(dev, dtype) for t in x))
    return y.float().cpu(), logits.float().cpu()


def _serve_all(model, mesh, reqs, guide, cal, dev, counters):
    """Phase 14 (b)'s three bf16 serving modes of ``model`` (split over
    ``mesh``, whole without one) on ``reqs``: {mode: ([(fused Y, pred)]
    on the CPU, [launches per request])} and the default mode's ms per
    request (host clock, synchronised, after the checked requests)."""
    import torch

    from segmif_tpu_torch.ops.color import rgb_to_ycrcb
    from segmif_tpu_torch.serving import make_serving_fn

    mb = copy.deepcopy(model).to(torch.bfloat16)
    serves = {"default": make_serving_fn(mb, device=dev, mesh=mesh),
              "static_guide": make_serving_fn(mb, guide_rgb=guide.to(dev),
                                              device=dev, mesh=mesh),
              "int8_default": make_serving_fn(
                  mb, int8_calibration=tuple(t.to(dev) for t in cal),
                  device=dev, mesh=mesh)}
    out = {}
    for mode, serve in serves.items():
        outs, counts = [], []
        for ir, vis in reqs:
            for c in counters.values():
                c.launches = 0
            rgb, pred = serve(ir.to(dev), vis.to(dev))
            torch.cuda.synchronize()
            counts.append({k: c.launches for k, c in counters.items()})
            outs.append((rgb_to_ycrcb(rgb.float())[..., 0].cpu(),
                         pred.cpu()))
        out[mode] = (outs, counts)
    serve = serves["default"]
    t0 = time.perf_counter()
    for ir, vis in reqs * TP_TIMED:
        serve(ir.to(dev), vis.to(dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (len(reqs) * TP_TIMED)
    return out, ms


def _serve_held(got, want):
    """(passed, line): the split serving's outputs against one process's,
    under ``drift``'s limits on the fused Y (SSIM, max abs) and on the
    class map (agreement; serving returns no logits)."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.ops.ssim import ssim

    (ys, ps), (ys_e, ps_e) = (map(torch.cat, zip(*t)) for t in (got, want))
    d = {"fused_y_ssim": ssim(ys[..., None], ys_e[..., None]).item(),
         "fused_y_max_abs": (ys - ys_e).abs().max().item(),
         "argmax_agreement": (ps == ps_e).float().mean().item()}
    limits = {n: (op, lim) for n, op, lim in drift.BF16_LIMITS}
    keys = ("fused_y_ssim", "fused_y_max_abs", "argmax_agreement")
    ok = all(d[n] > limits[n][1] if limits[n][0] == ">" else
             d[n] < limits[n][1] for n in keys)
    return ok, ", ".join(f"{n} {d[n]:.5f} (limit {limits[n][0]} "
                         f"{limits[n][1]:g})" for n in keys)


def _fwd_held(got, want):
    """(passed, line) of (a): fused Y and logits per element within
    TP_FWD_RTOL of the largest |ref|."""
    import torch

    parts, ok = [], True
    for name, g, e in zip(("fused_y", "logits"), got, want):
        err, top = max_err(g, e), e.abs().max().item()
        ok = ok and err <= TP_FWD_RTOL[name] * top and \
            bool(torch.isfinite(g).all())
        parts.append(f"{name} {tuple(g.shape)} max_abs_err {err:.3e} of "
                     f"max |ref| {top:.3e} (limit {TP_FWD_RTOL[name]:g} of"
                     " it)")
    return ok, "; ".join(parts)


def tp_kernel_checks(model, dev, rank) -> list:
    """Phase 14, each kernel held against its plain version at the split
    path's shapes on rank 0 of the model group: sr-attention at the heads
    a rank runs (both dtypes); the FFM grams and apply with the weights
    gathered from the ranks' pieces (bf16, [8, 307200, 64]; every rank of
    the group gathers); the DRDB growth and tail and the int8 DRDB with a
    rank's whole weights (bf16, [8, 64, 480, 640]; the int8 scales from
    these inputs, as phase 4). Returns (passed, line) pairs."""
    import torch

    from segmif_tpu_torch.kernels.attention import (sr_attention,
                                                    sr_attention_ref)
    from segmif_tpu_torch.kernels.drdb import (drdb_growth, drdb_growth_ref,
                                               drdb_tail, drdb_tail_ref)
    from segmif_tpu_torch.kernels.ffm import (apply_args,
                                              crosspath_apply_rows,
                                              crosspath_apply_rows_ref,
                                              crosspath_grams,
                                              crosspath_grams_ref,
                                              projections)
    from segmif_tpu_torch.kernels.int8 import (drdb_int8_growth,
                                               drdb_int8_growth_ref,
                                               drdb_int8_tail,
                                               drdb_int8_tail_ref,
                                               quantize_drdb, record_amax)

    bf = torch.bfloat16
    cross = model.fusion.ffm.cross
    w = {k: v.detach() for k, v in cross.folded_weights().items()}
    if rank != 0:
        return []
    lines = []
    gen = torch.Generator().manual_seed(SEED + 142)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    def line(ok, text):
        lines.append((ok, text))

    for dtype in (torch.float32, bf):
        dname = str(dtype).split(".")[1]
        for n, h in TP_SR_SHAPES:
            q, k, v = kv_halves(randn, BATCH, n, 300, h, 64, dtype)
            got = sr_attention(q, k, v, 0.125)
            ratio, err, diff, ok = held(got, sr_attention_ref(q, k, v, 0.125),
                                        SR_TOL[dname])
            line(ok, f"tp kernels: sr_attention {dname} B={BATCH} N={n} "
                     f"M=300 H={h} (a rank's heads): "
                     f"{verdict(ratio, err, diff, SR_TOL[dname])}")
    n, c = H * W, 64
    x1, x2, s = (randn((BATCH, n, c), bf) for _ in range(3))
    wp, bp = projections(w)
    grams = crosspath_grams(x1, x2, s, wp, bp)
    want = crosspath_grams_ref(x1, x2, s, wp, bp)
    err, top = max_err(grams, want), want.abs().max().item()
    rtol = GRAM_RTOL["bfloat16"][0]
    line(err <= rtol * top, f"tp kernels: ffm_grams bfloat16 B={BATCH} "
                            f"N={n}, weights gathered from 2 ranks: "
                            f"max_abs_err {err:.3e} of max |gram| {top:.3e}"
                            f" (rtol {rtol:g})")
    args = (x1, x2, s, wp, bp, *apply_args(want, w, cross.scale,
                                           cross.num_heads))
    ratio, err, diff, ok = held(crosspath_apply_rows(*args),
                                crosspath_apply_rows_ref(*args),
                                APPLY_TOL["bfloat16"])
    line(ok, f"tp kernels: ffm_apply bfloat16 B={BATCH} N={n}, weights "
             f"gathered: {verdict(ratio, err, diff, APPLY_TOL['bfloat16'])}")
    del x1, x2, s, grams, want, args
    drdb = model.fusion.DRDB1
    dconvs, (wb, bb) = drdb._weights()
    x = randn((BATCH, H, W, 64), bf).permute(0, 3, 1, 2)
    gpk, tpk = drdb.kernel_weights(bf)
    rs = drdb_growth(x, dconvs, gpk)
    ratio, err = worst(rs, drdb_growth_ref(x, dconvs), GROWTH_TOL["bfloat16"])
    line(ratio <= 1.0, f"tp kernels: drdb_growth bfloat16 [{BATCH}, 64, {H},"
                       f" {W}], a rank's whole DRDB1: max_abs_err {err:.3e},"
                       f" worst error/limit {ratio:.3f}")
    ratio, err = worst((drdb_tail(x, rs, wb, bb, wpk=tpk),),
                       (drdb_tail_ref(x, rs, wb, bb),),
                       TAIL_TOL["bfloat16"], x=x)
    line(ratio <= 1.0, f"tp kernels: drdb_tail bfloat16, the same: "
                       f"max_abs_err {err:.3e}, worst error/limit "
                       f"{ratio:.3f}")
    q = quantize_drdb(dconvs, (wb, bb), record_amax([x, *rs]))
    del rs
    feat = drdb_int8_growth(x, q)
    same_g = torch.equal(feat, drdb_int8_growth_ref(x, q))
    same_t = torch.equal(drdb_int8_tail(x, feat, q),
                         drdb_int8_tail_ref(x, feat, q))
    line(same_g and same_t, f"tp kernels: drdb_int8 growth and tail "
                            f"[{BATCH}, 64, {H}, {W}] bf16 x, a rank's whole "
                            f"int8 DRDB1: bit for bit {same_g}, {same_t}")
    del x, feat
    torch.cuda.empty_cache()
    return lines


def tp_rank(comm):
    """Phase 14 on one of the TP ranks: rank 0 first runs every path in
    one process while the others wait; then ranks 0-1 run (a), (b) and
    the kernels at their shapes and (c) on TP 2, every rank (a) and (b)
    on TP 4, (c) on DP 2 x TP 2 and (d) the dry run. Rank 0 returns the
    lines and verdicts; every rank its launches."""
    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch._device import place
    from segmif_tpu_torch.models.network import JointPipeline
    from segmif_tpu_torch.parallel import dryrun, tensor
    from segmif_tpu_torch.parallel import mesh as mesh_mod
    from segmif_tpu_torch.parallel.mesh import (batch_shard, make_mesh,
                                                param_shardings)
    from segmif_tpu_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comm.device
    counters = _counters()
    sub = comm.subgroup(range(TP_MODEL))
    mesh2 = None if sub is None else make_mesh(1, TP_MODEL, comm=sub)
    mesh4 = make_mesh(comm.world // TP_MODEL, TP_MODEL, comm=comm)
    mesh_all = make_mesh(1, comm.world, comm=comm)
    out = {"lines": [], "ok": True, "launches": {}, "ms": {},
           "transport": comm.transport}
    r0 = comm.rank == 0

    def line(ok, text, fault=False):
        if r0:
            out["lines"].append(text + (" (the check fails, as it must)"
                                        if fault else ""))
            out["ok"] = out["ok"] and (ok != fault)

    def forward_check(mesh):
        """(a): the f32 forward split over ``mesh``'s model group."""
        got = _split_outputs(model, mesh, reqs[0], dev, f32)
        ok, text = _fwd_held(got, ref.get("fwd", got))
        line(ok, f"tp (a) f32 forward, TP {mesh.model}, batch {BATCH} "
                 f"{H}x{W}, against one process: {text}")
        torch.cuda.empty_cache()

    def serve_checks(mesh):
        """(b): the three bf16 serving modes split over ``mesh``'s model
        group, the same outputs on its every rank, launches per rank."""
        m = mesh.model
        got, out["ms"][f"serve tp{m}"] = _serve_all(model, mesh, reqs, guide,
                                                    cal, dev, counters)
        expect = serving_expect(par_backbone())
        for mode, (outs, counts) in got.items():
            out["launches"][f"serving {mode} tp{m}"] = counts
            same = _agree(mesh.model_comm, {
                f"{i} {j}": t.float() for i, o in enumerate(outs)
                for j, t in enumerate(o)})
            if r0:
                ok, text = _serve_held(outs, ref["serve"][mode][0])
                line(ok and same, f"tp (b) bf16 serving {mode}, TP {m}, "
                     f"{TP_REQUESTS} requests of {BATCH}, against one "
                     f"process: {text}; the {m} ranks' outputs the same: "
                     f"{same}; launches per request on rank 0 {counts[0]} "
                     f"(expected {expect[mode]})")
        torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(SEED + 140)
    reqs = requests(gen, TP_REQUESTS, BATCH, "cpu")
    guide = torch.rand((BATCH, H, W, 3), generator=gen)
    cal = requests(gen, 1, BATCH, "cpu")[0]
    model = drift.init_reference_scale(
        JointPipeline(par_backbone()),
        torch.Generator().manual_seed(SEED + 141))
    steps_models = _dp_models()
    fusion_batch = _dp_batches(TP_FUSION_B)[0]
    f32 = torch.float32
    ref = {}
    secs = [time.perf_counter()]
    if r0:   # one process, on the whole model
        t0 = time.perf_counter()
        ref["fwd"] = _split_outputs(model, None, reqs[0], dev, f32)
        ref["serve"], out["ms"]["serve one"] = _serve_all(
            model, None, reqs, guide, cal, dev, counters)
        ref["steps"] = dp_steps(steps_models, dev, f32, timed=TP_TIMED,
                                fusion_batch=fusion_batch)
        out["ms"].update({f"one {k}": v["ms"]
                          for k, v in ref["steps"].items()})
        out["ms"]["one process s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    comm.barrier()
    secs.append(time.perf_counter())
    if mesh2 is not None:
        # (a) the f32 split forward, batch 8, 480x640
        with torch.device("meta"):   # the whole mit_b3, shapes only
            whole = dict(JointPipeline("mit_b3").named_parameters())
        dims = param_shardings(TP_MODEL, whole)
        shares = tuple(round(sum(p.numel() for n, p in whole.items()
                                 if dims[n] == d) / 1e6, 2) for d in (0, 1))
        line(shares == TP_SPLIT_M, f"tp split of mit_b3 at model "
             f"{TP_MODEL} (the rule on the whole model's shapes): "
             f"{shares[0]:.2f} M parameters by column, {shares[1]:.2f} M by "
             f"row (expected {TP_SPLIT_M}, the JAX rule's count)")
        del whole
        forward_check(mesh2)
        for label, (mod, name, fake) in {
                "proj's and fc2's bias added on every rank": (
                    tensor, "row_linear", _bias_every_rank),
                "kv split contiguously (JAX's columns taken literally)": (
                    tensor, "kv_parts", lambda key: 1)}.items():
            with _patched(mod, name, fake):
                bad = _split_outputs(model, mesh2, reqs[0], dev, f32)
            ok, text = _fwd_held(bad, ref.get("fwd", bad))
            line(ok, f"planted fault, tp (a), {label}: {text}", fault=True)
        with _patched(mesh_mod, "jax_path", _name_rule):
            try:
                _split_outputs(model, mesh2, reqs[0], dev, f32)
                refused = "split and ran"
            except ValueError as e:
                refused = f"refused: {str(e)[:100]}..."
        line(refused.startswith("split"), "planted fault, tp (a), the decode"
             f" head's linear_c*.proj split by a name-based rule: {refused}",
             fault=True)
        torch.cuda.empty_cache()
        # (b) bf16 serving in three modes, and the kernels at these shapes
        serve_checks(mesh2)
        mb = tensor.tensor_parallel(place(copy.deepcopy(model), dev).to(
            torch.bfloat16).eval(), mesh2)
        with torch.inference_mode():
            for ok, text in tp_kernel_checks(mb, dev, sub.rank):
                line(ok, text)
        del mb
        torch.cuda.empty_cache()
        # (c) the steps on TP 2
        res = dp_steps(steps_models, dev, f32, timed=TP_TIMED,
                       counters=counters, fusion_batch=fusion_batch,
                       mesh=mesh2)
        same = _agree(sub, _step_leaves(res))
        out["launches"].update({f"tp2 {k}": [res[k]["launches"]]
                                for k in res})
        out["ms"].update({f"tp2 {k}": res[k]["ms"] for k in res})
        if r0:
            for ok, text in dp_compare(f"tp (c) f32, TP {TP_MODEL}", res,
                                       ref["steps"], "float32"):
                line(ok, text)
            line(same, f"tp (c) f32, TP {TP_MODEL}: both ranks' whole and "
                       f"gathered leaves, gradients and BN buffers the "
                       f"same: {same}")
        del res
        with _patched(tensor, "full_weight", _full_weight_reduce_scatter):
            bad = dp_steps(steps_models, dev, f32, kinds=("fusion",),
                           fusion_batch=fusion_batch, mesh=mesh2)
        if r0:
            for ok, text in dp_compare("planted fault, tp (c), the FFM "
                                       "gather's backward a reduce-scatter",
                                       bad, ref["steps"], "float32"):
                line(ok, text, fault=True)
        del bad
        torch.cuda.empty_cache()
    comm.barrier()
    secs.append(time.perf_counter())
    # (a) and (b) on TP 4: every rank one model group
    forward_check(mesh_all)
    serve_checks(mesh_all)
    secs.append(time.perf_counter())
    # (c) the steps on DP 2 x TP 2
    shard = (batch_shard(mesh4, TP_FUSION_B), batch_shard(mesh4, DP_SEG[0]))
    res = dp_steps(steps_models, dev, f32, shard, timed=TP_TIMED,
                   counters=counters, fusion_batch=fusion_batch, mesh=mesh4)
    same = _agree(comm, _step_leaves(res))
    out["launches"].update({f"dp2xtp2 {k}": [res[k]["launches"]]
                            for k in res})
    out["ms"].update({f"dp2xtp2 {k}": res[k]["ms"] for k in res})
    if r0:
        for ok, text in dp_compare(f"tp (c) f32, DP {mesh4.data} x TP "
                                   f"{TP_MODEL}", res, ref["steps"],
                                   "float32"):
            line(ok, text)
        line(same, f"tp (c) f32, DP {mesh4.data} x TP {TP_MODEL}: every "
                   f"rank's gathered leaves, gradients and BN buffers the "
                   f"same: {same}")
    del res
    real_sum = steps._sum_over_ranks

    def world_sum(shard, grads, losses):
        return real_sum(dataclasses.replace(shard, comm=comm), grads, losses)

    with _patched(steps, "_sum_over_ranks", world_sum):
        bad = dp_steps(steps_models, dev, f32, shard, kinds=("fusion",),
                       fusion_batch=fusion_batch, mesh=mesh4)
    if r0:
        for ok, text in dp_compare("planted fault, tp (c), the gradients "
                                   "summed over every rank, not the data "
                                   "group", bad, ref["steps"], "float32"):
            line(ok, text, fault=True)
    del bad
    torch.cuda.empty_cache()
    # (d) the dry run on every rank: data 2 x model 2
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.dryrun(comm)
    out["ms"]["dryrun s"] = time.perf_counter() - t0
    out["dryrun_launches"] = {k: c.launches for k, c in counters.items()}
    secs += [t0, time.perf_counter()]
    line(True, "tp seconds on rank 0: one process "
         f"{secs[1] - secs[0]:.1f}, TP 2 {secs[2] - secs[1]:.1f}, TP 4 "
         f"{secs[3] - secs[2]:.1f}, DP 2 x TP 2 {secs[4] - secs[3]:.1f}, dry "
         f"run {secs[5] - secs[4]:.1f}")
    return out


def tp_checks(totals, card, tmp, world=TP_WORLD):
    """Phase 14: tensor parallelism on ``world`` ranks (on one card, or
    one card each); see the module docstring."""
    from segmif_tpu_torch.parallel import dist

    t0 = time.perf_counter()
    res = dist.launch(tp_rank, world, (), device="cuda", timeout=900,
                      workdir=tmp)
    r0 = res[0]
    print(f"tp ranks: {world} on {card}: {r0['transport']}", flush=True)
    for ln in r0["lines"]:
        print(ln, flush=True)
    check(r0["ok"], "phase 14: a tensor-parallel check failed, or a "
                    "planted fault passed")
    expect = serving_expect(par_backbone())
    for r, out in enumerate(res):
        for key, per_call in out["launches"].items():
            want = (expect[key.split()[1]] if key.startswith("serving")
                    else DP_EXPECT[key.split()[1]])
            for counts in per_call:
                check(counts == want, f"phase 14 rank {r} {key}: launches "
                                      f"{counts}, expected {want}")
                for k, v in counts.items():
                    totals[k] += v
        for k, v in out["dryrun_launches"].items():
            totals[k] += v
        check(out["dryrun"] == r0["dryrun"],
              "phase 14 (d): the ranks' dry-run lines differ")
    sr = serving_expect(par_backbone())
    print(f"tp launches per rank: serving on TP {TP_MODEL} and TP {world} "
          f"as phase 5 at {PAR_BACKBONE} (sr-attention "
          f"{sr['default']['sr_attention']} / "
          f"{sr['static_guide']['sr_attention']} at a rank's heads or all "
          f"heads gathered, FFM 2 + 2, DRDB 4 + 4 or int8 4 + 4); steps as "
          f"phase 13 ({DP_EXPECT}); on every rank", flush=True)
    note = SHARED_NOTE if r0["transport"].startswith("gloo") else ""
    ms = r0["ms"]
    print(f"tp (e) ({r0['transport']}; {card}): bf16 serving default, "
          f"batch {BATCH}: TP {TP_MODEL} {ms[f'serve tp{TP_MODEL}']:.1f} / "
          f"TP {world} {ms[f'serve tp{world}']:.1f} ms per request against "
          f"{ms['serve one']:.1f} ms in one process; f32 steps "
          f"(fusion batch {TP_FUSION_B} {H}x{W}, seg batch {DP_SEG[0]} "
          f"{DP_SEG[1]}x{DP_SEG[2]}) ms per step on rank 0, one process / "
          f"TP {TP_MODEL} / DP 2 x TP {TP_MODEL}: fusion "
          f"{ms['one fusion']:.1f} / "
          f"{ms['tp2 fusion']:.1f} / {ms['dp2xtp2 fusion']:.1f}, seg "
          f"{ms['one seg']:.1f} / {ms['tp2 seg']:.1f} / "
          f"{ms['dp2xtp2 seg']:.1f}{note}", flush=True)
    print(f"tp (d) {r0['dryrun']} ({ms['dryrun s']:.1f} s)", flush=True)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)
    return r0["transport"]


def nccl_run(card: str) -> int:
    """``--parallel`` on several cards: phase 13 (a), (c)-(f)
    with one rank per card of this host, over NCCL
    (``dist.choose_backend``'s rule); the spatial fuse on 2 ranks and on
    every card; phase 14 on 4 ranks (TP 2 on two cards, TP 4 and DP 2 x
    TP 2 on four; with fewer than 4 cards its ranks share them over
    gloo). Returns the exit code."""
    import torch

    n = torch.cuda.device_count()
    totals = {k: 0 for k in _counters()}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for transport in (dp_checks(totals, card, tmp, world=n),
                          spatial_checks(totals, card, tmp,
                                         worlds=tuple(sorted({2, n})))):
            check(transport.startswith("nccl"),
                  f"{n} ranks on {n} cards took {transport}, not nccl")
        transport = hosts_checks(totals, card, tmp)
        check(transport.startswith("nccl") == (n >= HOSTS * PER_HOST),
              f"phase 13 (f)'s {HOSTS * PER_HOST} ranks on {n} cards took "
              f"{transport}")
        transport = tp_checks(totals, card, tmp)
        check(transport.startswith("nccl") == (n >= TP_WORLD),
              f"phase 14's {TP_WORLD} ranks on {n} cards took {transport}")
    check(all(totals[k] > 0 for k, v in STRETCH_FUSE.items() if v),
          f"a kernel of the parallel paths never launched: {totals}")
    print(f"phases 13 and 14 on {n} cards: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--parallel", action="store_true",
                   help="phases 1-3, 13 and 14 alone; with several cards, "
                        "one rank per card over NCCL")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import segmif_tpu_torch

    pkg = Path(segmif_tpu_torch.__file__).resolve()
    check(ROOT in pkg.parents,
          f"segmif_tpu_torch imported from {pkg}, not from this checkout")
    from segmif_tpu_torch.kernels import _build
    from segmif_tpu_torch.kernels.attention import sr_attention
    from segmif_tpu_torch.kernels.drdb import drdb_growth, drdb_tail
    from segmif_tpu_torch.kernels.ffm import (crosspath_apply_rows,
                                              crosspath_grams)
    from segmif_tpu_torch.kernels.int8 import (drdb_int8_growth,
                                               drdb_int8_tail)
    from segmif_tpu_torch.serving import make_serving_fn, quantize_for_serving
    from segmif_tpu_torch.utils.profiler import span_totals, spans_on

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # phase 2: the card
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(card, flush=True)
    if args.parallel and torch.cuda.device_count() > 1:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)

    # phase 3: build
    with spans_on():
        _build.library()
    build_ns = span_totals()["kernels/library"][0]
    srcs = ", ".join(str(p.relative_to(ROOT)) for p in _build.sources())
    print(f"build: {build_ns / 1e9:.1f} s, nvcc "
          f"{' '.join(_build.ARCH_FLAGS)}, from {srcs}", flush=True)
    if args.parallel:
        if torch.cuda.device_count() > 1:
            return nccl_run(card)
        totals = {k: 0 for k in _counters()}
        parallel_checks(dev, totals, card)
        with tempfile.TemporaryDirectory() as tmp:
            tp_checks(totals, card, tmp)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}}), flush=True)
        return 0

    print(f"phases 1-3: {time.perf_counter() - t_start:.1f} s", flush=True)
    refs = CpuReferences()

    # phase 4: kernels vs plain at main-path shapes
    t0 = time.perf_counter()
    kres = kernel_checks(dev)
    ffm_backward_checks(dev)
    sr_attention_backward_checks(dev)
    with torch.inference_mode():
        kres.update(drdb_checks(dev))
        kres.update(drdb_int8_checks(dev))
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 6 first half: the CPU reference at batch 1, f32 (same weights)
    t0 = time.perf_counter()
    model, gen, (ir1, vis1) = pipeline_inputs()
    y_cpu, logits_cpu, cpu_s = refs.get("pipeline")
    model.to(dev, memory_format=torch.channels_last)
    with torch.inference_mode():
        _, y_gpu, logits_gpu = model(ir1.to(dev), vis1.to(dev))
    torch.cuda.synchronize()
    float_cpu = {"fused_y": y_cpu, "logits": logits_cpu}
    for name, got, want in (("fused_y", y_gpu, y_cpu),
                            ("logits", logits_gpu, logits_cpu)):
        err = max_err(got.cpu(), want)
        scale = want.abs().max().item()
        rtol = PIPE_RTOL[name]
        print(f"pipeline b1 f32 card vs CPU {name} {tuple(got.shape)}: "
              f"max_abs_err {err:.3e} of max |ref| {scale:.3e} "
              f"(rtol {rtol:g}: f32 sums in other orders through the "
              f"network on two devices)", flush=True)
        check(bool(torch.isfinite(got).all()), f"{name} not finite")
        check(err <= rtol * scale, f"pipeline {name} error {err}")
    print(f"cpu reference forward: {cpu_s:.1f} s (in the CPU references' "
          f"process)", flush=True)

    # phase 6, int8: calibrated on the card; the same amaxes and packed
    # weights on the CPU (plain int8 DRDB). The float path's last-bit
    # differences put some activations on the other side of a rounding
    # boundary, and each such flip moves an int8 value by one step, as the
    # rounding itself does; the FFM's grams spread every flip over the
    # whole image. So the card-vs-CPU rmse is held to the quantisation
    # noise itself: the CPU's int8-vs-float rmse.
    q_gpu = quantize_for_serving(model, (ir1, vis1))
    q_cpu = copy.deepcopy(q_gpu).to("cpu")
    with torch.inference_mode():
        _, y_gpu, logits_gpu = q_gpu(ir1.to(dev), vis1.to(dev))
        _, y_cpu, logits_cpu = q_cpu(ir1, vis1)
    torch.cuda.synchronize()
    for name, got, want in (("fused_y", y_gpu, y_cpu),
                            ("logits", logits_gpu, logits_cpu)):
        d = got.cpu() - want
        rmse = d.pow(2).mean().sqrt().item()
        noise = (want - float_cpu[name]).pow(2).mean().sqrt().item()
        std = float_cpu[name].std().item()
        print(f"pipeline b1 f32 int8 card vs CPU {name} "
              f"{tuple(got.shape)}: max_abs_err {d.abs().max().item():.3e} "
              f"of max |ref| {want.abs().max().item():.3e}, rmse "
              f"{rmse:.3e} = {rmse / std:.5f} std; limit: the CPU's int8 "
              f"vs float rmse {noise:.3e} = {noise / std:.5f} std (one-step"
              f" int8 flips where f32 sums in other orders meet a rounding "
              f"boundary)", flush=True)
        check(bool(torch.isfinite(got).all()), f"int8 {name} not finite")
        check(rmse <= noise,
              f"int8 pipeline {name} differs between the card and the CPU")
    del q_gpu, q_cpu
    bf16_vs_f32(dev)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 5: the main path, bf16 batch 8, both serving modes
    t0 = time.perf_counter()
    model.to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats(dev)
    reqs = requests(gen, REQUESTS, BATCH, dev)
    guide = torch.rand((BATCH, H, W, 3), generator=gen).to(dev)
    counters = {"sr_attention": sr_attention,
                "ffm_grams": crosspath_grams,
                "ffm_apply": crosspath_apply_rows,
                "drdb_growth": drdb_growth,
                "drdb_tail": drdb_tail,
                "drdb_int8_growth": drdb_int8_growth,
                "drdb_int8_tail": drdb_int8_tail}
    expect = serving_expect()
    cal = requests(gen, 1, BATCH, dev)[0]   # one calibration batch
    qmodel = quantize_for_serving(model, cal)
    serves = {"default": make_serving_fn(model),
              "static_guide": make_serving_fn(model, guide_rgb=guide),
              "int8_default": make_serving_fn(qmodel),
              "int8_static_guide": make_serving_fn(
                  model, guide_rgb=guide, int8_calibration=cal)}
    totals = {k: 0 for k in counters}
    preds = {}
    for mode, serve in serves.items():
        preds[mode] = []
        for i, (ir, vis) in enumerate(reqs):
            for fn in counters.values():
                fn.launches = 0
            rgb, pred = serve(ir, vis)
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in counters.items()}
            for k in counts:
                totals[k] += counts[k]
            check(counts == expect[mode],
                  f"{mode} request {i}: launches {counts}, "
                  f"expected {expect[mode]}")
            check(rgb.shape == (BATCH, H, W, 3) and
                  pred.shape == (BATCH, H, W), f"{mode} output shapes")
            check(pred.dtype == torch.int32, f"{mode} pred dtype")
            check(bool(torch.isfinite(rgb).all()), f"{mode} rgb not finite")
            check(rgb.min().item() >= 0.0 and rgb.max().item() <= 1.0,
                  f"{mode} fused_rgb outside [0,1]")
            check(pred.min().item() >= 0 and pred.max().item() < 9,
                  f"{mode} pred outside [0,9)")
            preds[mode].append(pred)
        print(f"serving {mode}: {REQUESTS} requests of {BATCH} pairs, "
              f"launches per request {counts}; outputs finite, fused_rgb "
              f"in [0,1], pred in [0,9)", flush=True)

    # int8 against bf16 on the same weights and inputs (accuracy.py's
    # drift report: fused-Y max diff, and argmax agreement)
    with torch.inference_mode():
        _, y_bf16 = model.fuse(*reqs[0])
        _, y_int8 = qmodel.fuse(*reqs[0])
    y_bf16, y_int8 = y_bf16.float(), y_int8.float()
    rmse = (y_int8 - y_bf16).pow(2).mean().sqrt().item()
    std = y_bf16.std().item()
    agree = {m: torch.cat([(a == b).flatten() for a, b in zip(
        preds["int8_" + m], preds[m])]).float().mean().item()
        for m in ("default", "static_guide")}
    print(f"int8 vs bf16 serving drift (request 0, default mode): fused_y "
          f"max diff {max_err(y_int8, y_bf16):.4e}, rmse {rmse:.4e} = "
          f"{rmse / std:.4f} std (limit {INT8_DRIFT_RMSE}); argmax "
          f"agreement over {REQUESTS} requests: default {agree['default']:.5f}"
          f", static guide {agree['static_guide']:.5f}", flush=True)
    check(rmse < INT8_DRIFT_RMSE * std, "int8 serving drifts from bf16")
    del y_bf16, y_int8, preds
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 7: pairs/s, CUDA events, after warm-up; no hold: the host's
    # pace is part of what a request costs
    t0 = time.perf_counter()
    for mode, serve in serves.items():
        batches = itertools.cycle(reqs)
        ms = time_fn(lambda: serve(*next(batches)), 2 * REQUESTS, hold=False)
        print(f"throughput {mode}: {BATCH * 1e3 / ms:.3f} pairs/s "
              f"({ms:.2f} ms per batch of {BATCH}, bf16"
              f"{', int8 DRDBs' if mode.startswith('int8') else ''}, "
              f"{H}x{W}, mit_b3)", flush=True)
    print(f"peak device memory, serving (phases 5 and 7): "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    del serves, model, qmodel, reqs, guide, cal
    torch.cuda.empty_cache()
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 8: fusion-phase training
    t0 = time.perf_counter()
    train_checks(dev, counters, refs)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 9: the interactive trainer
    t0 = time.perf_counter()
    seg_step_checks(dev, refs)
    driver_kernel_checks(dev, kres)
    trainer_run(dev, counters, totals)
    seg_step_timing(dev)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)

    # phase 10: disk to disk
    t0 = time.perf_counter()
    disk_to_disk(dev, counters, totals, card)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)

    # phases 11 (the fusion variants and the accuracy artifact) and 12
    # (the stretch, serving export and repeatability): first the sections
    # that time the card, 11 (a), 12 (a), (b) and (d); then 12 (e)'s child
    # and the export's fresh process, each on the card beside the untimed
    # checks 11 (b)-(e) and 12 (c)
    t0 = time.perf_counter()
    variant_serving(dev, counters, totals)
    stretch_rows = stretch_kernel_checks(dev)
    stretch_cli_checks(dev, counters, totals)
    with tempfile.TemporaryDirectory() as tmp:
        fresh = export_checks(dev, counters, totals, tmp)
        repeat = start_repeatability()
        print(f"phases 11 (a), 12 (a), (b), (d): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        variant_card_vs_cpu(dev, refs)
        attention_maps(dev, counters, totals)
        accuracy_checks(dev)
        stretch_pipeline_checks(dev, refs)
        repeatability(repeat)
        fresh_process_check(fresh)
    print(json.dumps({"stretch_kernels": stretch_rows}), flush=True)
    print(f"phases 11 (b)-(e), 12 (c), (e): {time.perf_counter() - t0:.1f} "
          f"s", flush=True)

    # phase 13: the parallel paths
    parallel_checks(dev, totals, card)

    # phase 14: tensor parallelism
    with tempfile.TemporaryDirectory() as tmp:
        tp_checks(totals, card, tmp)

    src = "segmif_tpu_torch/kernels/csrc/"
    meta = {
        "sr_attention": (src + "sr_attention.cu",
                         "segmif_tpu/kernels/pallas_attention.py:59"),
        "ffm_grams": (src + "ffm.cu", "segmif_tpu/kernels/pallas_ffm.py:231"),
        "ffm_apply": (src + "ffm.cu", "segmif_tpu/kernels/pallas_ffm.py:304"),
        "drdb_growth": (src + "drdb.cu",
                        "segmif_tpu/kernels/pallas_drdb.py:211"),
        "drdb_tail": (src + "drdb.cu",
                      "segmif_tpu/kernels/pallas_drdb_tail.py:66"),
        "drdb_int8_growth": (src + "drdb_int8.cu",
                             "segmif_tpu/kernels/pallas_drdb_int8.py:160"),
        "drdb_int8_tail": (src + "drdb_int8.cu",
                           "segmif_tpu/kernels/pallas_drdb_int8.py:160"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        check(totals[name] > 0, f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": totals[name],
                        **{k: kres[name][k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "f32_ms",
                            "f32_bound_ms", "f32_library_ms")
                           if k in kres[name]}})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", flush=True)
        sys.exit(1)
