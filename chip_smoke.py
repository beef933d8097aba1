#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the last
line):
 1. refuse to run without a CUDA device;
 2. print the card's name and power limit (nvidia-smi);
 3. build the hand-written kernels from segmif_tpu_torch/kernels/csrc
    (nvcc, sm_90a) and print the build time;
 4. hold each kernel against its plain PyTorch version at the main-path
    shapes (mit_b3, 480x640, batch 8) in f32 and bf16, and time both on
    the device (held by a sleep kernel while the host enqueues the timed
    calls), with each kernel's bound (the larger of its operations over the
    card's peak for their type and its bytes over the memory rate) and,
    for sr-attention, the time of ``F.scaled_dot_product_attention`` on
    the same inputs laid out [B, H, N, D]; sr-attention and FFM apply
    held per element, with planted faults (scale x 1.01, the last key
    row dropped; be zeroed, M1 and M3 swapped, LayerNorm gamma + 0.01)
    that must fail those checks, and f32 and bf16 sr-attention at the
    1080p stage-1 shape (M = 1980) beside SDPA; FFM grams also at B = 8 with
    N = 1 and 40, with planted faults (y1's bias zeroed, y1 and y2
    swapped); the DRDB growth chain, tail and whole block (against
    ``drdb_chain``), held per element, also at an odd 100x172, with the
    block's peak device memory, the growth's five-launch traffic floor
    and cuDNN's five convs on prebuilt concatenations beside it, bf16
    growth and tail at 17x33, 5x7 and on a channel slice of x; the int8 DRDB
    kernels held bit for bit against ``drdb_int8_ref`` (the int8 buffer
    and the output) at the main-path shape, 100x172 and 5x7, with the
    int8 block's peak memory; at 100x172, faults planted in the DRDB
    kernels' arguments (dropped biases, swapped conv taps, a zeroed weight
    chunk, two growth slices swapped at the tail, a wrong requant scale)
    must fail those checks;
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
    their plain versions in the backward): (a) one round >= 2 step of a
    mit_b3 model (weights at the reference modules' scale) in f32 on the
    card against the same step on the CPU, batch 2 at 240x320, every
    gradient leaf held to the CPU's, and a DRDB Function that returns a
    zero bottleneck-bias gradient must fail that check; (b) the slice at
    full width, batch 8 at 480x640, bf16 compute with f32 master weights,
    AdamW (poly schedule): 6 round >= 2 steps on one batch, then a round-1
    step, with the kernel launches of every step counted (sr-attention 35
    or 7, FFM 2 + 2, DRDB 4 + 4, int8 0: the backward launches none),
    finite losses and loss_fusion falling from step 1 to step 5, and no
    synchronizing CUDA call in a step; (c) one bf16 step against one f32
    step on the card, beside an f32 step with the weights rounded to bf16:
    at that shape the loss within a relative limit and every gradient
    leaf's norm within a range of f32's (cosines printed); at 64x96 every
    leaf's cosine and the whole gradient's above a limit, every norm
    within a tighter range (128x160 printed); the (a) fault must fail both;
    (d) ms per step and pairs/s (CUDA events, three steps after two
    warm-up steps, host-paced), the share of a step spent in the
    Functions' recompute backward, peak device memory, each part's
    seconds.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import itertools
import json
import math
import subprocess
import sys
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
    "float32": (1e-4, "non-negative summands over 307,200 tokens in "
                      "another order"),
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
# Peaks of one H100 SXM (NVIDIA's datasheet, dense, 700 W) for the bounds
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


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


def time_pair(kernel, plain, iters: int = 10):
    """(kernel ms, plain ms) per call, CUDA events, in the order plain,
    kernel, kernel, plain after one warm-up call of each."""
    import torch

    kernel()
    plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = (_events_ms(fn, iters)
                      for fn in (plain, kernel, kernel, plain))
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
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = moved / HBM_BYTES_S * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


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

    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": None}
           for k in ("sr_attention", "ffm_grams", "ffm_apply")}
    # sr-attention at the four mit_b3 stage shapes: (N, heads), M=300, D=64
    sdpa = {}
    ops = moved = 0
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
            if dtype == torch.bfloat16 and n == 4800:
                label = f"sr_attention {dname} N={n} H={h}"
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
            del q, k, v, got, want
    res["sr_attention"].update(library_ms=sdpa["bfloat16"],
                               **bound(ops, "bf16", moved))
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
        bnd = bound(4 * b * n * m * h * d,
                    "bf16" if dtype == torch.bfloat16 else "f32",
                    nbytes(q, k, v, got))
        print(f"sr_attention {dname} 1080p stage 1 B={b} N={n} M={m} H={h} "
              f"D={d}: {verdict(ratio, err, diff, tol)}; kernel {ms:.4f} ms,"
              f" plain {pms:.4f} ms, scaled_dot_product_attention {lib:.4f} "
              f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})",
              flush=True)
        check(ok, f"sr_attention {dname} 1080p error {err}")
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
        want = crosspath_grams_ref(x1, x2, s, wp, bp)
        err = max_err(got, want)
        scale = want.abs().max().item()
        rtol, why = GRAM_RTOL[dname]
        ms, pms = time_pair(lambda: crosspath_grams(x1, x2, s, wp, bp),
                            lambda: crosspath_grams_ref(x1, x2, s, wp, bp))
        print(f"ffm_grams {dname} B={BATCH} N={n} C={c}: max_abs_err "
              f"{err:.3e} of max |gram| {scale:.3e} (rtol {rtol:g}: {why}); "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
        check(err <= rtol * scale, f"ffm_grams {dname} error {err}")
        check(torch.equal(got, crosspath_grams(x1, x2, s, wp, bp)),
              "ffm_grams is not deterministic")
        if dtype == torch.bfloat16:
            for name, bad in (
                    ("y1 bias zeroed", (wp, torch.cat([bp[:1] * 0, bp[1:]]))),
                    ("y1 and y2 weights swapped", (wp[[1, 0, 2]], bp))):
                e = max_err(crosspath_grams(x1, x2, s, *bad), want)
                print(f"planted fault, ffm_grams {dname} N={n}, {name}: "
                      f"max_abs_err {e:.3e}, error/limit "
                      f"{e / (rtol * scale):.3f} (the check fails, as it "
                      f"must)", flush=True)
                check(e > rtol * scale, f"the ffm_grams check passes a "
                                        f"kernel run with the {name}")
        res["ffm_grams"]["max_abs_err"] = max(res["ffm_grams"]["max_abs_err"],
                                              err)
        if dtype == torch.bfloat16:
            # three 64-wide relu projections and three 64x64 grams
            res["ffm_grams"].update(
                ms=ms, plain_ms=pms,
                **bound(3 * 4 * BATCH * n * c * c, "bf16",
                        nbytes(x1, x2, s, wp, bp, got)))

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
        if dtype == torch.bfloat16:
            lnp_bad = lnp + torch.tensor([0.01, 0.0], device=dev)[:, None]
            for name, bad in (
                    ("be zeroed", (mats, be * 0, lnp)),
                    ("M1 and M3 swapped", (mats[:, [0, 3, 2, 1]], be, lnp)),
                    ("LayerNorm gamma + 0.01", (mats, be, lnp_bad))):
                fault_fails(label, name,
                            crosspath_apply_rows(x1, x2, s, wp, bp, *bad),
                            want, tol)
        res["ffm_apply"]["max_abs_err"] = max(res["ffm_apply"]["max_abs_err"],
                                              err)
        if dtype == torch.bfloat16:
            # three 64-wide projections and four [64, 64] context products
            res["ffm_apply"].update(
                ms=ms, plain_ms=pms,
                **bound(7 * 2 * BATCH * n * c * c, "bf16",
                        nbytes(*args, *got)))
        del x1, x2, s, got, want, args
        torch.cuda.empty_cache()
    # bf16 grams with fewer tokens than one 16-token tile per warp
    rtol, why = GRAM_RTOL["bfloat16"]
    for n in (1, 40):
        xs = [randn((BATCH, n, c), torch.bfloat16) for _ in range(3)]
        got = crosspath_grams(*xs, wp, bp)
        want = crosspath_grams_ref(*xs, wp, bp)
        err, scale = max_err(got, want), want.abs().max().item()
        print(f"ffm_grams bfloat16 B={BATCH} N={n}: max_abs_err {err:.3e} "
              f"of max |gram| {scale:.3e} (rtol {rtol:g})", flush=True)
        check(err <= rtol * scale, f"ffm_grams bfloat16 N={n} error {err}")
        check(torch.equal(got, crosspath_grams(*xs, wp, bp)),
              "ffm_grams is not deterministic")
    return res


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
            growth_bound = bound(2 * npix * 9 * 32 * (64 + 96 + 128 + 160
                                                      + 192), "bf16",
                                 nbytes(x, *rs, *(t for c in dconvs
                                                  for t in c)))
            tail_bound = bound(2 * npix * 224 * 64, "bf16",
                               nbytes(x, *rs, wb, bb, out))
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
                # what five launches must move: each conv reads its input
                # (64 + 32 t channels) and writes its 32, 2 bytes each
                floor = npix * (sum(64 + 32 * t for t in range(5)) + 160) * 2
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
    # bf16 growth and tail off their tiles (16x16; 128 pixels), and with x
    # a channel slice (16-79) of a wider channels_last tensor (pixel
    # stride 96)
    for b, h, w, sliced in ((1, 17, 33, False), (2, 5, 7, False),
                            (2, 17, 33, True)):
        x, dconvs, (wb, bb) = drdb_inputs(gen, b, h, w, torch.bfloat16, dev)
        if sliced:
            wide = torch.randn((b, h, w, 96), generator=gen).to(
                dev, torch.bfloat16)
            wide[..., 16:80] = x.permute(0, 2, 3, 1)
            x = wide.permute(0, 3, 1, 2)[:, 16:80]
        shape = (f"bfloat16 [{b}, 64, {h}, {w}]"
                 f"{', x a channel slice' if sliced else ''}")
        rs, err, _, _ = compare(
            f"drdb_growth {shape}", lambda: drdb_growth(x, dconvs),
            lambda: drdb_growth_ref(x, dconvs), GROWTH_TOL["bfloat16"], False)
        res["drdb_growth"]["max_abs_err"] = max(
            res["drdb_growth"]["max_abs_err"], err)
        _, err, _, _ = compare(
            f"drdb_tail {shape}", lambda: drdb_tail(x, rs, wb, bb),
            lambda: drdb_tail_ref(x, rs, wb, bb), TAIL_TOL["bfloat16"], False,
            x)
        res["drdb_tail"]["max_abs_err"] = max(res["drdb_tail"]["max_abs_err"],
                                              err)
    return res


def cudnn_growth_ms(x, rs, dconvs) -> float:
    """The growth's library yardstick: cuDNN's five dilated convs, bf16 and
    channels_last, on concatenated inputs built beforehand (so without the
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


def train_checks(dev, counters):
    """Phase 8: fusion-phase training; see the module docstring."""
    import warnings

    import torch

    from segmif_tpu_torch import drift
    from segmif_tpu_torch.kernels import _build
    from segmif_tpu_torch.models.network import JointPipeline
    from segmif_tpu_torch.train.compare import (bf16_rounded, leaf_cosines,
                                                leaf_errors, step_grads)
    from segmif_tpu_torch.train.optimizer import adamw_poly
    from segmif_tpu_torch.train.state import FusionTrainState
    from segmif_tpu_torch.train.steps import make_fusion_train_step

    f32, bf16 = torch.float32, torch.bfloat16
    model = drift.init_reference_scale(JointPipeline("mit_b3"),
                                       torch.Generator().manual_seed(SEED + 6))
    gen = torch.Generator().manual_seed(SEED + 7)

    # (a) card f32 against CPU f32
    t0 = time.perf_counter()
    small = train_batch(gen, 2, *TRAIN_HW, "cpu")
    want_m, want = step_grads(model, small, False, f32, "cpu",
                              TRAIN_FUSION_SCALE)
    cpu_s = time.perf_counter() - t0
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

    def counted(fn, which):
        for c in counters.values():
            c.launches = 0
        metrics = fn(state, full, TRAIN_FUSION_SCALE)
        counts = {k: c.launches for k, c in counters.items()}
        check(counts == expect[which], f"train step launches {counts}, "
                                       f"expected {expect[which]}")
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
    # step 6: the Functions' recompute backward timed inside the step
    real, spans = _build.plain_vjp, []

    def timed_vjp(*a, **k):
        s_, e_ = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s_.record()
        out = real(*a, **k)
        e_.record()
        spans.append((s_, e_))
        return out

    _build.plain_vjp = timed_vjp
    try:
        ev[2].record()
        losses.append(counted(step, "r2"))
        ev[3].record()
        torch.cuda.synchronize()
    finally:
        _build.plain_vjp = real
    syncs = [w for w in syncs if "called a synchronizing" in str(w.message)]
    recompute_ms = sum(a.elapsed_time(b) for a, b in spans)
    inst_ms = ev[2].elapsed_time(ev[3])
    fus = [mt["loss_fusion"].item() for mt in losses]
    tot = [mt["loss"].item() for mt in losses]
    print(f"train (b) mit_b3 batch {BATCH} {H}x{W}, bf16 compute, f32 "
          f"master weights, AdamW lr {TRAIN_LR:g}: 6 round >= 2 steps, "
          f"loss {' '.join(f'{v:.5f}' for v in tot)}, loss_fusion "
          f"{' '.join(f'{v:.5f}' for v in fus)}; launches per step "
          f"{expect['r2']} (the backward launches none)", flush=True)
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
          f"6 {inst_ms:.2f} ms of which the Functions' recompute backward "
          f"{recompute_ms:.2f} ms ({recompute_ms / inst_ms:.3f} of the step, "
          f"{len(spans)} recomputes); synchronizing CUDA calls in step 2 "
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


def main() -> int:
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
    from segmif_tpu_torch.models.network import JointPipeline, init_params
    from segmif_tpu_torch.serving import make_serving_fn, quantize_for_serving

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
    print(smi.stdout.strip(), flush=True)

    # phase 3: build
    _build.library()
    srcs = ", ".join(str(p.relative_to(ROOT)) for p in _build.sources())
    print(f"build: {_build.build_seconds:.1f} s, nvcc "
          f"{' '.join(_build.ARCH_FLAGS)}, from {srcs}", flush=True)

    # phase 4: kernels vs plain at main-path shapes
    kres = kernel_checks(dev)
    with torch.inference_mode():
        kres.update(drdb_checks(dev))
        kres.update(drdb_int8_checks(dev))

    # phase 6 first half: the CPU reference at batch 1, f32 (same weights)
    model = init_params(JointPipeline("mit_b3"),
                        torch.Generator().manual_seed(SEED)).eval()
    gen = torch.Generator().manual_seed(SEED + 1)
    ir1, vis1 = requests(gen, 1, 1, "cpu")[0]
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, y_cpu, logits_cpu = model(ir1, vis1)
    cpu_s = time.perf_counter() - t0
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
    print(f"cpu reference forward: {cpu_s:.1f} s", flush=True)

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

    # phase 5: the main path, bf16 batch 8, both serving modes
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
    expect = {}
    for mode, sr in (("default", 35), ("static_guide", 28)):
        float_drdb = {"drdb_growth": 4, "drdb_tail": 4,
                      "drdb_int8_growth": 0, "drdb_int8_tail": 0}
        expect[mode] = {"sr_attention": sr, "ffm_grams": 2, "ffm_apply": 2,
                        **float_drdb}
        expect["int8_" + mode] = {**expect[mode], **{
            k: 4 - v for k, v in float_drdb.items()}}
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

    # phase 7: pairs/s, CUDA events, after warm-up; no hold: the host's
    # pace is part of what a request costs
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

    # phase 8: fusion-phase training
    train_checks(dev, counters)

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
                            "bound_by", "library_ms")}})
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
