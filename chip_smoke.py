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
    shapes (mit_b3, 480x640, batch 8) in f32 and bf16, and time both;
 5. serve a few batch-8 bf16 480x640 requests through
    ``segmif_tpu_torch.serving.make_serving_fn`` with a seeded random
    mit_b3 ``JointPipeline``, in default mode (guide = VIS, re-encoded per
    pair) and static-guide mode; check the outputs and that every request
    launched the kernels (sr-attention 35 / 28 times, FFM grams and apply
    twice each);
 6. hold the batch-1 f32 pipeline on the card (kernels) against the same
    weights on the CPU (plain versions);
 7. print pairs/s for both serving modes, timed with CUDA events.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W = 480, 640
BATCH = 8
REQUESTS = 3
SEED = 0

# Tolerances, kernel vs plain on the same card (both compute in f32; TF32
# off). f32: reduction order only. bf16: both sides round the same f32
# value, which may differ in its last bits, to bf16.
SR_TOL = {  # absolute; attention outputs are below 4 in magnitude
    "float32": (1e-5, "f32 sums of 64 and 300 terms in another order"),
    "bfloat16": (1.6e-2, "one bf16 step (2^-6) at magnitudes up to 4"),
}
GRAM_RTOL = {  # relative to the largest gram entry
    "float32": (1e-4, "non-negative summands over 307,200 tokens in "
                      "another order"),
    "bfloat16": (1e-3, "as f32, plus rare one-step flips where the bf16 "
                       "rounding of an activation meets a boundary"),
}
APPLY_TOL = {  # absolute; LayerNorm outputs are below 8 in magnitude
    "float32": (1e-4, "f32 sums in another order, scaled by the "
                      "LayerNorm's 1/std"),
    "bfloat16": (6.25e-2, "two bf16 steps (2^-5) at magnitudes up to 8"),
}
# batch-1 f32 pipeline, card vs CPU, relative to the reference's largest
# magnitude: f32 sums in other orders through ~50 layers on two devices
PIPE_RTOL = {"fused_y": 1e-4, "logits": 1e-3}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def time_pair(kernel, plain, iters: int = 10):
    """(kernel ms, plain ms) per call, CUDA events, in the order plain,
    kernel, kernel, plain after one warm-up call of each."""
    import torch

    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    kernel()
    plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def kernel_checks(dev):
    """Phase 4. Returns {kernel: {max_abs_err, ms, plain_ms}}."""
    import torch

    from segmif_tpu_torch.kernels.attention import (sr_attention,
                                                    sr_attention_ref)
    from segmif_tpu_torch.kernels.ffm import (crosspath_apply_rows,
                                              crosspath_apply_rows_ref,
                                              crosspath_grams,
                                              crosspath_grams_ref)

    gen = torch.Generator().manual_seed(SEED)

    def randn(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev, dtype)

    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
           for k in ("sr_attention", "ffm_grams", "ffm_apply")}
    # sr-attention at the four mit_b3 stage shapes: (N, heads), M=300, D=64
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        tol, why = SR_TOL[dname]
        for n, h in ((19200, 1), (4800, 2), (1200, 5), (300, 8)):
            d, m = 64, 300
            q = randn((BATCH, n, h, d), dtype)
            kv = randn((BATCH, m, 2 * h * d), dtype)
            k = kv[..., :h * d].unflatten(-1, (h, d))
            v = kv[..., h * d:].unflatten(-1, (h, d))
            got = sr_attention(q, k, v, d ** -0.5)
            want = sr_attention_ref(q, k, v, d ** -0.5)
            err = max_err(got, want)
            ms, pms = time_pair(lambda: sr_attention(q, k, v, d ** -0.5),
                                lambda: sr_attention_ref(q, k, v, d ** -0.5))
            print(f"sr_attention {dname} B={BATCH} N={n} M={m} H={h} D={d}: "
                  f"max_abs_err {err:.3e} (tol {tol:g}: {why}); "
                  f"kernel {ms:.4f} ms, plain {pms:.4f} ms", flush=True)
            check(err <= tol, f"sr_attention {dname} N={n} error {err}")
            r = res["sr_attention"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if dtype == torch.bfloat16:
                r["ms"] += ms
                r["plain_ms"] += pms
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
        res["ffm_grams"]["max_abs_err"] = max(res["ffm_grams"]["max_abs_err"],
                                              err)
        if dtype == torch.bfloat16:
            res["ffm_grams"].update(ms=ms, plain_ms=pms)

        args = (x1, x2, s, wp, bp, mats, be, lnp)
        o1, o2 = crosspath_apply_rows(*args)
        r1, r2 = crosspath_apply_rows_ref(*args)
        err = max(max_err(o1, r1), max_err(o2, r2))
        tol, why = APPLY_TOL[dname]
        ms, pms = time_pair(lambda: crosspath_apply_rows(*args),
                            lambda: crosspath_apply_rows_ref(*args))
        print(f"ffm_apply {dname} B={BATCH} N={n} C={c}: max_abs_err "
              f"{err:.3e} (tol {tol:g}: {why}); kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms", flush=True)
        check(err <= tol, f"ffm_apply {dname} error {err}")
        res["ffm_apply"]["max_abs_err"] = max(res["ffm_apply"]["max_abs_err"],
                                              err)
        if dtype == torch.bfloat16:
            res["ffm_apply"].update(ms=ms, plain_ms=pms)
        del x1, x2, s, got, want, o1, o2, r1, r2, args
        torch.cuda.empty_cache()
    return res


def requests(gen, n_req, batch, dev):
    import torch

    out = []
    for _ in range(n_req):
        ir = torch.rand((batch, H, W, 1), generator=gen)
        vis = torch.rand((batch, H, W, 3), generator=gen)
        out.append((ir.to(dev), vis.to(dev)))
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
    from segmif_tpu_torch.kernels.ffm import (crosspath_apply_rows,
                                              crosspath_grams)
    from segmif_tpu_torch.models.network import JointPipeline, init_params
    from segmif_tpu_torch.serving import make_serving_fn

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

    # phase 5: the main path, bf16 batch 8, both serving modes
    model.to(torch.bfloat16)
    reqs = requests(gen, REQUESTS, BATCH, dev)
    guide = torch.rand((BATCH, H, W, 3), generator=gen).to(dev)
    counters = {"sr_attention": sr_attention,
                "ffm_grams": crosspath_grams,
                "ffm_apply": crosspath_apply_rows}
    expect = {"default": {"sr_attention": 35, "ffm_grams": 2,
                          "ffm_apply": 2},
              "static_guide": {"sr_attention": 28, "ffm_grams": 2,
                               "ffm_apply": 2}}
    serves = {"default": make_serving_fn(model),
              "static_guide": make_serving_fn(model, guide_rgb=guide)}
    totals = {k: 0 for k in counters}
    for mode, serve in serves.items():
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
        print(f"serving {mode}: {REQUESTS} requests of {BATCH} pairs, "
              f"launches per request {counts}; outputs finite, fused_rgb "
              f"in [0,1], pred in [0,9)", flush=True)

    # phase 7: pairs/s, CUDA events, after warm-up
    for mode, serve in serves.items():
        serve(*reqs[0])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        iters = 2 * REQUESTS
        start.record()
        for i in range(iters):
            serve(*reqs[i % REQUESTS])
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 1e3
        print(f"throughput {mode}: {BATCH * iters / sec:.3f} pairs/s "
              f"({1e3 * sec / iters:.2f} ms per batch of {BATCH}, bf16, "
              f"{H}x{W}, mit_b3)", flush=True)
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)

    src = "segmif_tpu_torch/kernels/csrc/"
    meta = {
        "sr_attention": (src + "sr_attention.cu",
                         "segmif_tpu/kernels/pallas_attention.py:59"),
        "ffm_grams": (src + "ffm.cu", "segmif_tpu/kernels/pallas_ffm.py:231"),
        "ffm_apply": (src + "ffm.cu", "segmif_tpu/kernels/pallas_ffm.py:304"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        check(totals[name] > 0, f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": totals[name],
                        "max_abs_err": kres[name]["max_abs_err"],
                        "ms": kres[name]["ms"],
                        "plain_ms": kres[name]["plain_ms"]})
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
