"""Where the card's time goes on the serving path: a device profile per
request by kernel class, and CUDA-event times per layer.

    python -m segmif_tpu_torch.profile_serving [--batch 8] [--requests 3]

Serves ``--requests`` batches of random IR/VIS pairs (mit_b3, 480x640,
bf16, seeded random weights) through ``make_serving_fn`` in default mode and in
static-guide mode, each with bf16 DRDBs and with calibrated int8 DRDBs
(``quantize_for_serving`` on one batch), under ``torch.profiler``, and
prints for each mode the device time per request by kernel class, the
device's busy time against the wall time (CUDA events) and the idle
share, and the top kernels. Then it times the layers with CUDA events: the
guide taps (MiT stages 1-2), the fusion net (bf16 and int8 DRDBs), one
DRDB (bf16 and int8) and the seg pass. Needs a CUDA card; the first line
is the card's name and power limit as nvidia-smi reads them.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from collections import defaultdict

import torch

from .models.network import JointPipeline, init_params
from .serving import make_serving_fn, quantize_for_serving

# kernel class: substrings of the kernel's name, first match wins
CLASSES = (
    ("DRDB int8 kernels", ("int8_entry_kernel", "int8_conv_kernel",
                           "int8_tail_kernel")),
    ("sr-attention kernel", ("sr_attention_kernel",)),
    ("FFM kernels", ("ffm_",)),
    ("DRDB growth kernel", ("growth_",)),  # growth_kernel<...>
    ("DRDB tail kernel", ("tail_kernel",)),
    ("LayerNorm", ("layer_norm",)),
    ("bilinear resize", ("upsample_bilinear",)),
    ("concat", ("CatArrayBatchedCopy",)),
    ("reduce", ("reduce_kernel",)),
    ("cuDNN convs", ("fprop", "conv2d", "cudnn", "implicit_gemm")),
    ("elementwise", ("elementwise_kernel",)),
)


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def time_ms(fn, iters: int) -> float:
    """Mean ms per call, CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_mode(serve, reqs) -> None:
    from torch.profiler import ProfilerActivity, profile

    serve(*reqs[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        start.record()
        for ir, vis in reqs:
            serve(ir, vis)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / len(reqs)
    by_class, by_name, spans = defaultdict(float), defaultdict(float), []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_class[kernel_class(e.name)] += (t1 - t0) / 1e3 / len(reqs)
        by_name[e.name] += (t1 - t0) / 1e3 / len(reqs)
    busy = busy_us(spans) / 1e3 / len(reqs)
    print(f"  device busy {busy:.2f} / wall {wall:.2f} ms per request, "
          f"idle share {1 - busy / wall:.3f}")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:<24} {ms:8.2f}")
    print("  top kernels:")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
        print(f"  {ms:8.2f}  {name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    h, w, b = 480, 640, args.batch
    model = init_params(JointPipeline("mit_b3"),
                        torch.Generator().manual_seed(0))
    model = model.eval().to(dev, torch.bfloat16,
                            memory_format=torch.channels_last)
    gen = torch.Generator().manual_seed(1)

    def rand(c):
        return torch.rand((b, h, w, c), generator=gen).to(dev)

    reqs = [(rand(1), rand(3)) for _ in range(args.requests)]
    guide = rand(3)
    cal = (rand(1), rand(3))
    qmodel = quantize_for_serving(model, cal)
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"{smi.stdout.strip()}; mit_b3, {h}x{w}, batch {b}, "
          f"bf16, {args.requests} requests per mode")
    for mode, serve in (("default", make_serving_fn(model)),
                        ("static_guide",
                         make_serving_fn(model, guide_rgb=guide)),
                        ("int8_default", make_serving_fn(qmodel)),
                        ("int8_static_guide",
                         make_serving_fn(model, guide_rgb=guide,
                                         int8_calibration=cal))):
        print(f"== {mode}: ms per request by kernel class")
        profile_mode(serve, reqs)

    ir, vis = reqs[0]
    iters = 2 * args.requests
    with torch.inference_mode():
        taps = model.guide_taps_raw(vis)
        fused_rgb, _ = model.fuse(ir, vis, taps=taps)
        x = torch.rand((b, 64, h, w), generator=gen).to(
            dev, torch.bfloat16, memory_format=torch.channels_last)
        vis_r = vis[..., 0:1]
        layers = (
            ("guide taps", lambda: model.guide_taps_raw(vis)),
            ("fusion net", lambda: model.fusion(ir, vis_r, *taps)),
            ("fusion net int8", lambda: qmodel.fusion(ir, vis_r, *taps)),
            ("one DRDB", lambda: model.fusion.DRDB1(x)),
            ("one DRDB int8", lambda: qmodel.fusion.DRDB1(x)),
            ("seg pass", lambda: model.seg(fused_rgb)),
        )
        times = [f"{name} {time_ms(fn, iters):.2f} ms"
                 for name, fn in layers]
    print("per layer (CUDA events): " + ", ".join(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
