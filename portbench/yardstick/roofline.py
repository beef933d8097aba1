"""The roofline arithmetic of the port's kernels, a frozen copy of
``chip_smoke.py``'s phase-4 yardstick (``PEAK_OPS``, ``HBM_BYTES_S``,
``bound``, ``grams_ops``, ``nbytes`` and the operation and byte counts of
each kernel's rows), extended to read the shapes that the profiler records
for each ``segmif::`` operator call.

A kernel's bound is the least time the card could take: the larger of its
operations over the peak rate for their type (bf16 989 TFLOP/s, int8 1,979
TOP/s, f32 67 TFLOP/s on the CUDA cores; f32 on the tensor cores as
3xTF32, three products at 494.7 TFLOP/s) and its bytes (each input read
once, each output written once) over 3.35 TB/s. Published peaks of one
NVIDIA H100 SXM at 700 W, dense.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 494.7e12}
HBM_BYTES_S = 3.35e12
BF16_PEAK_FLOPS = PEAK_OPS["bf16"]

C = 64      # fusion trunk channels
G = 32      # DRDB growth per conv
DRDB_IN = (64, 96, 128, 160, 192)   # the five growth convs' input channels

ELEMENT_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "f64": 8, "int8": 1,
                 "int32": 4, "int64": 8}


def bound(ops: float, kind: str, moved: float) -> Dict:
    """{"bound_ms", "bound_by"}: the larger of the operations over the
    peak rate for ``kind`` ("tf32x3": three TF32 products each) and the
    bytes ``moved`` over the memory rate."""
    t_ops = (3 * ops / PEAK_OPS["tf32"] if kind == "tf32x3"
             else ops / PEAK_OPS[kind]) * 1e3
    t_bytes = moved / HBM_BYTES_S * 1e3
    return ({"bound_ms": t_ops, "bound_by": "operations"} if t_ops >= t_bytes
            else {"bound_ms": t_bytes, "bound_by": "bytes"})


def grams_ops(b: int, n: int, c: int) -> int:
    """FFM pass A's operations over b images of n tokens: three C-wide
    projections (2 C^2 a token each) and three symmetric grams (their
    C (C + 1) / 2 upper entries, 2 a token each)."""
    return 3 * b * n * (2 * c * c + c * (c + 1))


def numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def nbytes(shapes: Sequence[Sequence[int]], esize: int) -> int:
    return sum(numel(s) for s in shapes) * esize


def _kind(dtype: str) -> str:
    """The bound's rate for a kernel on ``dtype`` activations: bf16 on the
    tensor cores; f32 as 3xTF32."""
    return "bf16" if dtype == "bf16" else "tf32x3"


def sr_attention_cost(q: Sequence[int], k: Sequence[int], dtype: str):
    """(ops, bytes, kind) of one sr-attention call: q [B, N, H, D], k and v
    [B, M, H, D]; the output is q's shape. Two products of 2 B N M H D."""
    b, n, h, d = q
    m = k[1]
    ops = 4 * b * n * m * h * d
    moved = nbytes((q, k, k, q), ELEMENT_BYTES[dtype])
    return ops, moved, _kind(dtype)


def ffm_grams_cost(x: Sequence[int], dtype: str):
    """Pass A: x1, x2, s [B, N, C]; f32 weights w [3, C, C], b [3, C]; f32
    grams [B, 3, C, C] out."""
    b, n, c = x
    moved = (nbytes((x, x, x), ELEMENT_BYTES[dtype])
             + nbytes(((3, c, 2 * c), (3, 2 * c), (b, 3, c, c)), 4))
    return grams_ops(b, n, c), moved, _kind(dtype)


def ffm_apply_cost(x: Sequence[int], dtype: str):
    """Pass B: x1, x2, s in and o1, o2 out [B, N, C]; three 64-wide
    projections and four [C, C] context products a token."""
    b, n, c = x
    e = ELEMENT_BYTES[dtype]
    moved = (nbytes((x,) * 5, e) + nbytes(((3, c, 2 * c), (3, 2 * c),
                                           (b, 4, c, c), (2, c), (2, 2, c)),
                                          4))
    return 7 * 2 * b * n * c * c, moved, _kind(dtype)


def drdb_growth_cost(x: Sequence[int], dtype: str):
    """The five growth convs: x [B, 64, H, W] in, r1..r5 [B, 32, H, W] out,
    the OIHW weights and biases read once."""
    b, _, h, w = x
    npix = b * h * w
    ops = 2 * npix * 9 * G * sum(DRDB_IN)
    e = ELEMENT_BYTES[dtype]
    weights = sum(G * cin * 9 + G for cin in DRDB_IN)
    moved = (numel(x) + 5 * npix * G + weights) * e
    return ops, moved, _kind(dtype)


def drdb_tail_cost(x: Sequence[int], dtype: str):
    """The 1x1 bottleneck over [x, r1..r5] (224 -> 64), bias, relu and the
    residual: x and r1..r5 in, the weights, the output."""
    b, _, h, w = x
    npix = b * h * w
    e = ELEMENT_BYTES[dtype]
    moved = (2 * numel(x) + 5 * npix * G + C * (C + 5 * G) + C) * e
    return 2 * npix * (C + 5 * G) * C, moved, _kind(dtype)


COSTS = {
    "segmif::sr_attention": lambda sh, dt: sr_attention_cost(sh[0], sh[1],
                                                             dt),
    "segmif::ffm_grams": lambda sh, dt: ffm_grams_cost(sh[0], dt),
    "segmif::ffm_apply": lambda sh, dt: ffm_apply_cost(sh[0], dt),
    "segmif::drdb_growth": lambda sh, dt: drdb_growth_cost(sh[0], dt),
    "segmif::drdb_tail": lambda sh, dt: drdb_tail_cost(sh[0], dt),
}


def dtype_name(recorded: str) -> Optional[str]:
    """The profiler's dtype string of a tensor argument ("c10::BFloat16",
    "float", ...) as the yardstick names it."""
    r = recorded.lower()
    if "bfloat16" in r:
        return "bf16"
    if r in ("float", "float32"):
        return "f32"
    if r in ("half", "c10::half", "float16"):
        return "f16"
    return None


def op_bound_ms(op: str, shapes: Sequence[Sequence[int]],
                dtypes: Sequence[str]) -> Optional[Tuple[float, str]]:
    """(bound ms, bound by) of one recorded ``segmif::`` call from its
    input shapes and dtypes; None for an operator the yardstick does not
    count (the int8 DRDB's) or a call whose shapes were not recorded."""
    cost = COSTS.get(op)
    if cost is None or not shapes or not shapes[0]:
        return None
    dt = dtype_name(dtypes[0]) if dtypes else None
    if dt is None:
        return None
    ops, moved, kind = cost(shapes, dt)
    b = bound(ops, kind, moved)
    return b["bound_ms"], b["bound_by"]
