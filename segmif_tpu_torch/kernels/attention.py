"""Attention compute for the port (counterpart of
``segmif_tpu/kernels/attention.py``).

 - ``sr_attention``: MiT spatially-reduced softmax attention, through
   the operator ``segmif::sr_attention``. On a CUDA tensor it launches
   the hand-written kernel ``csrc/sr_attention.cu`` (replacing the TPU
   kernel ``pallas_attention._sr_attention_fwd_impl``); on a CPU tensor
   it runs the plain version ``sr_attention_ref``. Under
   autograd the kernel sits in an ``autograd.Function``.
 - The backward (``sr_attention_backward``): bf16 CUDA inputs that the
   forward kernel takes run two more operators (``csrc/sr_attention_bwd.cu``),
   ``segmif::sr_attention_bwd_dq`` (dq, and each query's log-sum-exp and
   D = rowsum(P o dP)) and ``segmif::sr_attention_bwd_dkv`` (dk and dv);
   their CPU versions are the plain passes ``_bwd_dq_plain`` and
   ``_bwd_dkv_plain``. Every other input (f32, f64, CPU) recomputes the
   VJP of ``sr_attention_ref`` with respect to q, k and v in plain
   PyTorch (the JAX ``custom_vjp`` of ``pallas_attention.py``: ``_bwd``
   recomputes through XLA; it has no backward kernel).
 - ``linear_ctx_blockdiag_from_gram``: the block-diagonal per-head
   softmax context of the folded CrossPath, from a [C, C] gram. Tiny
   matrices, plain torch on every device.
 - ``linear_cross_attention`` / ``linear_ctx_blockdiag``: the modular
   CrossPath's head-folded linear cross-attention over [B, N, C] tokens
   (``linear_cross_attention_flat`` of the JAX package, which computes it
   in XLA: no TPU kernel, and plain torch here on every device).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _build
from ..utils.profiler import span

LOG2E = math.log2(math.e)
_TILE = 64   # queries or keys per tile of the backward kernels


def sr_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Plain softmax attention. q: [B, N, H, D]; k, v: [B, M, H, D] ->
    [B, N, H, D] in q's dtype. Logits, softmax and the probability-value
    product run in f32, as the TPU kernel computes them."""
    acc = _build.acc_dtype(q.dtype)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", probs, vf).to(q.dtype)


class _SrAttentionFn(torch.autograd.Function):
    """The kernel's forward. The backward: the two backward operators
    (``sr_attention_backward``) where ``bwd_takes_kernels`` (bf16 on the
    card), else the VJP of ``sr_attention_ref`` recomputed under autograd;
    both under the span ``bwd/sr_attention``. ``plain_backwards`` counts
    the plain VJPs run on CUDA tensors."""

    plain_backwards = 0

    @staticmethod
    def forward(ctx, scale, forward, q, k, v):
        ctx.scale = scale
        ctx.kernels = forward is None and bwd_takes_kernels(q, k, v)
        ctx.save_for_backward(q, k, v)
        return (forward or _sr_attention_kernel)(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[2:]
        if ctx.kernels:
            with span("bwd/sr_attention"):
                return (None, None) + sr_attention_backward(
                    *ctx.saved_tensors, g, needs, ctx.scale)
        if ctx.saved_tensors[0].is_cuda:
            _SrAttentionFn.plain_backwards += 1
        return (None, None) + _build.plain_vjp(
            "bwd/sr_attention",
            lambda q, k, v: sr_attention_ref(q, k, v, ctx.scale),
            ctx.saved_tensors, needs, (g,))


def _sr_attention_grad(q, k, v, scale: float, forward=None) -> torch.Tensor:
    """sr-attention that carries a gradient. ``forward`` stands in for the
    kernel (a test passes the plain version to gradcheck the Function on
    the CPU); nothing on the main path sets it."""
    return _SrAttentionFn.apply(scale, forward, q, k, v)


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """q: [B, N, H, D]; k, v: [B, M, H, D] -> [B, N, H, D].

    The operator ``segmif::sr_attention`` (``sr_attention_op``): CUDA
    tensors launch the kernel, which reads q/k/v through their strides
    (the last dim contiguous) and raises on a shape or dtype it does not
    take; CPU tensors take ``sr_attention_ref``, and so does a CPU call
    that needs a gradient, through autograd. Both stream K/V through
    shared memory, so any M is taken, on the tensor cores: bf16 as it is,
    f32 as 3xTF32 (f32-accurate products); rows must start on 16 bytes.
    When a gradient is needed on the card the kernel runs inside
    ``_SrAttentionFn``."""
    if _build.needs_grad(q, k, v):
        if q.device.type == "cpu":
            return sr_attention_ref(q, k, v, scale)
        return _sr_attention_grad(q, k, v, scale)
    return _sr_attention_kernel(q, k, v, scale)


def _sr_attention_kernel(q, k, v, scale: float) -> torch.Tensor:
    """The operator, after the kernel's argument checks on a CUDA tensor
    (forward only)."""
    if q.is_cuda:
        _check_sr(q, k, v)
    return torch.ops.segmif.sr_attention(q, k, v, float(scale))


def _check_sr(q, k, v) -> None:
    refusal = _sr_refusal(q, k, v)
    if refusal is not None:
        raise ValueError(refusal)


def _sr_refusal(q, k, v):
    """Why the kernel does not take q, k, v (the message it raises), or
    None."""
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != k.shape:
        return (f"sr_attention: shapes q {tuple(q.shape)} "
                f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in _build.DTYPE_CODES:
        return (f"sr_attention: dtypes {q.dtype} {k.dtype} "
                f"{v.dtype}; the kernel takes f32 or bf16")
    if not (q.device == k.device == v.device):
        return "sr_attention: q, k, v on different devices"
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        return "sr_attention: the head dim must be contiguous"
    if d not in (32, 64):
        return f"sr_attention: head dim {d} (the kernel takes 32 or 64)"
    per_row = 16 // q.element_size()
    if any(any(st % per_row for st, sz in zip(t.stride()[:3], t.shape[:3])
               if sz > 1) for t in (q, k, v)):
        return _ROWS
    return None


_ROWS = ("sr_attention: rows must start on 16 bytes (pointers and "
         "strides): the kernel copies them 16 bytes at a time")


@torch.library.custom_op("segmif::sr_attention", mutates_args=(),
                         device_types="cuda")
def sr_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """One launch of ``segmif_sr_attention`` on the current stream; the
    output is allocated here."""
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(_ROWS)
    b, n, h, d = q.shape
    m = k.shape[1]
    lib = _build.library()
    with torch.cuda.device(q.device):
        out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.segmif_sr_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, m, h, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), _build.DTYPE_CODES[q.dtype], stream)
    _build.check(err, "sr_attention")
    sr_attention.launches += 1
    return out


@sr_attention_op.register_kernel("cpu")
def _sr_attention_cpu(q, k, v, scale):
    return sr_attention_ref(q, k, v, scale).contiguous()


@sr_attention_op.register_fake
def _sr_attention_fake(q, k, v, scale):
    return q.new_empty(q.shape)


sr_attention.launches = 0


# ---------------------------------------------------------------- backward

def bwd_takes_kernels(q, k, v) -> bool:
    """Whether ``_SrAttentionFn``'s backward runs the kernels: bf16 CUDA
    q, k, v that the forward kernel takes (D 32 or 64, rows and pointers on
    16 bytes). Every other input takes the plain VJP."""
    return (q.is_cuda and q.dtype == torch.bfloat16
            and _sr_refusal(q, k, v) is None
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _bwd_dq_plain(q, k, v, g, scale: float):
    """Plain dq pass: (dq in q's dtype, lse2 and D [B, H, N] in the
    arithmetic type). lse2 is each row's log-sum-exp of the scaled logits in
    log2 units (the kernels' P = 2^(x - lse2) with x = S scale log2(e)); D
    = rowsum(P o dP), dP = dO v^T, as the softmax's backward sums it."""
    acc = _build.acc_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    lse = torch.logsumexp(logits, -1)
    p = torch.exp(logits - lse[..., None])
    dp = torch.einsum("bnhd,bmhd->bhnm", gf, vf)
    delta = (p * dp).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    return dq.to(q.dtype).contiguous(), lse * LOG2E, delta


def _bwd_dkv_plain(q, k, v, g, lse2, delta, scale: float):
    """Plain dkv pass from the dq pass's lse2 and D: the sums P^T dO and
    dS^T q over all queries, dk times scale; (dk, dv) in k's dtype,
    contiguous [B, M, H, D]."""
    acc = _build.acc_dtype(q.dtype)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    p = torch.exp(logits - lse2[..., None] / LOG2E)
    dp = torch.einsum("bnhd,bmhd->bhnm", gf, vf)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p, gf)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def _check_bwd(q, k, v, g) -> None:
    _check_sr(q, k, v)
    if q.dtype != torch.bfloat16 or g.dtype != q.dtype or \
            g.shape != q.shape:
        raise ValueError(f"sr_attention backward: q {q.dtype}, dO "
                         f"{g.dtype} {tuple(g.shape)}; the kernels take bf16 "
                         "and dO of q's shape")
    if g.stride(-1) != 1 or any(st % 8 for st, sz in zip(
            g.stride()[:3], g.shape[:3]) if sz > 1):
        raise ValueError(_ROWS)


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


def sr_attention_bwd_dq(q, k, v, g, scale: float):
    """The dq pass of the backward, through the operator
    ``segmif::sr_attention_bwd_dq`` (``sr_attention_bwd_dq_op``): q, k, v as
    the forward takes them, g (dO) [B, N, H, D] -> (dq [B, N, H, D] in q's
    dtype, lse2 and D [B, H, N] in the arithmetic type). CPU tensors take
    ``_bwd_dq_plain``; CUDA tensors (bf16) launch
    ``segmif_sr_attention_bwd_dq``."""
    if q.is_cuda:
        _check_bwd(q, k, v, g)
    return torch.ops.segmif.sr_attention_bwd_dq(q, k, v, g, float(scale))


@torch.library.custom_op("segmif::sr_attention_bwd_dq", mutates_args=(),
                         device_types="cuda")
def sr_attention_bwd_dq_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, g: torch.Tensor, scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One launch of ``segmif_sr_attention_bwd_dq`` on the current stream;
    the outputs are allocated here."""
    if any(t.data_ptr() % 16 for t in (q, k, v, g)):
        raise ValueError(_ROWS)
    b, n, h, d = q.shape
    m = k.shape[1]
    dev = q.device
    dq = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    lse2 = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segmif_sr_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), lse2.data_ptr(), delta.data_ptr(), b, n, m, h, d,
            *_strides(q, k, v, g), float(scale), stream)
    _build.check(err, "sr_attention_bwd_dq")
    sr_attention_bwd_dq.launches += 1
    return dq, lse2, delta


@sr_attention_bwd_dq_op.register_kernel("cpu")
def _sr_attention_bwd_dq_cpu(q, k, v, g, scale):
    return _bwd_dq_plain(q, k, v, g, scale)


@sr_attention_bwd_dq_op.register_fake
def _sr_attention_bwd_dq_fake(q, k, v, g, scale):
    b, n, h, _ = q.shape
    acc = _build.acc_dtype(q.dtype)
    return (q.new_empty(q.shape), q.new_empty((b, h, n), dtype=acc),
            q.new_empty((b, h, n), dtype=acc))


sr_attention_bwd_dq.launches = 0


def _dkv_chunk(n: int, m: int, bh: int, device: torch.device) -> int:
    """Queries per block of the dkv pass, a multiple of 64: on the card each
    (batch, head)'s queries split so that the grid ((key tiles, B H,
    chunks), two blocks per SM by registers) is about four blocks per SM;
    on the CPU one chunk."""
    tiles = math.ceil(n / _TILE)
    if device.type != "cuda":
        return tiles * _TILE
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = max(1, min(tiles, math.ceil(4 * sms / (math.ceil(m / _TILE) *
                                                 bh))))
    return math.ceil(tiles / per) * _TILE


def sr_attention_bwd_dkv(q, k, v, g, lse2, delta, scale: float):
    """The dkv pass of the backward, through the operator
    ``segmif::sr_attention_bwd_dkv`` (``sr_attention_bwd_dkv_op``): q, k, v,
    g as ``sr_attention_bwd_dq``'s, and its lse2 and D -> (dk, dv) [B, M,
    H, D] in k's dtype. CPU tensors take ``_bwd_dkv_plain``; CUDA tensors
    launch ``segmif_sr_attention_bwd_dkv`` (the pass, over chunks of
    ``_dkv_chunk`` queries, and the in-order sum of its chunks)."""
    if q.is_cuda:
        _check_bwd(q, k, v, g)
    b, n, h, _ = q.shape
    chunk = _dkv_chunk(n, k.shape[1], b * h, q.device)
    return torch.ops.segmif.sr_attention_bwd_dkv(q, k, v, g, lse2, delta,
                                                 float(scale), chunk)


@torch.library.custom_op("segmif::sr_attention_bwd_dkv", mutates_args=(),
                         device_types="cuda")
def sr_attention_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, g: torch.Tensor,
                            lse2: torch.Tensor, delta: torch.Tensor,
                            scale: float, chunk: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of ``segmif_sr_attention_bwd_dkv`` (the pass, then the
    in-order sum of its chunks: two launches) on the current stream; the
    partials and the outputs are allocated here."""
    if any(t.data_ptr() % 16 for t in (q, k, v, g)):
        raise ValueError(_ROWS)
    b, n, h, d = q.shape
    m = k.shape[1]
    n_chunks = math.ceil(n / chunk)
    dev = q.device
    lse2, delta = lse2.contiguous(), delta.contiguous()
    partial = torch.empty((2, n_chunks, b * h, m, d), dtype=torch.float32,
                          device=dev)
    dk = torch.empty((b, m, h, d), dtype=k.dtype, device=dev)
    dv = torch.empty((b, m, h, d), dtype=v.dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segmif_sr_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), partial.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, n, m, h, d, chunk, n_chunks,
            *_strides(q, k, v, g), float(scale), stream)
    _build.check(err, "sr_attention_bwd_dkv")
    sr_attention_bwd_dkv.launches += 1
    return dk, dv


@sr_attention_bwd_dkv_op.register_kernel("cpu")
def _sr_attention_bwd_dkv_cpu(q, k, v, g, lse2, delta, scale, chunk):
    return _bwd_dkv_plain(q, k, v, g, lse2, delta, scale)


@sr_attention_bwd_dkv_op.register_fake
def _sr_attention_bwd_dkv_fake(q, k, v, g, lse2, delta, scale, chunk):
    return k.new_empty(k.shape), v.new_empty(v.shape)


sr_attention_bwd_dkv.launches = 0


def sr_attention_backward(q, k, v, g, needs, scale: float) -> tuple:
    """The gradients of ``sr_attention_ref`` with respect to q, k and v
    (None where ``needs`` is False) for the output cotangent g (made
    contiguous here if autograd hands it in another layout): the dq pass
    (``sr_attention_bwd_dq``, which also gives lse2 and D), then, when k
    or v needs one, the dkv pass (``sr_attention_bwd_dkv``). On CUDA tensors
    both are kernels, three launches; on CPU tensors their plain versions
    (the CPU tests hold this chain to autograd's VJP)."""
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    dq, lse2, delta = sr_attention_bwd_dq(q, k, v, g, scale)
    dk = dv = None
    if needs[1] or needs[2]:
        dk, dv = sr_attention_bwd_dkv(q, k, v, g, lse2, delta, scale)
    return tuple(t if n else None for t, n in zip((dq, dk, dv), needs))


def linear_ctx_blockdiag_from_gram(gram: torch.Tensor, wkv: torch.Tensor,
                                   scale: float,
                                   num_heads: int) -> torch.Tensor:
    """Block-diagonal [B, C, C] context straight from a [B, C, C] gram:
    with K = X Wk and V = X Wv, K^T V = Wk^T (X^T X) Wv; then a per-head
    softmax over the key-feature axis (zeros outside the diagonal blocks).
    wkv: [C, 2C] (the fused KV projection, [in, out]). f32 throughout (f64
    for an f64 gram)."""
    c = gram.shape[-1]
    acc = _build.acc_dtype(gram.dtype)
    wk = wkv[:, :c].to(acc)
    wv = wkv[:, c:].to(acc)
    ctx = torch.einsum("ce,bcd,df->bef", wk, gram.to(acc), wv) * scale
    return _blockdiag_softmax(ctx, num_heads)


def _blockdiag_softmax(ctx: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Per-head softmax over the key-feature axis (-2) of a [B, C, C]
    context: each head's [D, D] diagonal block on its own, zeros outside
    the blocks."""
    c = ctx.shape[-1]
    blk = torch.arange(c, device=ctx.device) // (c // num_heads)
    mask = blk[:, None] == blk[None, :]
    return torch.softmax(ctx.masked_fill(~mask, float("-inf")), dim=-2)


def linear_ctx_blockdiag(k: torch.Tensor, v: torch.Tensor, scale: float,
                         num_heads: int) -> torch.Tensor:
    """Block-diagonal [B, C, C] context of flat linear attention from
    k, v [B, N, C]: the per-head contexts k_h^T v_h are the diagonal blocks
    of k^T v, each softmaxed over k's feature (axis -2). f32 (f64 for f64
    inputs) whatever the inputs' dtype, as JAX's
    ``preferred_element_type=float32``."""
    acc = _build.acc_dtype(k.dtype)
    ctx = torch.bmm(k.to(acc).transpose(1, 2), v.to(acc)) * scale
    return _blockdiag_softmax(ctx, num_heads)


def linear_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, num_heads: int,
                           return_ctx: bool = False):
    """Head-folded linear cross-attention on flat [B, N, C] tensors (the
    reference's "context vector" attention, ``model_fusion.py:263-288``):
    per head ctx_h = softmax((k_h^T v_h) * scale, over k's feature) and
    out_h = q_h ctx_h, computed as one [B, N, C] x [B, C, C] product
    against the block-diagonal context. q's length may differ from k's.
    Returns [B, N, C] in q's dtype, and with ``return_ctx`` also the
    [B, H, D, D] context blocks (f32; the reference's *_showAttention
    maps)."""
    bd = linear_ctx_blockdiag(k, v, scale, num_heads)
    out = torch.bmm(q, bd.to(q.dtype))
    if return_ctx:
        return out, ctx_blocks(bd, num_heads)
    return out


def ctx_blocks(bd: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The [B, H, D, D] diagonal blocks of a block-diagonal [B, C, C]
    context."""
    b, c = bd.shape[0], bd.shape[-1]
    d = c // num_heads
    heads = torch.arange(num_heads, device=bd.device)
    blocks = bd.view(b, num_heads, d, num_heads, d)[:, heads, :, heads, :]
    return blocks.transpose(0, 1)      # [H, B, D, D] -> [B, H, D, D]
