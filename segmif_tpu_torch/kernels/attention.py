"""Attention compute for the port (counterpart of
``segmif_tpu/kernels/attention.py``).

 - ``sr_attention``: MiT spatially-reduced softmax attention, through
   the operator ``segmif::sr_attention``. On a CUDA tensor it launches
   the hand-written kernel ``csrc/sr_attention.cu`` (replacing the TPU
   kernel ``pallas_attention._sr_attention_fwd_impl``); on a CPU tensor
   it runs the plain version ``sr_attention_ref``. Under
   autograd the kernel sits in an ``autograd.Function`` whose backward is
   the VJP of ``sr_attention_ref`` with respect to q, k and v, recomputed
   in plain PyTorch (the JAX ``custom_vjp`` of ``pallas_attention.py``:
   ``_bwd`` recomputes through XLA).
 - ``linear_ctx_blockdiag_from_gram``: the block-diagonal per-head
   softmax context of the folded CrossPath, from a [C, C] gram. Tiny
   matrices, plain torch on every device.
 - ``linear_cross_attention`` / ``linear_ctx_blockdiag``: the modular
   CrossPath's head-folded linear cross-attention over [B, N, C] tokens
   (``linear_cross_attention_flat`` of the JAX package, which computes it
   in XLA: no TPU kernel, and plain torch here on every device).
"""
from __future__ import annotations

import torch

from . import _build


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
    """The kernel's forward; the backward recomputes the plain version."""

    @staticmethod
    def forward(ctx, scale, forward, q, k, v):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + _build.plain_vjp(
            lambda q, k, v: sr_attention_ref(q, k, v, ctx.scale),
            ctx.saved_tensors, ctx.needs_input_grad[2:], (g,))


def _sr_attention_grad(q, k, v, scale: float, forward=None) -> torch.Tensor:
    """sr-attention that carries a gradient. ``forward`` stands in for the
    kernel (a test passes the plain version to gradcheck the Function on
    the CPU); nothing on the main path sets it."""
    return _SrAttentionFn.apply(scale, forward or _sr_attention_kernel,
                                q, k, v)


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
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != k.shape:
        raise ValueError(f"sr_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"sr_attention: dtypes {q.dtype} {k.dtype} "
                         f"{v.dtype}; the kernel takes f32 or bf16")
    if not (q.device == k.device == v.device):
        raise ValueError("sr_attention: q, k, v on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("sr_attention: the head dim must be contiguous")
    if d not in (32, 64):
        raise ValueError(
            f"sr_attention: head dim {d} (the kernel takes 32 or 64)")
    per_row = 16 // q.element_size()
    if any(any(st % per_row for st, sz in zip(t.stride()[:3], t.shape[:3])
               if sz > 1) for t in (q, k, v)):
        raise ValueError(_ROWS)


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
