"""Attention compute for the port (counterpart of
``segmif_tpu/kernels/attention.py``).

 - ``sr_attention``: MiT spatially-reduced softmax attention. On a CUDA
   tensor it launches the hand-written kernel ``csrc/sr_attention.cu``
   (replacing the TPU kernel ``pallas_attention._sr_attention_fwd_impl``);
   on a CPU tensor it runs the plain version ``sr_attention_ref``. Under
   autograd the kernel sits in an ``autograd.Function`` whose backward is
   the VJP of ``sr_attention_ref`` with respect to q, k and v, recomputed
   in plain PyTorch (the JAX ``custom_vjp`` of ``pallas_attention.py``:
   ``_bwd`` recomputes through XLA).
 - ``linear_ctx_blockdiag_from_gram``: the block-diagonal per-head
   softmax context of the folded CrossPath, from a [C, C] gram. Tiny
   matrices, plain torch on every device.
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

    CPU tensors take ``sr_attention_ref``; CUDA tensors launch the kernel,
    which reads q/k/v through their strides (the last dim contiguous) and
    raises on a shape or dtype it does not take. Both stream K/V through
    shared memory, so any M is taken: bf16 on tensor cores (its rows must
    start on 16 bytes), f32 on the CUDA cores. When a gradient is needed
    the kernel runs inside ``_SrAttentionFn``."""
    if q.device.type == "cpu":
        return sr_attention_ref(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"sr_attention: unsupported device {q.device}")
    if _build.needs_grad(q, k, v):
        return _sr_attention_grad(q, k, v, scale)
    return _sr_attention_kernel(q, k, v, scale)


def _sr_attention_kernel(q, k, v, scale: float) -> torch.Tensor:
    """One launch of ``segmif_sr_attention`` (forward only)."""
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
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st, sz in zip(
                t.stride()[:3], t.shape[:3]) if sz > 1)
            for t in (q, k, v)):
        raise ValueError("sr_attention: bf16 rows must start on 16 bytes "
                         "(pointers and strides)")
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
    blk = torch.arange(c, device=gram.device) // (c // num_heads)
    mask = blk[:, None] == blk[None, :]
    ctx = ctx.masked_fill(~mask, float("-inf"))
    return torch.softmax(ctx, dim=-2)
