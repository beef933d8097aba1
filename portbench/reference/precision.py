"""The precision of the reference's products.

The reference computes in float32 with TF32 off. Its control computes the
same maths in a lower precision: the operands of every product
(convolutions, linear layers, attention and context products) rounded to
it, the products accumulated in float32 as a tensor-core kernel in that
precision does, and (``HeldIn``) every result of every operation,
products, norms, softmaxes, activations, residual sums and the backward
pass's alike, rounded to it again, as a program that computes in that
precision holds every value it makes:

 - ``float32``: no rounding;
 - ``bfloat16``: rounded to bfloat16;
 - ``float8_e4m3``: scaled by 448 / the tensor's largest magnitude,
   rounded to float8 e4m3 and scaled back (per-tensor scaling, as an fp8
   GEMM takes its operands).

The rounding is a straight-through estimator: the forward pass sees the
rounded operand, the backward pass takes the gradient as if it were not
rounded (an fp8 training recipe keeps its gradients in a wider type).
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

KINDS = ("float32", "bfloat16", "float8_e4m3")
FP8_MAX = 448.0


def rounder(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding of ``kind`` (one of ``KINDS``)."""
    if kind == "float32":
        return lambda t: t
    if kind == "bfloat16":
        return lambda t: _ste(t, t.detach().to(torch.bfloat16).float())
    if kind == "float8_e4m3":
        return _fp8
    raise ValueError(f"unknown precision {kind!r}; one of {KINDS}")


def _quantise(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Plain rounding to ``kind``, result in the tensor's own type."""
    if kind == "bfloat16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)

    def fp8(t):
        amax = t.abs().amax()
        if not bool(amax > 0):
            return t
        scale = FP8_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale

    return fp8


class HeldIn(TorchDispatchMode):
    """Inside the block, every floating result of every operation (views
    and in-place updates aside), in the forward pass and in the backward,
    rounded to ``kind``: the computation held in that precision, as a
    program computing in it holds every value it makes."""

    def __init__(self, kind: str):
        super().__init__()
        self.q = _quantise(kind)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.is_mutable:
            return out
        inputs = {a.untyped_storage().data_ptr()
                  for a in tree_flatten((args, kwargs))[0]
                  if isinstance(a, torch.Tensor)}

        def held(t):
            if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                    and t.numel()
                    and t.untyped_storage().data_ptr() not in inputs):
                return self.q(t)
            return t

        return tree_map(held, out)


def held_in(kind: str):
    """``HeldIn(kind)`` for a lower precision; nothing for float32."""
    return contextlib.nullcontext() if kind == "float32" else HeldIn(kind)


def _ste(t: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    if not t.requires_grad:
        return rounded
    return t + (rounded - t.detach())


def _fp8(t: torch.Tensor) -> torch.Tensor:
    d = t.detach().float()
    scale = FP8_MAX / d.abs().amax().clamp_min(1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).float() / scale
    return _ste(t, q)


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matmuls and cuDNN convolutions inside the block; the
    flags are restored after it."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
