"""MiT (Mix Vision Transformer), the SegFormer encoder, in PyTorch
(counterpart of ``segmif_tpu/models/mit.py``).

Feature maps are NHWC and tokens [B, N, C] at the public surface, as in the
JAX package; convs run on NCHW views of the same bytes (channels_last).
Module names follow the reference state dict (``patch_embed1.proj``,
``block1.0.attn.q``, ``block1.0.mlp.dwconv.dwconv``, ``norm1``, ...).

Stochastic depth (``drop_path``) runs only when ``forward`` is called
with ``train=True``; its masks come from the ``torch.Generator`` the
caller passes, never from the global RNG. Block i of the whole encoder
drops with rate ``drop_path_rate * i / (total_depth - 1)``. Called as
before (``train=False``), every block is deterministic.

 - GELU is exact (erf).
 - LayerNorm eps: 1e-6 for block and stage norms, 1e-5 for the
   patch-embed and sr norms.
 - The depthwise 3x3 of Mix-FFN is a grouped conv.
 - Attention goes through ``kernels.attention.sr_attention``: the CUDA
   kernel on CUDA tensors, plain PyTorch on CPU tensors.
 - Under tensor parallelism (``parallel.tensor.tensor_parallel`` sets a
   block's ``tp``, its model group) the attention and the Mix-FFN run
   their split leaves Megatron-style; see ``parallel.tensor``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.attention import sr_attention
from ..ops.image import nchw, nhwc
from ..parallel import tensor as tp_ops
from ..utils.profiler import span


@dataclasses.dataclass(frozen=True)
class MiTConfig:
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 4, 18, 3)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)


MIT_VARIANTS = {
    "mit_b0": MiTConfig(embed_dims=(32, 64, 160, 256), depths=(2, 2, 2, 2)),
    "mit_b1": MiTConfig(depths=(2, 2, 2, 2)),
    "mit_b2": MiTConfig(depths=(3, 4, 6, 3)),
    "mit_b3": MiTConfig(depths=(3, 4, 18, 3)),
    "mit_b4": MiTConfig(depths=(3, 8, 27, 3)),
    "mit_b5": MiTConfig(depths=(3, 6, 40, 3)),
}


def drop_path_rates(config: MiTConfig) -> List[float]:
    """The linear stochastic-depth schedule over all blocks, in order."""
    total = sum(config.depths)
    return [config.drop_path_rate * i / max(total - 1, 1)
            for i in range(total)]


def uniform(shape, gen, device) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` on ``device`` from ``gen``: a
    ``torch.Generator``, or under data parallelism a
    ``parallel.mesh.BatchShard``, which draws for the global batch and
    keeps this rank's rows."""
    if isinstance(gen, torch.Generator):
        return torch.rand(shape, generator=gen, device=device)
    return gen.rand(shape, device)


def drop_path_mask(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """One keep (1) / drop (0) draw per sample, shaped to broadcast over
    ``x``, in x's dtype: uniform < 1 - rate, from ``gen`` (``uniform``)
    on x's device."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return (uniform(shape, gen, x.device) < 1.0 - rate).to(x.dtype)


def drop_path(x: torch.Tensor, rate: float, mask: torch.Tensor
              ) -> torch.Tensor:
    """Stochastic depth with a drawn mask: kept samples scaled by
    1 / (1 - rate)."""
    return x * mask / (1.0 - rate)


def _tokens_to_nchw(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return nchw(x.reshape(x.shape[0], h, w, x.shape[-1]))


def _nchw_to_tokens(x: torch.Tensor) -> torch.Tensor:
    b, c = x.shape[0], x.shape[1]
    return nhwc(x).reshape(b, -1, c)


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv patch embedding + LayerNorm over tokens."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int,
                 stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride,
                              padding=patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor):
        """x: NHWC -> (tokens [B, h*w, E], h, w)."""
        y = self.proj(nchw(x))
        h, w = y.shape[2], y.shape[3]
        return self.norm(_nchw_to_tokens(y)), h, w


class EfficientSelfAttention(nn.Module):
    """Spatially-reduced self-attention: K/V from an sr-strided conv of the
    token grid. ``tp``: the model group when q, kv and proj are split."""

    tp = None

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.scale = (dim // num_heads) ** -0.5
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        heads = self.num_heads
        xs = x
        if self.sr_ratio > 1:
            xs = self.norm(_nchw_to_tokens(self.sr(_tokens_to_nchw(x, h, w))))
        if self.tp is not None:
            return self._forward_tp(x, xs, heads, c // heads)
        q = self.q(x).unflatten(-1, (heads, c // heads))
        kv = self.kv(xs)
        k = kv[..., :c].unflatten(-1, (heads, c // heads))
        v = kv[..., c:].unflatten(-1, (heads, c // heads))
        out = sr_attention(q, k, v, self.scale)
        return self.proj(out.reshape(b, n, c))

    def _forward_tp(self, x, xs, heads: int, d: int) -> torch.Tensor:
        """The rank's heads of q, k and v (its columns of q and of each
        half of kv); all heads on every rank, gathered, where the group
        does not divide them; proj row-parallel."""
        comm = self.tp
        q = tp_ops.col_linear(x, self.q, comm)
        kv = tp_ops.col_linear(xs, self.kv, comm)
        cl = q.shape[-1]
        k, v = kv[..., :cl], kv[..., cl:]
        if heads % comm.world:
            q, k, v = (tp_ops.gather(t, comm) for t in (q, k, v))
        hl = q.shape[-1] // d
        out = sr_attention(*(t.unflatten(-1, (hl, d)) for t in (q, k, v)),
                           self.scale).flatten(-2)
        if heads % comm.world:
            out = tp_ops.scatter(out, comm)
        return tp_ops.row_linear(out, self.proj, comm)


class DWConv(nn.Module):
    """Depthwise 3x3 'same' conv on a token grid."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return _nchw_to_tokens(self.dwconv(_tokens_to_nchw(x, h, w)))


class MixFFN(nn.Module):
    """fc1 -> depthwise 3x3 conv -> GELU (exact) -> fc2. ``tp``: the model
    group when fc1 and fc2 are split."""

    tp = None

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.dwconv = DWConv(hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        if self.tp is not None:
            return self._forward_tp(x, h, w)
        y = F.gelu(self.dwconv(self.fc1(x), h, w), approximate="none")
        return self.fc2(y)

    def _forward_tp(self, x, h: int, w: int) -> torch.Tensor:
        """fc1 column-parallel, the rank's channels of the whole depthwise
        conv, fc2 row-parallel."""
        comm = self.tp
        y = tp_ops.col_linear(x, self.fc1, comm)
        conv = self.dwconv.dwconv
        wd, bd = (tp_ops.local(tp_ops.copy(t, comm), comm.rank, comm.world,
                               0) for t in (conv.weight, conv.bias))
        y = _nchw_to_tokens(F.conv2d(_tokens_to_nchw(y, h, w), wd, bd,
                                     padding=1, groups=wd.shape[0]))
        y = F.gelu(y, approximate="none")
        return tp_ops.row_linear(y, self.fc2, comm)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int, qkv_bias: bool, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = EfficientSelfAttention(dim, num_heads, sr_ratio, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.drop_path_rate if train else 0.0
        if rate > 0.0 and gen is None:
            raise ValueError("drop-path in train mode needs a generator")
        y = self.attn(self.norm1(x), h, w)
        if rate > 0.0:   # two masks per block, drawn in this order
            m1, m2 = (drop_path_mask(x, rate, gen) for _ in range(2))
            y = drop_path(y, rate, m1)
        x = x + y
        y = self.mlp(self.norm2(x), h, w)
        if rate > 0.0:
            y = drop_path(y, rate, m2)
        return x + y


class MixVisionTransformer(nn.Module):
    def __init__(self, config: MiTConfig, in_chans: int = 3):
        super().__init__()
        self.config = config
        cin = in_chans
        rates = iter(drop_path_rates(config))
        for i in range(4):
            e = config.embed_dims[i]
            setattr(self, f"patch_embed{i + 1}", OverlapPatchEmbed(
                cin, e, config.patch_sizes[i], config.strides[i]))
            setattr(self, f"block{i + 1}", nn.ModuleList(
                Block(e, config.num_heads[i], config.sr_ratios[i],
                      config.mlp_ratios[i], config.qkv_bias, next(rates))
                for _ in range(config.depths[i])))
            setattr(self, f"norm{i + 1}", nn.LayerNorm(e, eps=1e-6))
            cin = e

    def forward(self, x: torch.Tensor, stages: int = 4, train: bool = False,
                gen: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """x: NHWC image. Returns the first ``stages`` stage feature maps
        (NHWC, at 1/4, 1/8, 1/16, 1/32 resolution). Stopping early skips
        the later stages' work entirely. ``train=True`` turns drop-path on,
        with masks from ``gen``."""
        outs = []
        b = x.shape[0]
        with span("seg/encoder"):
            for i in range(stages):
                with span(f"seg/stage{i + 1}"):
                    x, h, w = getattr(self, f"patch_embed{i + 1}")(x)
                    for blk in getattr(self, f"block{i + 1}"):
                        x = blk(x, h, w, train, gen)
                    x = getattr(self, f"norm{i + 1}")(x)
                    x = x.reshape(b, h, w, x.shape[-1])
                outs.append(x)
        return outs
