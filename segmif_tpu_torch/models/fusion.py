"""Fusion network in PyTorch (counterpart of ``segmif_tpu/models/fusion.py``):
the deployed ``Fusion_Network3_ac`` with interaction 'both', the deep tail
and the image-space trunk.

Per-branch entry conv -> PReLU -> DRDB, two interactive rounds of ONE
weight-shared feature-fusion module (FFM) against the seg taps (the
reference builds an ``ffm2`` and never calls it; there is none here), a
DRDB per branch between the rounds, then concat and three 3x3 convs down
to the fused Y. One PReLU scalar is shared by every activation. Taps are
accepted at full resolution or at the encoder stage's native resolution,
where the 1x1 projection runs first and the result is upsampled (the
projection commutes with the bilinear upsample).

Module names follow the reference state dict (``conv1_ir``, ``DRDB1.Dcov1``,
``DRDB1.conv``, ``conv3``/``conv4`` for the tap projections,
``ffm.cross.channel_proj1``, ``ffm.cross.cross_attn.kv3``,
``ffm.cross.cross_attn2.kv1``, ``conv2``/``conv21``/``conv22``,
``relu.weight``).

The trunk runs NCHW convs on channels_last memory, so the bytes of a
[B, C, H, W] activation are the [B, H*W, C] token view the FFM kernels read
without a copy.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.drdb import drdb_chain
from ..kernels.ffm import crosspath_apply
from ..ops.image import nchw, nhwc

_CL = torch.channels_last


class DRDB(nn.Module):
    """Dilated residual dense block: 5 dilated(2) 3x3 convs with dense
    concat growth, 1x1 bottleneck, residual add."""

    def __init__(self, channels: int = 64, growth_rate: int = 32):
        super().__init__()
        for i in range(5):
            setattr(self, f"Dcov{i + 1}", nn.Conv2d(
                channels + i * growth_rate, growth_rate, 3, padding=2,
                dilation=2))
        self.conv = nn.Conv2d(channels + 5 * growth_rate, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, f"Dcov{i + 1}") for i in range(5)]
        return drdb_chain(x, [(c.weight, c.bias) for c in convs],
                          (self.conv.weight, self.conv.bias))


class CrossAttention(nn.Module):
    """KV from the seg feature (reference ``CrossAttention``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.kv3 = nn.Linear(dim, 2 * dim, bias=False)


class CrossAttention2(nn.Module):
    """KV from each fusion branch (reference ``CrossAttention2``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.kv1 = nn.Linear(dim, 2 * dim, bias=False)
        self.kv2 = nn.Linear(dim, 2 * dim, bias=False)


class CrossPath(nn.Module):
    """Gated dual cross-attention exchange, computed in the folded form
    (``kernels.ffm``). Inputs and outputs are [B, N, C] tokens."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        for i in (1, 2, 3):
            setattr(self, f"channel_proj{i}", nn.Linear(dim, 2 * dim))
        self.cross_attn = CrossAttention(dim)
        self.cross_attn2 = CrossAttention2(dim)
        self.end_proj1 = nn.Linear(2 * dim, dim)
        self.end_proj2 = nn.Linear(2 * dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def folded_weights(self) -> Dict[str, torch.Tensor]:
        """Weights in the JAX layout ([in, out] kernels) that
        ``kernels.ffm`` takes."""
        w = {}
        for i in (1, 2, 3):
            lin = getattr(self, f"channel_proj{i}")
            w[f"wp{i}"], w[f"bp{i}"] = lin.weight.t(), lin.bias
        w["wkv3"] = self.cross_attn.kv3.weight.t()
        w["wkv1"] = self.cross_attn2.kv1.weight.t()
        w["wkv2"] = self.cross_attn2.kv2.weight.t()
        for i in (1, 2):
            lin = getattr(self, f"end_proj{i}")
            norm = getattr(self, f"norm{i}")
            w[f"we{i}"], w[f"be{i}"] = lin.weight.t(), lin.bias
            w[f"ln{i}_scale"], w[f"ln{i}_bias"] = norm.weight, norm.bias
        return w

    def forward(self, x1, x2, seg) -> Tuple[torch.Tensor, torch.Tensor]:
        return crosspath_apply(x1, x2, seg, self.folded_weights(),
                               self.scale, self.num_heads)


class FeatureFusionModule(nn.Module):
    """NCHW <-> token plumbing around CrossPath."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.cross = CrossPath(dim, num_heads)

    def forward(self, x1, x2, seg):
        """x1, x2, seg: [B, C, H, W] -> (o1, o2) [B, C, H, W] (channels_last
        memory)."""
        b, c, h, w = x1.shape

        def tokens(t):   # free view when t is channels_last
            return nhwc(t.contiguous(memory_format=_CL)).reshape(b, h * w, c)

        o1, o2 = self.cross(tokens(x1), tokens(x2), tokens(seg))
        return (nchw(o1.reshape(b, h, w, c)), nchw(o2.reshape(b, h, w, c)))


class FusionNetwork(nn.Module):
    """ir, vis_y: [B, H, W, >=1] (only channel 0 is used); seg_tap1/2: the
    encoder's stage-1/2 features, NHWC, at full or native resolution.
    Returns the fused Y [B, H, W, 1]. ``tap_channels`` are the encoder's
    stage-1/2 widths (64, 128 from mit_b1 up)."""

    def __init__(self, channels: int = 64, num_heads: int = 8,
                 tap_channels: Sequence[int] = (64, 128)):
        super().__init__()
        ch = channels
        self.conv1_ir = nn.Conv2d(1, ch, 3, padding=1)
        self.conv1_vis = nn.Conv2d(1, ch, 3, padding=1)
        for i in range(1, 5):
            setattr(self, f"DRDB{i}", DRDB(ch))
        self.conv3 = nn.Conv2d(tap_channels[0], ch, 1)
        self.conv4 = nn.Conv2d(tap_channels[1], ch, 1)
        self.ffm = FeatureFusionModule(ch, num_heads)
        self.conv2 = nn.Conv2d(2 * ch, ch, 3, padding=1)
        self.conv21 = nn.Conv2d(ch, ch // 2, 3, padding=1)
        self.conv22 = nn.Conv2d(ch // 2, 1, 3, padding=1)
        self.relu = nn.PReLU(num_parameters=1, init=0.25)

    def _prelu(self, t: torch.Tensor) -> torch.Tensor:
        return F.prelu(t, self.relu.weight)

    def _tap(self, tap: torch.Tensor, proj: nn.Conv2d,
             hw: Tuple[int, int]) -> torch.Tensor:
        s = proj(nchw(tap.to(proj.weight.dtype)))
        if s.shape[2:] != hw:
            s = F.interpolate(s, size=hw, mode="bilinear",
                              align_corners=False, antialias=False)
        return s

    def forward(self, ir: torch.Tensor, vis_y: torch.Tensor,
                seg_tap1: torch.Tensor,
                seg_tap2: torch.Tensor) -> torch.Tensor:
        dt = self.conv1_ir.weight.dtype
        hw = (ir.shape[1], ir.shape[2])

        def entry(x, conv):
            y = self._prelu(conv(nchw(x[..., 0:1].to(dt))))
            return y.contiguous(memory_format=_CL)

        x1 = self.DRDB1(entry(ir, self.conv1_ir))
        x2 = self.DRDB2(entry(vis_y, self.conv1_vis))
        x1, x2 = self.ffm(x1, x2, self._tap(seg_tap1, self.conv3, hw))
        x1 = self.DRDB3(x1)
        x2 = self.DRDB4(x2)
        x1, x2 = self.ffm(x1, x2, self._tap(seg_tap2, self.conv4, hw))
        y = self._prelu(self.conv2(torch.cat([x1, x2], dim=1)))
        y = self._prelu(self.conv21(y))
        y = self._prelu(self.conv22(y))
        return nhwc(y)
