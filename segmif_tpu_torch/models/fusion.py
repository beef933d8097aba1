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

from ..kernels.drdb import (drdb_block, drdb_growth, drdb_tail, pack_growth,
                            pack_tail)
from ..kernels.ffm import crosspath_apply
from ..kernels.int8 import Int8Drdb, drdb_int8, quantize_drdb, record_amax
from ..ops.image import nchw, nhwc

_CL = torch.channels_last


QUANT_MODES = ("none", "calibrate", "int8")


class DRDB(nn.Module):
    """Dilated residual dense block: 5 dilated(2) 3x3 convs with dense
    concat growth, 1x1 bottleneck, residual add. On the card it runs the
    growth and tail kernels (``kernels.drdb.drdb_block``) and returns
    channels_last memory, which the FFM's token view relies on.

    ``quant`` (counterpart of the JAX DRDB's): "none"; "calibrate" runs the
    same float path and records the running abs-max of (x, r1..r5) into
    ``amax``; "int8" runs ``kernels.int8.drdb_int8`` on the weights that
    ``set_quant("int8")`` quantised and packed once. ``amax`` and the int8
    weights are non-persistent buffers (the state dict keeps the reference
    keys) that follow the module's device but keep their dtypes. A DRDB is
    built in "none" or "calibrate" mode; "int8" needs its weights and
    amaxes, so it is entered by ``set_quant`` once they are there."""

    def __init__(self, channels: int = 64, growth_rate: int = 32,
                 quant: str = "none"):
        super().__init__()
        for i in range(5):
            setattr(self, f"Dcov{i + 1}", nn.Conv2d(
                channels + i * growth_rate, growth_rate, 3, padding=2,
                dilation=2))
        self.conv = nn.Conv2d(channels + 5 * growth_rate, channels, 1)
        self.register_buffer("amax", torch.zeros(6), persistent=False)
        if quant not in QUANT_MODES[:2]:
            raise ValueError(f"DRDB is built with quant 'none' or "
                             f"'calibrate', got {quant!r}; set_quant('int8') "
                             "after calibrating")
        self.quant = quant
        # (key, (growth pack, tail pack), weights): see kernel_weights
        self._packed = None

    def _weights(self):
        convs = [getattr(self, f"Dcov{i + 1}") for i in range(5)]
        return ([(c.weight, c.bias) for c in convs],
                (self.conv.weight, self.conv.bias))

    @torch.no_grad()
    def kernel_weights(self, dtype: torch.dtype):
        """The float kernels' weights, (``pack_growth``, ``pack_tail``) for
        activations of ``dtype``, packed once and kept in a plain attribute
        (not a buffer: ``_apply`` keeps buffers' dtypes). They are packed
        again when the dtype, the device or any weight changes: the key
        holds each weight's address and in-place version, which
        ``load_state_dict``, ``.to()`` and an in-place edit all change. The
        cache also holds the weights' storages, so no other weight can
        take one of those addresses while the key names it."""
        dconvs, (wb, bb) = self._weights()
        ws = [t for c in dconvs for t in c] + [wb, bb]
        if any(t.is_inference() for t in ws):   # no version counter
            return pack_growth(dconvs, dtype), pack_tail(wb, bb, dtype)
        key = (dtype, wb.device, tuple((t.data_ptr(), t._version)
                                       for t in ws))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, (pack_growth(dconvs, dtype),
                                  pack_tail(wb, bb, dtype)),
                            [t.detach() for t in ws])
        return self._packed[1]

    def _apply(self, fn, recurse=True):
        # .to(dtype) and friends must not round the scales or the int8
        # weights: they only follow the device
        keep = {n: b for n, b in self._buffers.items() if b is not None}
        super()._apply(fn, recurse)
        dev = self.conv.weight.device
        for n, b in keep.items():
            self._buffers[n] = b.to(dev)
        return self

    @torch.no_grad()
    def set_quant(self, mode: str) -> None:
        """Switch modes. "calibrate" clears ``amax``; "int8" quantises the
        current weights with it (calibrate first)."""
        if mode not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {mode!r}")
        if mode == "calibrate":
            self.amax.zero_()
        if mode == "int8":
            if not bool((self.amax > 0).any()):
                raise ValueError("DRDB: no calibrated amax; run a "
                                 "calibrate pass or load one first")
            q = quantize_drdb(*self._weights(), self.amax)
            for name, t in q.tensors().items():
                self.register_buffer("int8_" + name, t, persistent=False)
        self.quant = mode

    def _int8_weights(self) -> Int8Drdb:
        return Int8Drdb.from_tensors(lambda n: getattr(self, "int8_" + n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant == "int8":
            return drdb_int8(x, self._int8_weights())
        dconvs, bottleneck = self._weights()
        wpk = self.kernel_weights(x.dtype) if x.is_cuda else None
        if self.quant == "calibrate":
            gpk, tpk = (None, None) if wpk is None else wpk
            rs = drdb_growth(x, dconvs, gpk)
            with torch.no_grad():
                self.amax.copy_(torch.maximum(self.amax,
                                              record_amax([x, *rs])))
            return drdb_tail(x, rs, *bottleneck, wpk=tpk)
        return drdb_block(x, dconvs, bottleneck, wpk)


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
    stage-1/2 widths (64, 128 from mit_b1 up). ``quant`` is the DRDBs'
    mode (see ``DRDB``)."""

    def __init__(self, channels: int = 64, num_heads: int = 8,
                 tap_channels: Sequence[int] = (64, 128),
                 quant: str = "none"):
        super().__init__()
        ch = channels
        self.conv1_ir = nn.Conv2d(1, ch, 3, padding=1)
        self.conv1_vis = nn.Conv2d(1, ch, 3, padding=1)
        for i in range(1, 5):
            setattr(self, f"DRDB{i}", DRDB(ch, quant=quant))
        self.conv3 = nn.Conv2d(tap_channels[0], ch, 1)
        self.conv4 = nn.Conv2d(tap_channels[1], ch, 1)
        self.ffm = FeatureFusionModule(ch, num_heads)
        self.conv2 = nn.Conv2d(2 * ch, ch, 3, padding=1)
        self.conv21 = nn.Conv2d(ch, ch // 2, 3, padding=1)
        self.conv22 = nn.Conv2d(ch // 2, 1, 3, padding=1)
        self.relu = nn.PReLU(num_parameters=1, init=0.25)

    def drdbs(self) -> Tuple[DRDB, ...]:
        return tuple(getattr(self, f"DRDB{i}") for i in range(1, 5))

    def set_quant(self, mode: str) -> None:
        """``DRDB.set_quant`` on all four DRDBs."""
        for d in self.drdbs():
            d.set_quant(mode)

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
