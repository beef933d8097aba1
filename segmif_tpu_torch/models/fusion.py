"""Fusion networks in PyTorch (counterpart of ``segmif_tpu/models/fusion.py``):
``FusionNetwork`` (the deployed ``Fusion_Network3_ac`` with interaction
'both' and the deep tail, and its ablations: the interactions moam, soam,
concat, add, average and none, the short tail, the attention maps) on the
image-space trunk, and the legacy ``SimpleFusionNetwork``.

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
``ffm.cross.cross_attn2.kv1``, ``att1.conv.0``, ``conv2``/``conv21``/
``conv22``, ``relu.weight``); the 'concat' projections, which the reference
names otherwise, are ``cat_proj{1,2}_r{1,2}`` as in the JAX package.

The trunk runs NCHW convs on channels_last memory, so the bytes of a
[B, C, H, W] activation are the [B, H*W, C] token view the FFM kernels read
without a copy.

Under tensor parallelism (``parallel.tensor``) the FFM's projections are
held split over the model group and gathered where they are used
(``folded_weights`` and the modular path alike); the FFM maths runs whole
on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.attention import (ctx_blocks, linear_cross_attention,
                                 linear_ctx_blockdiag)
from ..kernels.drdb import (drdb_block, drdb_growth, drdb_tail, pack_growth,
                            pack_tail)
from ..kernels.ffm import crosspath_apply
from ..kernels.int8 import Int8Drdb, drdb_int8, quantize_drdb, record_amax
from ..ops.color import minmax_stretch
from ..ops.image import nchw, nhwc, resize_bilinear
from ..parallel import tensor as tp_ops
from ..utils.profiler import span

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
        pinned = getattr(self, "pinned_growth_w", None)
        if pinned is not None and pinned.dtype == dtype:
            return ((self.pinned_growth_w, self.pinned_growth_b),
                    (self.pinned_tail_w, self.pinned_tail_b))
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

    @torch.no_grad()
    def pin_kernel_weights(self, dtype: torch.dtype) -> None:
        """Keep the float kernels' packing for ``dtype`` as non-persistent
        buffers, which ``kernel_weights`` returns from then on: what an
        exported program carries, since a traced call reads no weight's
        address. For a copy that serves frozen weights: the buffers do not
        follow later edits of the weights."""
        gpk, tpk = self.kernel_weights(dtype)
        for name, t in zip(("growth_w", "growth_b", "tail_w", "tail_b"),
                           (*gpk, *tpk)):
            self.register_buffer("pinned_" + name, t.clone(),
                                 persistent=False)

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
    """KV from the seg feature, queries from both fusion branches: one
    block-diagonal context applied to both (reference ``CrossAttention``;
    the JAX package's ``CrossAttentionSeg2Branches``)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.kv3 = nn.Linear(dim, 2 * dim, bias=False)

    def forward(self, x1, x2, seg, return_context: bool = False):
        """[B, N, C] tokens -> (o1, o2) [B, N, C], and with
        ``return_context`` the [B, H, D, D] context blocks (f32)."""
        c = x1.shape[-1]
        scale = (c // self.num_heads) ** -0.5
        kv = tp_ops.linear(self.kv3, seg)
        bd = linear_ctx_blockdiag(kv[..., :c], kv[..., c:], scale,
                                  self.num_heads)
        o1 = torch.bmm(x1, bd.to(x1.dtype))
        o2 = torch.bmm(x2, bd.to(x2.dtype))
        if return_context:
            return o1, o2, ctx_blocks(bd, self.num_heads)
        return o1, o2


class CrossAttention2(nn.Module):
    """KV from each fusion branch, the query from the seg feature
    (reference ``CrossAttention2``; the JAX package's
    ``CrossAttentionBranches2Seg``)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.kv1 = nn.Linear(dim, 2 * dim, bias=False)
        self.kv2 = nn.Linear(dim, 2 * dim, bias=False)

    def forward(self, x1, x2, seg):
        c = x1.shape[-1]
        scale = (c // self.num_heads) ** -0.5
        outs = []
        for proj, x in ((self.kv1, x1), (self.kv2, x2)):
            kv = tp_ops.linear(proj, x)
            outs.append(linear_cross_attention(seg, kv[..., :c], kv[..., c:],
                                               scale, self.num_heads))
        return outs[0], outs[1]


FFM_INTERACTIONS = ("both", "moam", "soam")


class CrossPath(nn.Module):
    """Gated dual cross-attention exchange (reference ``CrossPath``;
    ``moam`` / ``soam`` are its ``CrossPath_M`` / ``CrossPath_S``
    ablations). Inputs and outputs are [B, N, C] tokens.

    'both' without ``return_context`` runs folded (``kernels.ffm``: the
    grams and apply kernels on the card); every other case runs the
    modular token path: the channel projections, the attention modules of
    the interaction, the end projections and the residual LayerNorms.
    Only the modules the interaction uses are built ('both' holds both
    attentions and end projections from 2C; 'moam' and 'soam' one
    attention and end projections from C)."""

    def __init__(self, dim: int, num_heads: int = 8,
                 interaction: str = "both", return_context: bool = False):
        super().__init__()
        if interaction not in FFM_INTERACTIONS:
            raise ValueError(f"unknown interaction {interaction!r}")
        self.num_heads = num_heads
        self.interaction = interaction
        self.return_context = return_context
        self.scale = (dim // num_heads) ** -0.5
        for i in (1, 2, 3):
            setattr(self, f"channel_proj{i}", nn.Linear(dim, 2 * dim))
        if interaction in ("both", "moam"):
            self.cross_attn = CrossAttention(dim, num_heads)
        if interaction in ("both", "soam"):
            self.cross_attn2 = CrossAttention2(dim, num_heads)
        mixed = 2 * dim if interaction == "both" else dim
        self.end_proj1 = nn.Linear(mixed, dim)
        self.end_proj2 = nn.Linear(mixed, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    @property
    def folded(self) -> bool:
        """Whether ``forward`` takes the FFM kernels."""
        return self.interaction == "both" and not self.return_context

    def folded_weights(self) -> Dict[str, torch.Tensor]:
        """Weights in the JAX layout ([in, out] kernels) that
        ``kernels.ffm`` takes ('both' only); split ones gathered."""
        full = tp_ops.full_weight
        w = {}
        for i in (1, 2, 3):
            lin = getattr(self, f"channel_proj{i}")
            w[f"wp{i}"], w[f"bp{i}"] = full(lin).t(), lin.bias
        w["wkv3"] = full(self.cross_attn.kv3).t()
        w["wkv1"] = full(self.cross_attn2.kv1).t()
        w["wkv2"] = full(self.cross_attn2.kv2).t()
        for i in (1, 2):
            lin = getattr(self, f"end_proj{i}")
            norm = getattr(self, f"norm{i}")
            w[f"we{i}"], w[f"be{i}"] = full(lin).t(), lin.bias
            w[f"ln{i}_scale"], w[f"ln{i}_bias"] = norm.weight, norm.bias
        return w

    def forward(self, x1, x2, seg):
        """(o1, o2), and with ``return_context`` the context blocks of
        the seg-to-branches attention ([B, H, D, D]; None without one)."""
        if self.folded:
            return crosspath_apply(x1, x2, seg, self.folded_weights(),
                                   self.scale, self.num_heads)
        lin = tp_ops.linear
        y1, u1 = F.relu(lin(self.channel_proj1, x1)).chunk(2, dim=-1)
        y2, u2 = F.relu(lin(self.channel_proj2, x2)).chunk(2, dim=-1)
        y3, u3 = F.relu(lin(self.channel_proj3, seg)).chunk(2, dim=-1)
        ctx = None
        if self.interaction == "both":
            out = self.cross_attn(u1, u2, u3, self.return_context)
            v1, v2 = out[:2]
            if self.return_context:
                ctx = out[2]
            z1, z2 = self.cross_attn2(y1, y2, y3)
            m1, m2 = torch.cat([z1, v1], dim=-1), torch.cat([z2, v2], dim=-1)
        elif self.interaction == "moam":
            m1, m2 = self.cross_attn(u1, u2, u3)
        else:
            m1, m2 = self.cross_attn2(y1, y2, y3)
        o1 = self.norm1(x1 + lin(self.end_proj1, m1))
        o2 = self.norm2(x2 + lin(self.end_proj2, m2))
        if self.return_context:
            return o1, o2, ctx
        return o1, o2


class FeatureFusionModule(nn.Module):
    """NCHW <-> token plumbing around CrossPath."""

    def __init__(self, dim: int, num_heads: int = 8,
                 interaction: str = "both", return_context: bool = False):
        super().__init__()
        self.cross = CrossPath(dim, num_heads, interaction, return_context)

    def forward(self, x1, x2, seg):
        """x1, x2, seg: [B, C, H, W] -> (o1, o2) [B, C, H, W] (channels_last
        memory), and the CrossPath's context with ``return_context``."""
        b, c, h, w = x1.shape

        def tokens(t):   # free view when t is channels_last
            return nhwc(t.contiguous(memory_format=_CL)).reshape(b, h * w, c)

        out = self.cross(tokens(x1), tokens(x2), tokens(seg))
        o1, o2 = (nchw(o.reshape(b, h, w, c)) for o in out[:2])
        return (o1, o2) + tuple(out[2:])


class AttentionModule(nn.Module):
    """Sigmoid-gated conv attention of ``Fusion_Network3_Average``
    (reference ``model_fusion.py:759-771``): conv3x3 -> ReLU -> conv3x3
    -> sigmoid(y) * y (the gate multiplies the conv output)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU(),
            nn.Conv2d(channels, channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return torch.sigmoid(y) * y


INTERACTIONS = FFM_INTERACTIONS + ("concat", "add", "average", "none")
TAILS = ("deep", "short")


class FusionNetwork(nn.Module):
    """ir, vis_y: [B, H, W, >=1] (only channel 0 is used); seg_tap1/2: the
    encoder's stage-1/2 features, NHWC, at full or native resolution.
    Returns the fused Y [B, H, W, 1]. ``tap_channels`` are the encoder's
    stage-1/2 widths (64, 128 from mit_b1 up). ``quant`` is the DRDBs'
    mode (see ``DRDB``).

    ``interaction`` (each round's exchange with the seg tap): 'both' (the
    deployed ``Fusion_Network3_ac``), 'moam' / 'soam' (one attention of
    the FFM), 'concat' (1x1 projections of [x, seg], ``cat_proj{1,2}_r
    {round}``), 'add' (x + seg), 'average' (``Fusion_Network3_Average``:
    att1..att4 in round 1 and att5..att8 in round 2 on (x1, seg, x2,
    seg)), 'none' (the taps are ignored). The FFM is one module shared by
    both rounds. ``tail``: 'deep' (conv2 -> conv21(C/2) -> conv22(1)) or
    'short' (conv2 -> conv21(1), the 32-channel ablations'). With
    ``return_attention`` the forward returns (fused Y, [round-1 context,
    round-2 context]): 'both' takes the modular path and gives the [B, H,
    D, D] maps of its seg-to-branches attention; 'moam' and 'soam' give
    None for each round and the other interactions no entries, as the JAX
    package does. Only the submodules the variant uses are
    built, so the state dict holds exactly its parameters."""

    def __init__(self, channels: int = 64, num_heads: int = 8,
                 tap_channels: Sequence[int] = (64, 128),
                 quant: str = "none", interaction: str = "both",
                 tail: str = "deep", return_attention: bool = False):
        super().__init__()
        if interaction not in INTERACTIONS:
            raise ValueError(f"unknown interaction {interaction!r}")
        if tail not in TAILS:
            raise ValueError(f"unknown tail {tail!r}")
        ch = channels
        self.interaction = interaction
        self.return_attention = return_attention
        self.conv1_ir = nn.Conv2d(1, ch, 3, padding=1)
        self.conv1_vis = nn.Conv2d(1, ch, 3, padding=1)
        for i in range(1, 5):
            setattr(self, f"DRDB{i}", DRDB(ch, quant=quant))
        if interaction != "none":
            self.conv3 = nn.Conv2d(tap_channels[0], ch, 1)
            self.conv4 = nn.Conv2d(tap_channels[1], ch, 1)
        if interaction in FFM_INTERACTIONS:
            self.ffm = FeatureFusionModule(ch, num_heads, interaction,
                                           return_attention)
        elif interaction == "concat":
            for r in (1, 2):
                for i in (1, 2):
                    setattr(self, f"cat_proj{i}_r{r}",
                            nn.Conv2d(2 * ch, ch, 1))
        elif interaction == "average":
            for i in range(1, 9):
                setattr(self, f"att{i}", AttentionModule(ch))
        self.conv2 = nn.Conv2d(2 * ch, ch, 3, padding=1)
        if tail == "deep":
            self.conv21 = nn.Conv2d(ch, ch // 2, 3, padding=1)
            self.conv22 = nn.Conv2d(ch // 2, 1, 3, padding=1)
        else:
            self.conv21 = nn.Conv2d(ch, 1, 3, padding=1)
            self.conv22 = None
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
            s = nchw(resize_bilinear(nhwc(s), hw))
        return s

    def _interact(self, x1, x2, s, round_idx: int, maps: list):
        """One round's exchange between the branches and the projected
        tap ``s`` ([B, C, H, W] each); channels_last out."""
        if self.interaction in FFM_INTERACTIONS:
            out = self.ffm(x1, x2, s)
            if self.return_attention:
                maps.append(out[2])
            x1, x2 = out[:2]
        elif self.interaction == "concat":
            x1 = getattr(self, f"cat_proj1_r{round_idx}")(
                torch.cat([x1, s], dim=1))
            x2 = getattr(self, f"cat_proj2_r{round_idx}")(
                torch.cat([x2, s], dim=1))
        elif self.interaction == "add":
            x1, x2 = x1 + s, x2 + s
        else:   # average
            base = (round_idx - 1) * 4 + 1
            att = [getattr(self, f"att{base + i}") for i in range(4)]
            x1 = att[0](x1) + att[1](s)
            x2 = att[2](x2) + att[3](s)
        return (x1.contiguous(memory_format=_CL),
                x2.contiguous(memory_format=_CL))

    def forward(self, ir: torch.Tensor, vis_y: torch.Tensor,
                seg_tap1: Optional[torch.Tensor] = None,
                seg_tap2: Optional[torch.Tensor] = None):
        dt = self.conv1_ir.weight.dtype
        hw = (ir.shape[1], ir.shape[2])

        def entry(x, conv):
            y = self._prelu(conv(nchw(x[..., 0:1].to(dt))))
            return y.contiguous(memory_format=_CL)

        maps: list = []
        with span("fusion"):
            x1 = entry(ir, self.conv1_ir)
            with span("fusion/drdb1"):
                x1 = self.DRDB1(x1)
            x2 = entry(vis_y, self.conv1_vis)
            with span("fusion/drdb2"):
                x2 = self.DRDB2(x2)
            if self.interaction != "none":
                with span("fusion/ffm1"):
                    x1, x2 = self._interact(
                        x1, x2, self._tap(seg_tap1, self.conv3, hw), 1, maps)
            with span("fusion/drdb3"):
                x1 = self.DRDB3(x1)
            with span("fusion/drdb4"):
                x2 = self.DRDB4(x2)
            if self.interaction != "none":
                with span("fusion/ffm2"):
                    x1, x2 = self._interact(
                        x1, x2, self._tap(seg_tap2, self.conv4, hw), 2, maps)
            y = self._prelu(self.conv2(torch.cat([x1, x2], dim=1)))
            y = self._prelu(self.conv21(y))
            if self.conv22 is not None:
                y = self._prelu(self.conv22(y))
        if self.return_attention:
            return nhwc(y), maps
        return nhwc(y)


class SimpleFusionNetwork(nn.Module):
    """The legacy two-input fusion net without seg interaction (reference
    ``Fusion_Network``, ``model_fusion.py:158-182``): IR and VIS Y
    concatenated, conv3x3 to 2C, PReLU, two DRDBs, conv3x3 to 1, PReLU,
    clip to [0, 1] and a min-max stretch over the whole batch
    (``ops.color.minmax_stretch``). ir, vis_y: [B, H, W, >=1] -> [B, H, W,
    1]. On the card the DRDBs run the DRDB kernels (2C = 64)."""

    def __init__(self, channels: int = 32):
        super().__init__()
        ch = 2 * channels
        self.conv1 = nn.Conv2d(2, ch, 3, padding=1)
        self.DRDB1 = DRDB(ch)
        self.DRDB2 = DRDB(ch)
        self.conv2 = nn.Conv2d(ch, 1, 3, padding=1)
        self.relu = nn.PReLU(num_parameters=1, init=0.25)

    def forward(self, ir: torch.Tensor, vis_y: torch.Tensor) -> torch.Tensor:
        dt = self.conv1.weight.dtype
        x = torch.cat([ir[..., 0:1], vis_y[..., 0:1]], dim=-1).to(dt)
        x = F.prelu(self.conv1(nchw(x)), self.relu.weight)
        x = self.DRDB2(self.DRDB1(x.contiguous(memory_format=_CL)))
        x = F.prelu(self.conv2(x), self.relu.weight).clamp(0.0, 1.0)
        return minmax_stretch(nhwc(x))
