"""The plain reference of the benchmark's configurations: SegMiF's joint
pipeline (the fusion network with its DRDBs and FFM, then SegFormer's MiT
encoder and all-MLP head on the fused image), written from the papers'
equations in plain PyTorch, float32, no kernels, no caches, no batching
tricks.

 - SegMiF (Liu et al., ICCV 2023, arXiv 2308.02097): per branch an entry
   3x3 conv and PReLU, a DRDB (five dilated 3x3 convs with dense growth,
   a 1x1 bottleneck, relu and a residual), two rounds of one shared
   feature-fusion module (the CrossPath: gated channel projections, a
   linear cross-attention from the seg feature to both branches and one
   from each branch to the seg feature, end projections and residual
   LayerNorms) against 1x1 projections of the MiT stage-1 and stage-2
   taps, a DRDB per branch between the rounds, and a three-conv tail to
   the fused Y. One PReLU slope is shared by every activation.
 - SegFormer (Xie et al., arXiv 2105.15203): overlapping patch embeddings,
   blocks of spatially-reduced attention and Mix-FFN (exact GELU), the
   decode head's per-stage projections, bilinear upsampling, a 1x1 fuse
   conv with BatchNorm (running statistics) and ReLU, and a 1x1 classifier.

The weights are a state dict under the names of the reference PyTorch
checkpoints (``fusion.DRDB1.Dcov1.weight``,
``seg.denoise_net.encoder.block1.0.attn.q.weight``, ...);
``param_spec`` lists them, with shapes and initialisers, from a
configuration file's sizes.

Every product reads its operands, and writes its result, through
``self.rnd`` (``precision``): identity for the reference, a rounding for
the control. Tensors are NHWC at the surface, as the configuration's
images are.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .precision import held_in, rounder

ENC = "seg.denoise_net.encoder."
DEC = "seg.denoise_net.decoder."
FUS = "fusion."
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
RGB2Y = (0.299, 0.587, 0.114)
YCRCB2RGB = ((1.0, 1.0, 1.0), (1.403, -0.714, 0.0), (0.0, -0.344, 1.773))

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _conv_spec(spec: Spec, name: str, cout: int, cin: int, k: int,
               bias: bool = True, groups: int = 1) -> None:
    """Torch's default layer scale (the fusion net, as SegMiF builds it);
    the seg network's convs as SegFormer initialises them,
    normal(0, sqrt(2 / fan_out)) with fan_out = k * k * cout / groups, and
    zero biases."""
    fan_in = cin // groups * k * k
    if name.startswith("seg."):
        std = math.sqrt(2.0 / (k * k * cout // groups))
        spec.append((name + ".weight", (cout, cin // groups, k, k),
                     f"normal:{std!r}"))
        if bias:
            spec.append((name + ".bias", (cout,), "zeros"))
        return
    spec.append((name + ".weight", (cout, cin // groups, k, k),
                 f"uniform:{fan_in}"))
    if bias:
        spec.append((name + ".bias", (cout,), f"uniform:{fan_in}"))


def _linear_spec(spec: Spec, name: str, cout: int, cin: int,
                 bias: bool = True) -> None:
    """As ``_conv_spec``; the seg network's linear layers as SegFormer
    initialises them, truncated normal(0, 0.02) and zero biases."""
    if name.startswith("seg."):
        spec.append((name + ".weight", (cout, cin), "trunc_normal:0.02"))
        if bias:
            spec.append((name + ".bias", (cout,), "zeros"))
        return
    spec.append((name + ".weight", (cout, cin), f"uniform:{cin}"))
    if bias:
        spec.append((name + ".bias", (cout,), f"uniform:{cin}"))


def _norm_spec(spec: Spec, name: str, c: int) -> None:
    spec.append((name + ".weight", (c,), "ones"))
    spec.append((name + ".bias", (c,), "zeros"))


def param_spec(cfg: Dict) -> Spec:
    """(name, shape, initialiser) of every state-dict entry of the joint
    pipeline of configuration ``cfg``. Initialisers: ``uniform:<fan_in>``
    (U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default layer init: the
    fusion net), ``trunc_normal:<std>`` (normal truncated at 2 std) and
    ``normal:<std>`` (SegFormer's initialisation of the seg network),
    ``ones``, ``zeros``, ``prelu`` (0.25), ``count`` (an int64 zero)."""
    spec: Spec = []
    dims, cin = cfg["embed_dims"], 3
    for i in range(4):
        e, sr, hid = dims[i], cfg["sr_ratios"][i], dims[i] * cfg["mlp_ratio"]
        pe = f"{ENC}patch_embed{i + 1}"
        _conv_spec(spec, pe + ".proj", e, cin, cfg["patch_sizes"][i])
        _norm_spec(spec, pe + ".norm", e)
        for j in range(cfg["depths"][i]):
            b = f"{ENC}block{i + 1}.{j}"
            _norm_spec(spec, b + ".norm1", e)
            _linear_spec(spec, b + ".attn.q", e, e)
            _linear_spec(spec, b + ".attn.kv", 2 * e, e)
            _linear_spec(spec, b + ".attn.proj", e, e)
            if sr > 1:
                _conv_spec(spec, b + ".attn.sr", e, e, sr)
                _norm_spec(spec, b + ".attn.norm", e)
            _norm_spec(spec, b + ".norm2", e)
            _linear_spec(spec, b + ".mlp.fc1", hid, e)
            _conv_spec(spec, b + ".mlp.dwconv.dwconv", hid, hid, 3,
                       groups=hid)
            _linear_spec(spec, b + ".mlp.fc2", e, hid)
        _norm_spec(spec, f"{ENC}norm{i + 1}", e)
        cin = e
    emb, ncls = cfg["decoder_dim"], cfg["num_classes"]
    for i in range(4):
        _linear_spec(spec, f"{DEC}linear_c{i + 1}.proj", emb, dims[i])
    _conv_spec(spec, DEC + "linear_fuse.conv", emb, 4 * emb, 1, bias=False)
    _norm_spec(spec, DEC + "linear_fuse.bn", emb)
    spec += [(DEC + "linear_fuse.bn.running_mean", (emb,), "zeros"),
             (DEC + "linear_fuse.bn.running_var", (emb,), "ones"),
             (DEC + "linear_fuse.bn.num_batches_tracked", (), "count")]
    _conv_spec(spec, DEC + "linear_pred", ncls, emb, 1)
    _conv_spec(spec, "seg.denoise_net.classifier", ncls, dims[3], 1,
               bias=False)
    ch, g = cfg["fusion_channels"], cfg["growth"]
    _conv_spec(spec, FUS + "conv1_ir", ch, 1, 3)
    _conv_spec(spec, FUS + "conv1_vis", ch, 1, 3)
    for d in range(1, cfg["drdbs"] + 1):
        for i in range(5):
            _conv_spec(spec, f"{FUS}DRDB{d}.Dcov{i + 1}", g, ch + i * g, 3)
        _conv_spec(spec, f"{FUS}DRDB{d}.conv", ch, ch + 5 * g, 1)
    _conv_spec(spec, FUS + "conv3", ch, dims[0], 1)
    _conv_spec(spec, FUS + "conv4", ch, dims[1], 1)
    cp = FUS + "ffm.cross."
    for i in (1, 2, 3):
        _linear_spec(spec, f"{cp}channel_proj{i}", 2 * ch, ch)
    _linear_spec(spec, cp + "cross_attn.kv3", 2 * ch, ch, bias=False)
    _linear_spec(spec, cp + "cross_attn2.kv1", 2 * ch, ch, bias=False)
    _linear_spec(spec, cp + "cross_attn2.kv2", 2 * ch, ch, bias=False)
    _linear_spec(spec, cp + "end_proj1", ch, 2 * ch)
    _linear_spec(spec, cp + "end_proj2", ch, 2 * ch)
    _norm_spec(spec, cp + "norm1", ch)
    _norm_spec(spec, cp + "norm2", ch)
    _conv_spec(spec, FUS + "conv2", ch, 2 * ch, 3)
    _conv_spec(spec, FUS + "conv21", ch // 2, ch, 3)
    _conv_spec(spec, FUS + "conv22", 1, ch // 2, 3)
    spec.append((FUS + "relu.weight", (1,), "prelu"))
    return spec


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of NHWC x, half-pixel centres, no antialiasing."""
    return nhwc(F.interpolate(nchw(x), size=tuple(size), mode="bilinear",
                              align_corners=False))


def rgb_to_ycrcb(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = RGB2Y[0] * r + RGB2Y[1] * g + RGB2Y[2] * b
    return torch.stack([y, (r - y) * 0.713 + 0.5, (b - y) * 0.564 + 0.5],
                       dim=-1)


def ycrcb_to_rgb(ycrcb: torch.Tensor) -> torch.Tensor:
    m = torch.tensor(YCRCB2RGB, dtype=ycrcb.dtype, device=ycrcb.device)
    bias = torch.tensor((0.0, -0.5, -0.5), dtype=ycrcb.dtype,
                        device=ycrcb.device)
    return (ycrcb + bias) @ m


class Reference:
    """The joint pipeline of configuration ``cfg`` over the state dict
    ``sd`` (float32 tensors on one device). ``precision``: the operands of
    every product as ``precision.rounder`` rounds them ("float32": none).
    A tensor of ``sd`` that requires grad is trained through."""

    def __init__(self, cfg: Dict, sd: Dict[str, torch.Tensor],
                 precision: str = "float32"):
        self.cfg = cfg
        self.sd = sd
        self.rnd = rounder(precision)
        self.held = lambda: held_in(precision)   # noqa: E731

    # ---------------------------------------------------------- products
    def conv(self, x, name, stride=1, padding=0, dilation=1, groups=1,
             bias=True):
        w = self.sd[name + ".weight"]
        b = self.sd[name + ".bias"] if bias else None
        return self.rnd(F.conv2d(self.rnd(x), self.rnd(w), b, stride,
                                 padding, dilation, groups))

    def linear(self, x, name, bias=True):
        b = self.sd[name + ".bias"] if bias else None
        return self.rnd(F.linear(self.rnd(x), self.rnd(self.sd[name + ".weight"]),
                                 b))

    def layer_norm(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.sd[name + ".weight"],
                            self.sd[name + ".bias"], eps)

    # --------------------------------------------------------------- MiT
    def attention(self, x, name, h, w, heads, sr):
        b, n, c = x.shape
        d = c // heads
        xs = x
        if sr > 1:
            g = self.conv(nchw(x.reshape(b, h, w, c)), name + ".sr",
                          stride=sr)
            xs = self.layer_norm(nhwc(g).reshape(b, -1, c), name + ".norm",
                                 1e-5)
        q = self.linear(x, name + ".q").reshape(b, n, heads, d)
        kv = self.linear(xs, name + ".kv")
        k = kv[..., :c].reshape(b, -1, heads, d)
        v = kv[..., c:].reshape(b, -1, heads, d)
        logits = torch.einsum("bnhd,bmhd->bhnm", self.rnd(q), self.rnd(k))
        probs = torch.softmax(logits * d ** -0.5, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", self.rnd(probs), self.rnd(v))
        return self.linear(self.rnd(out).reshape(b, n, c), name + ".proj")

    def mix_ffn(self, x, name, h, w):
        b, n, _ = x.shape
        y = self.linear(x, name + ".fc1")
        c = y.shape[-1]
        y = self.conv(nchw(y.reshape(b, h, w, c)), name + ".dwconv.dwconv",
                      padding=1, groups=c)
        y = F.gelu(nhwc(y).reshape(b, n, c), approximate="none")
        return self.linear(y, name + ".fc2")

    def encoder(self, x: torch.Tensor, stages: int = 4) -> List[torch.Tensor]:
        """NHWC image -> the first ``stages`` stage maps (NHWC)."""
        cfg, outs = self.cfg, []
        for i in range(stages):
            k = cfg["patch_sizes"][i]
            y = self.conv(nchw(x), f"{ENC}patch_embed{i + 1}.proj",
                          stride=cfg["strides"][i], padding=k // 2)
            b, c, h, w = y.shape
            t = self.layer_norm(nhwc(y).reshape(b, h * w, c),
                                f"{ENC}patch_embed{i + 1}.norm", 1e-5)
            for j in range(cfg["depths"][i]):
                blk = f"{ENC}block{i + 1}.{j}"
                t = t + self.attention(
                    self.layer_norm(t, blk + ".norm1", 1e-6), blk + ".attn",
                    h, w, cfg["num_heads"][i], cfg["sr_ratios"][i])
                t = t + self.mix_ffn(self.layer_norm(t, blk + ".norm2", 1e-6),
                                     blk + ".mlp", h, w)
            t = self.layer_norm(t, f"{ENC}norm{i + 1}", 1e-6)
            x = t.reshape(b, h, w, c)
            outs.append(x)
        return outs

    def head(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """SegFormer's decode head: logits at stage 1's resolution, NHWC."""
        size = feats[0].shape[1:3]
        proj = []
        for i in (4, 3, 2, 1):
            p = self.linear(feats[i - 1], f"{DEC}linear_c{i}.proj")
            if p.shape[1:3] != size:
                p = resize(p, size)
            proj.append(p)
        x = self.conv(nchw(torch.cat(proj, dim=-1)), DEC + "linear_fuse.conv",
                      bias=False)
        bn = DEC + "linear_fuse.bn"
        x = F.batch_norm(x, self.sd[bn + ".running_mean"],
                         self.sd[bn + ".running_var"], self.sd[bn + ".weight"],
                         self.sd[bn + ".bias"], training=False, eps=1e-5)
        return nhwc(self.conv(torch.relu(x), DEC + "linear_pred"))

    def seg_logits(self, rgb01: torch.Tensor) -> torch.Tensor:
        """[0, 1] RGB -> ImageNet normalisation -> MiT -> head: logits at
        1/4 resolution."""
        mean = rgb01.new_tensor(IMAGENET_MEAN)
        std = rgb01.new_tensor(IMAGENET_STD)
        return self.head(self.encoder((rgb01 * 255.0 - mean) / std))

    def taps(self, rgb01: torch.Tensor):
        """The guide's stage-1 and stage-2 maps, from the raw [0, 1] image
        (SegMiF feeds its fusion net's taps unnormalised)."""
        f = self.encoder(rgb01, stages=2)
        return f[0], f[1]

    # ------------------------------------------------------------ fusion
    def prelu(self, x):
        return F.prelu(x, self.sd[FUS + "relu.weight"])

    def drdb(self, x: torch.Tensor, name: str) -> torch.Tensor:
        feat = x
        for i in range(5):
            y = torch.relu(self.conv(feat, f"{name}.Dcov{i + 1}", padding=2,
                                     dilation=2))
            feat = torch.cat([feat, y], dim=1)
        return x + torch.relu(self.conv(feat, name + ".conv"))

    def cross_ctx(self, q, k, v, heads):
        """Per-head linear cross-attention of [B, N, C] tokens: the context
        softmax(k_h^T v_h / sqrt(d)) over k's feature, applied as q_h ctx_h.
        q may have another length than k and v."""
        b, n, c = q.shape
        d = c // heads
        kh = k.reshape(b, -1, heads, d)
        vh = v.reshape(b, -1, heads, d)
        ctx = torch.einsum("bnhi,bnhj->bhij", self.rnd(kh), self.rnd(vh))
        ctx = torch.softmax(ctx * d ** -0.5, dim=-2)
        out = torch.einsum("bnhi,bhij->bnhj",
                           self.rnd(q.reshape(b, n, heads, d)),
                           self.rnd(ctx))
        return self.rnd(out).reshape(b, n, c)

    def crosspath(self, x1, x2, s):
        """SegMiF's FFM on [B, N, C] tokens of both branches and the seg
        feature."""
        cp, heads = FUS + "ffm.cross.", self.cfg["ffm_heads"]
        c = x1.shape[-1]
        y1, u1 = torch.relu(self.linear(x1, cp + "channel_proj1")).chunk(2, -1)
        y2, u2 = torch.relu(self.linear(x2, cp + "channel_proj2")).chunk(2, -1)
        y3, u3 = torch.relu(self.linear(s, cp + "channel_proj3")).chunk(2, -1)
        kv = self.linear(u3, cp + "cross_attn.kv3", bias=False)
        v1 = self.cross_ctx(u1, kv[..., :c], kv[..., c:], heads)
        v2 = self.cross_ctx(u2, kv[..., :c], kv[..., c:], heads)
        kv = self.linear(y1, cp + "cross_attn2.kv1", bias=False)
        z1 = self.cross_ctx(y3, kv[..., :c], kv[..., c:], heads)
        kv = self.linear(y2, cp + "cross_attn2.kv2", bias=False)
        z2 = self.cross_ctx(y3, kv[..., :c], kv[..., c:], heads)
        o1 = self.layer_norm(
            x1 + self.linear(torch.cat([z1, v1], -1), cp + "end_proj1"),
            cp + "norm1", 1e-5)
        o2 = self.layer_norm(
            x2 + self.linear(torch.cat([z2, v2], -1), cp + "end_proj2"),
            cp + "norm2", 1e-5)
        return o1, o2

    def ffm(self, x1, x2, tap, proj):
        """One round: the tap projected (1x1) at its own resolution and
        upsampled to the trunk's, then the FFM over the pixels as tokens.
        NCHW in and out."""
        b, c, h, w = x1.shape
        s = self.conv(nchw(tap), proj)
        if s.shape[2:] != (h, w):
            s = nchw(resize(nhwc(s), (h, w)))

        def tokens(t):
            return nhwc(t).reshape(b, h * w, c)

        o1, o2 = self.crosspath(tokens(x1), tokens(x2), tokens(s))
        return (nchw(o1.reshape(b, h, w, c)), nchw(o2.reshape(b, h, w, c)))

    def fusion(self, ir, vis_y, tap1, tap2) -> torch.Tensor:
        """ir, vis_y [B, H, W, 1], the taps NHWC -> fused Y [B, H, W, 1]."""
        x1 = self.drdb(self.prelu(self.conv(nchw(ir), FUS + "conv1_ir",
                                            padding=1)), FUS + "DRDB1")
        x2 = self.drdb(self.prelu(self.conv(nchw(vis_y), FUS + "conv1_vis",
                                            padding=1)), FUS + "DRDB2")
        x1, x2 = self.ffm(x1, x2, tap1, FUS + "conv3")
        x1 = self.drdb(x1, FUS + "DRDB3")
        x2 = self.drdb(x2, FUS + "DRDB4")
        x1, x2 = self.ffm(x1, x2, tap2, FUS + "conv4")
        y = self.prelu(self.conv(torch.cat([x1, x2], 1), FUS + "conv2",
                                 padding=1))
        y = self.prelu(self.conv(y, FUS + "conv21", padding=1))
        y = self.prelu(self.conv(y, FUS + "conv22", padding=1))
        return nhwc(y)

    # ---------------------------------------------------------- pipeline
    def serve(self, ir, vis) -> Tuple[torch.Tensor, torch.Tensor]:
        """What a served pair gets: the guide is the VIS frame; its R plane
        enters the VIS branch; the fused Y replaces the VIS frame's Y and
        the result, clipped to [0, 1], is segmented. Returns (fused RGB,
        class logits upsampled to the image size)."""
        with self.held():
            return self._serve(ir, vis)

    def _serve(self, ir, vis):
        tap1, tap2 = self.taps(vis)
        vis_ycrcb = rgb_to_ycrcb(vis)
        fused_y = self.fusion(ir[..., 0:1], vis[..., 0:1], tap1, tap2)
        fused = ycrcb_to_rgb(torch.cat([fused_y, vis_ycrcb[..., 1:]], -1))
        fused = fused.clamp(0.0, 1.0)
        logits = resize(self.seg_logits(fused), ir.shape[1:3])
        return fused, logits


def widest_gap(logits: torch.Tensor, classes: torch.Tensor) -> float:
    """The widest gap, over the pixels, by which the logit of the class
    given at a pixel lies below the best logit there. logits [..., C];
    classes [...] int."""
    best = logits.max(dim=-1).values
    got = logits.gather(-1, classes.long().unsqueeze(-1)).squeeze(-1)
    return float((best - got).max())


