"""The folded CrossPath (feature-fusion module), counterpart of
``segmif_tpu/kernels/pallas_ffm.py``.

Interaction 'both', no token weight or gram slice. Inputs x1, x2 (the two
fusion branches) and s (the projected seg tap) are [B, ..., C] with
C = 64; the weight dict ``w`` has the JAX layout ([in, out] kernels):
wp1..3 [C, 2C], bp1..3 [2C], wkv1..3 [C, 2C], we1..2 [2C, C], be1..2 [C],
ln1/2_scale and _bias [C].

 - ``crosspath_folded_ref``: the plain folded maths (``crosspath_folded_xla``).
 - ``crosspath_grams`` / ``crosspath_apply_rows``: pass A and pass B,
   the operators ``segmif::ffm_grams`` and ``segmif::ffm_apply``: CUDA
   kernels in ``csrc/ffm.cu`` on CUDA tensors (replacing ``_grams_pallas``
   and ``_apply_pallas``), their plain versions on CPU tensors.
 - ``crosspath_fused``: grams -> per-head contexts and end-projection fold
   (tiny [B, C, C] matrices, plain torch) -> apply. Under autograd the
   whole of it sits in one ``autograd.Function`` whose backward is the VJP
   of ``crosspath_folded_ref`` with respect to x1, x2, s and every weight,
   recomputed in plain PyTorch (the JAX ``custom_vjp`` of
   ``pallas_ffm.py``: ``_bwd`` recomputes ``crosspath_folded_xla``). The
   Function takes the weights as ``w`` holds them (the module's
   ``.t()`` views), so their gradients reach the ``nn.Linear`` and
   ``nn.LayerNorm`` leaves. The two passes called alone are forward-only.
 - ``crosspath_apply``: CPU tensors take the plain folded maths, CUDA
   tensors the two kernels.

Pass A returns only the three 64x64 gram blocks the contexts read
(y1^T y1, y2^T y2, u3^T u3, where r_i = relu(x_i Wp_i + bp_i) = [y_i, u_i]);
pass B takes the four folded context matrices unpadded, [B, 4, C, C]:
M0 applies to y3 and M1 to u1 (output 1), M2 to y3 and M3 to u2 (output 2).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from . import _build
from .attention import linear_ctx_blockdiag_from_gram

LN_EPS = 1e-5
_TILE = 64


def _layer_norm(t: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor) -> torch.Tensor:
    """f32 LayerNorm over the last dim with the E[t^2] - mu^2 variance the
    TPU kernels use."""
    mu = t.mean(-1, keepdim=True)
    var = ((t * t).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (t - mu) * torch.rsqrt(var + LN_EPS) * gamma + beta


def _relu_proj(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """relu(x w + b) in f32 (f64 for f64 x), rounded to x's dtype,
    returned in the arithmetic type."""
    acc = _build.acc_dtype(x.dtype)
    return torch.relu(x.to(acc) @ w + b).to(x.dtype).to(acc)


def crosspath_folded_ref(x1: torch.Tensor, x2: torch.Tensor,
                         s: torch.Tensor, w: Dict, scale: float,
                         num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain folded CrossPath; any leading layout [B, ..., C]. The grams
    are [2C, 2C] blocks of the full r_i gram and the contexts apply as
    K = 2C products against zero-padded [2C, C] folded matrices, as in
    ``crosspath_folded_xla``. Arithmetic in f32 (f64 for f64 inputs);
    outputs in x1's dtype."""
    dim = x1.shape[-1]
    dt = x1.dtype
    acc = _build.acc_dtype(dt)
    b = x1.shape[0]

    def proj(x, i):
        return _relu_proj(x, w[f"wp{i}"].to(dt).to(acc),
                          w[f"bp{i}"].to(dt).to(acc))

    r1, r2, r3 = proj(x1, 1), proj(x2, 2), proj(s, 3)

    def gram(r):
        t = r.reshape(b, -1, r.shape[-1])
        return t.transpose(1, 2) @ t

    g1, g2, g3 = gram(r1), gram(r2), gram(r3)
    bd_s = linear_ctx_blockdiag_from_gram(g3[:, dim:, dim:], w["wkv3"],
                                          scale, num_heads)
    bd_1 = linear_ctx_blockdiag_from_gram(g1[:, :dim, :dim], w["wkv1"],
                                          scale, num_heads)
    bd_2 = linear_ctx_blockdiag_from_gram(g2[:, :dim, :dim], w["wkv2"],
                                          scale, num_heads)
    z = torch.zeros_like(bd_s)

    def fold(bd, we_half, top):
        m = (bd @ we_half.to(acc)).to(dt).to(acc)
        return torch.cat([m, z] if top else [z, m], dim=-2)

    def apply(r, m):   # [B, ..., 2C] x [B, 2C, C]
        return (r.reshape(b, -1, r.shape[-1]) @ m).reshape(
            r.shape[:-1] + (m.shape[-1],))

    o1 = (apply(r3, fold(bd_1, w["we1"][:dim], True))
          + apply(r1, fold(bd_s, w["we1"][dim:], False)) + w["be1"].to(acc))
    o2 = (apply(r3, fold(bd_2, w["we2"][:dim], True))
          + apply(r2, fold(bd_s, w["we2"][dim:], False)) + w["be2"].to(acc))
    out1 = _layer_norm(x1.to(acc) + o1, w["ln1_scale"].to(acc),
                       w["ln1_bias"].to(acc))
    out2 = _layer_norm(x2.to(acc) + o2, w["ln2_scale"].to(acc),
                       w["ln2_bias"].to(acc))
    return out1.to(dt), out2.to(dt)


# ------------------------------------------------------------ half weights

def _halves(wp: torch.Tensor, bp: torch.Tensor, dt: torch.dtype, picks):
    """wp [3, C, 2C], bp [3, 2C] -> the 64-wide projections named by
    ``picks`` ((projection, half) pairs; half 0 is y, the first C columns,
    half 1 is u) as ([3, C, C], [3, C]) f32, rounded to dt first."""
    c = wp.shape[1]
    w = torch.stack([wp[i, :, h * c:(h + 1) * c] for i, h in picks])
    b = torch.stack([bp[i, h * c:(h + 1) * c] for i, h in picks])
    return w.to(dt).float().contiguous(), b.to(dt).float().contiguous()


_GRAM_PICKS = ((0, 0), (1, 0), (2, 1))    # y1, y2, u3
_APPLY_PICKS = ((2, 0), (0, 1), (1, 1))   # y3, u1, u2


# ------------------------------------------------------------------ pass A

def _grams_plain(x1, x2, s, w, b) -> torch.Tensor:
    """Plain pass A on the kernel's operands: w [3, C, C] and b [3, C],
    the picked halves (``_halves``)."""
    out = []
    for i, x in enumerate((x1, x2, s)):
        r = _relu_proj(x, w[i], b[i])
        out.append(r.transpose(1, 2) @ r)
    return torch.stack(out, 1)


def crosspath_grams_ref(x1, x2, s, wp, bp) -> torch.Tensor:
    """Plain pass A. x_i [B, N, C]; wp [3, C, 2C]; bp [3, 2C] ->
    [B, 3, C, C] f32: y1^T y1, y2^T y2, u3^T u3."""
    return _grams_plain(x1, x2, s, *_halves(wp, bp, x1.dtype, _GRAM_PICKS))


def _check_tokens(name: str, *ts: torch.Tensor) -> None:
    x = ts[0]
    if x.dim() != 3 or x.shape[-1] != 64:
        raise ValueError(f"{name}: tokens must be [B, N, 64], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype}; the kernel takes f32 "
                         "or bf16")
    for t in ts:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: inputs differ in shape, dtype or "
                             "device")
        if not t.is_contiguous():
            raise ValueError(_aligned(name))


def _check_aligned(name: str, *ts: torch.Tensor) -> None:
    """The tokens' addresses, read where the kernel launches."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(_aligned(name))


def _aligned(name: str) -> str:
    return f"{name}: inputs must be contiguous and 16-byte aligned"


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _grams_chunk(n: int, bsz: int, device: torch.device) -> int:
    """Tokens per block of pass A, a multiple of 64: each image's tokens
    split so that the grid is about four waves of SMs. Either dtype has
    one block per (image, chunk, projection) and one block per SM (by
    registers)."""
    tiles = math.ceil(n / _TILE)
    per_image = max(1, min(tiles, math.ceil(4 * _sm_count(device) /
                                            (3 * bsz))))
    return math.ceil(tiles / per_image) * _TILE


def crosspath_grams(x1, x2, s, wp, bp) -> torch.Tensor:
    """Pass A: [B, 3, C, C] f32 grams, through the operator
    ``segmif::ffm_grams`` (``ffm_grams_op``). CPU tensors take the plain
    version (through autograd when a gradient is needed); CUDA tensors
    launch ``segmif_ffm_grams``: per-(image, token-chunk, projection)
    partial grams on the tensor cores (bf16 products, or f32 as 3xTF32:
    each operand split into two TF32 halves, each product big*big +
    big*small + small*big), then an in-order sum over the chunks."""
    if x1.device.type == "cpu" and _build.needs_grad(x1, x2, s, wp, bp):
        return crosspath_grams_ref(x1, x2, s, wp, bp)
    if x1.is_cuda:
        _build.refuse_grad(x1, x2, s, wp, bp, instead="crosspath_fused")
        _check_tokens("crosspath_grams", x1, x2, s)
    w, b = _halves(wp.to(x1.device), bp.to(x1.device), x1.dtype,
                  _GRAM_PICKS)
    return torch.ops.segmif.ffm_grams(x1, x2, s, w, b)


@torch.library.custom_op("segmif::ffm_grams", mutates_args=(),
                         device_types="cuda")
def ffm_grams_op(x1: torch.Tensor, x2: torch.Tensor, s: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of ``segmif_ffm_grams`` on the current stream; the
    partial grams and the output are allocated here."""
    _check_aligned("crosspath_grams", x1, x2, s)
    bsz, n, c = x1.shape
    chunk = _grams_chunk(n, bsz, x1.device)
    n_chunks = math.ceil(n / chunk)
    partial = torch.empty((bsz, n_chunks, 3, c, c), dtype=torch.float32,
                          device=x1.device)
    out = torch.empty((bsz, 3, c, c), dtype=torch.float32, device=x1.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    with torch.cuda.device(x1.device):
        err = lib.segmif_ffm_grams(
            x1.data_ptr(), x2.data_ptr(), s.data_ptr(), w.data_ptr(),
            b.data_ptr(), partial.data_ptr(), out.data_ptr(), bsz, n, chunk,
            n_chunks, _build.DTYPE_CODES[x1.dtype], stream)
    _build.check(err, "crosspath_grams")
    crosspath_grams.launches += 1
    return out


@ffm_grams_op.register_kernel("cpu")
def _ffm_grams_cpu(x1, x2, s, w, b):
    return _grams_plain(x1, x2, s, w, b)


@ffm_grams_op.register_fake
def _ffm_grams_fake(x1, x2, s, w, b):
    c = x1.shape[-1]
    return x1.new_empty((x1.shape[0], 3, c, c), dtype=torch.float32)


crosspath_grams.launches = 0


# ------------------------------------------------------------------ pass B

def _apply_plain(x1, x2, s, w, b, mats, be, lnp):
    """Plain pass B on the kernel's operands: w [3, C, C] and b [3, C],
    the picked halves (w and mats rounded to the inputs' type)."""
    dt = x1.dtype
    w = w.float()
    y3 = _relu_proj(s, w[0], b[0])
    u1 = _relu_proj(x1, w[1], b[1])
    u2 = _relu_proj(x2, w[2], b[2])
    m = mats.to(dt).float()
    be = be.float()
    lnp = lnp.float()
    o1 = y3 @ m[:, 0] + u1 @ m[:, 1] + be[0]
    o2 = y3 @ m[:, 2] + u2 @ m[:, 3] + be[1]
    out1 = _layer_norm(x1.float() + o1, lnp[0, 0], lnp[0, 1])
    out2 = _layer_norm(x2.float() + o2, lnp[1, 0], lnp[1, 1])
    return out1.to(dt), out2.to(dt)


def crosspath_apply_rows_ref(x1, x2, s, wp, bp, mats, be, lnp):
    """Plain pass B. mats [B, 4, C, C]; be [2, C]; lnp [2, 2, C]
    (LayerNorm (scale, bias) per output) -> (o1, o2) [B, N, C]."""
    w, b = _halves(wp, bp, x1.dtype, _APPLY_PICKS)
    return _apply_plain(x1, x2, s, w, b, mats, be, lnp)


def _apply_chunk(n: int, bsz: int, device: torch.device) -> int:
    """Tokens per block of pass B, a multiple of 64. One 8-warp block per
    SM in either dtype (by shared memory): each image's tokens split so
    that the grid is four whole waves of SMs, or as near as the tiles
    allow."""
    tiles = math.ceil(n / _TILE)
    per_image = min(tiles, math.ceil(4 * _sm_count(device) / bsz))
    return math.ceil(tiles / per_image) * _TILE


def crosspath_apply_rows(x1, x2, s, wp, bp, mats, be, lnp):
    """Pass B, through the operator ``segmif::ffm_apply``
    (``ffm_apply_op``). CPU tensors take the plain version (through
    autograd when a gradient is needed); CUDA tensors launch
    ``segmif_ffm_apply``: the seven products on the tensor cores, chained
    in registers, in bf16 (weights and contexts as bf16) or in f32 as
    3xTF32 (each f32 operand split into two TF32 halves, each product
    big*big + big*small + small*big)."""
    args = (x1, x2, s, wp, bp, mats, be, lnp)
    if x1.device.type == "cpu" and _build.needs_grad(*args):
        return crosspath_apply_rows_ref(*args)
    bsz, n, c = x1.shape
    if x1.is_cuda:
        _build.refuse_grad(*args, instead="crosspath_fused")
        _check_tokens("crosspath_apply_rows", x1, x2, s)
        if mats.shape != (bsz, 4, c, c) or be.shape != (2, c) or \
                lnp.shape != (2, 2, c):
            raise ValueError("crosspath_apply_rows: mats/be/lnp shapes "
                             f"{tuple(mats.shape)} {tuple(be.shape)} "
                             f"{tuple(lnp.shape)}")
    dev, dt = x1.device, x1.dtype
    # w and mats rounded to the input type (exact in it), as the plain
    # version rounds them; the kernel reads them in that type
    w, b = _halves(wp.to(dev), bp.to(dev), dt, _APPLY_PICKS)
    w = w.to(dt)
    m = mats.to(dev).to(dt).contiguous()
    be = be.to(dev).float().contiguous()
    lnp = lnp.to(dev).float().contiguous()
    o1, o2 = torch.ops.segmif.ffm_apply(x1, x2, s, w, b, m, be, lnp)
    return o1, o2


@torch.library.custom_op("segmif::ffm_apply", mutates_args=(),
                         device_types="cuda")
def ffm_apply_op(x1: torch.Tensor, x2: torch.Tensor, s: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, mats: torch.Tensor,
                 be: torch.Tensor, lnp: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``segmif_ffm_apply`` on the current stream; the
    outputs are allocated here."""
    _check_aligned("crosspath_apply_rows", x1, x2, s)
    bsz, n, _ = x1.shape
    dev, dt = x1.device, x1.dtype
    o1 = torch.empty(x1.shape, dtype=dt, device=dev)
    o2 = torch.empty(x2.shape, dtype=dt, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.segmif_ffm_apply(
            x1.data_ptr(), x2.data_ptr(), s.data_ptr(), w.data_ptr(),
            b.data_ptr(), mats.data_ptr(), be.data_ptr(), lnp.data_ptr(),
            o1.data_ptr(), o2.data_ptr(), bsz, n,
            _apply_chunk(n, bsz, dev), _build.DTYPE_CODES[dt], stream)
    _build.check(err, "crosspath_apply_rows")
    crosspath_apply_rows.launches += 1
    return o1, o2


@ffm_apply_op.register_kernel("cpu")
def _ffm_apply_cpu(x1, x2, s, w, b, mats, be, lnp):
    o1, o2 = _apply_plain(x1, x2, s, w, b, mats, be, lnp)
    return o1.contiguous(), o2.contiguous()


@ffm_apply_op.register_fake
def _ffm_apply_fake(x1, x2, s, w, b, mats, be, lnp):
    return x1.new_empty(x1.shape), x2.new_empty(x2.shape)


crosspath_apply_rows.launches = 0


# --------------------------------------------------------------- assembled

# the weights the Function takes, in this order
W_KEYS = ("wp1", "bp1", "wp2", "bp2", "wp3", "bp3", "wkv1", "wkv2", "wkv3",
          "we1", "be1", "we2", "be2", "ln1_scale", "ln1_bias", "ln2_scale",
          "ln2_bias")


def _crosspath_kernels(x1, x2, s, w: Dict, scale: float, num_heads: int,
                       reduce=None):
    """Pass A grams (kernel), the context/fold step, pass B (kernel).
    ``reduce`` maps the [B, 3, C, C] f32 grams of these tokens to the
    grams the contexts read: the row-sharded trunk
    (``parallel.spatial``) sums them over the ranks, so that every rank
    applies the whole image's contexts to its own tokens."""
    wp, bp = projections(w)
    grams = crosspath_grams(x1, x2, s, wp, bp)
    if reduce is not None:
        grams = reduce(grams)
    return crosspath_apply_rows(x1, x2, s, wp, bp,
                                *apply_args(grams, w, scale, num_heads))


def projections(w: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three channel projections as the kernels take them: wp [3, C,
    2C], bp [3, 2C]."""
    return (torch.stack([w["wp1"], w["wp2"], w["wp3"]]),
            torch.stack([w["bp1"], w["bp2"], w["bp3"]]))


def apply_args(grams: torch.Tensor, w: Dict, scale: float, num_heads: int):
    """Pass B's (mats, be, lnp) from pass A's [B, 3, C, C] grams: the
    contexts folded into the end projections, their biases, the two
    LayerNorms."""
    dim = grams.shape[-1]
    bd_1 = linear_ctx_blockdiag_from_gram(grams[:, 0], w["wkv1"], scale,
                                          num_heads)
    bd_2 = linear_ctx_blockdiag_from_gram(grams[:, 1], w["wkv2"], scale,
                                          num_heads)
    bd_s = linear_ctx_blockdiag_from_gram(grams[:, 2], w["wkv3"], scale,
                                          num_heads)
    we1, we2 = w["we1"].float(), w["we2"].float()
    mats = torch.stack([bd_1 @ we1[:dim], bd_s @ we1[dim:],
                        bd_2 @ we2[:dim], bd_s @ we2[dim:]], 1)
    be = torch.stack([w["be1"], w["be2"]]).float()
    lnp = torch.stack([torch.stack([w["ln1_scale"], w["ln1_bias"]]),
                       torch.stack([w["ln2_scale"], w["ln2_bias"]])]).float()
    return mats, be, lnp


class _CrossPathFn(torch.autograd.Function):
    """The two kernels' forward; the backward recomputes the plain folded
    CrossPath."""

    @staticmethod
    def forward(ctx, scale, num_heads, forward, x1, x2, s, *ws):
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.save_for_backward(x1, x2, s, *ws)
        return forward(x1, x2, s, dict(zip(W_KEYS, ws)), scale, num_heads)

    @staticmethod
    def backward(ctx, g1, g2):
        def plain(x1, x2, s, *ws):
            return crosspath_folded_ref(x1, x2, s, dict(zip(W_KEYS, ws)),
                                        ctx.scale, ctx.num_heads)

        return (None, None, None) + _build.plain_vjp(
            "bwd/crosspath", plain, ctx.saved_tensors,
            ctx.needs_input_grad[3:], (g1, g2))


def _crosspath_grad(x1, x2, s, w: Dict, scale: float, num_heads: int,
                    forward=None):
    """The fused CrossPath that carries a gradient. ``forward`` stands in
    for the kernels (a test passes the plain version to gradcheck the
    Function on the CPU); nothing on the main path sets it."""
    return _CrossPathFn.apply(scale, num_heads, forward or _crosspath_kernels,
                              x1, x2, s, *(w[k] for k in W_KEYS))


def crosspath_fused(x1, x2, s, w: Dict, scale: float, num_heads: int):
    """Two-pass CrossPath on [B, N, C] tokens: pass A grams, the tiny
    context/fold step in plain torch, pass B. When a gradient is needed it
    runs inside ``_CrossPathFn``."""
    if _build.needs_grad(x1, x2, s, *w.values()):
        return _crosspath_grad(x1, x2, s, w, scale, num_heads)
    return _crosspath_kernels(x1, x2, s, w, scale, num_heads)


def crosspath_apply(x1, x2, s, w: Dict, scale: float, num_heads: int):
    """CPU tensors: ``crosspath_folded_ref``. CUDA tensors: the two
    kernels (``crosspath_fused``); x1, x2, s must then be [B, N, 64]
    contiguous token views."""
    if x1.device.type == "cpu":
        return crosspath_folded_ref(x1, x2, s, w, scale, num_heads)
    return crosspath_fused(x1, x2, s, w, scale, num_heads)
