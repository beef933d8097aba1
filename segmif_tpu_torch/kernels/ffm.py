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
   of ``crosspath_folded_ref`` with respect to x1, x2, s and every weight.
   The Function takes the weights as ``w`` holds them (the module's
   ``.t()`` views), so their gradients reach the ``nn.Linear`` and
   ``nn.LayerNorm`` leaves. The two passes called alone are forward-only.
 - The backward (``crosspath_backward``): bf16 CUDA tokens with the
   kernels' contract take two more kernels (``csrc/ffm_bwd.cu``), the
   operators ``segmif::ffm_bwd_reduce`` (pass A': the context matrices'
   gradients and the per-channel sums, summed over the tokens) and
   ``segmif::ffm_bwd_rows`` (pass B': the tokens' gradients and the
   projections' sums), with the fold's gradient between them in plain
   torch on the forward's saved grams. Every other input (f32, f64, CPU)
   recomputes ``crosspath_folded_ref`` under autograd (the JAX
   ``custom_vjp`` of ``pallas_ffm.py``: ``_bwd`` recomputes
   ``crosspath_folded_xla``; it has no backward kernel).
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
from ..utils.profiler import span
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
    return _crosspath_passes(x1, x2, s, w, scale, num_heads, reduce)[:2]


def _crosspath_passes(x1, x2, s, w: Dict, scale: float, num_heads: int,
                      reduce=None):
    """``_crosspath_kernels``' (o1, o2) and the grams the contexts read."""
    wp, bp = projections(w)
    grams = crosspath_grams(x1, x2, s, wp, bp)
    if reduce is not None:
        grams = reduce(grams)
    o1, o2 = crosspath_apply_rows(x1, x2, s, wp, bp,
                                  *apply_args(grams, w, scale, num_heads))
    return o1, o2, grams


def projections(w: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three channel projections as the kernels take them: wp [3, C,
    2C], bp [3, 2C]."""
    return (torch.stack([w["wp1"], w["wp2"], w["wp3"]]),
            torch.stack([w["bp1"], w["bp2"], w["bp3"]]))


def fold_mats(grams: torch.Tensor, wkv1, wkv2, wkv3, we1, we2,
              scale: float, num_heads: int) -> torch.Tensor:
    """The four context matrices [B, 4, C, C] (M0-M3, in the grams' type)
    from pass A's [B, 3, C, C] grams: the per-head contexts folded into
    the end projections' halves, before their rounding to the tokens'
    type. The backward differentiates it on the forward's grams."""
    dim = grams.shape[-1]
    acc = _build.acc_dtype(grams.dtype)
    bd_1 = linear_ctx_blockdiag_from_gram(grams[:, 0], wkv1, scale,
                                          num_heads)
    bd_2 = linear_ctx_blockdiag_from_gram(grams[:, 1], wkv2, scale,
                                          num_heads)
    bd_s = linear_ctx_blockdiag_from_gram(grams[:, 2], wkv3, scale,
                                          num_heads)
    we1, we2 = we1.to(acc), we2.to(acc)
    return torch.stack([bd_1 @ we1[:dim], bd_s @ we1[dim:],
                        bd_2 @ we2[:dim], bd_s @ we2[dim:]], 1)


def apply_args(grams: torch.Tensor, w: Dict, scale: float, num_heads: int):
    """Pass B's (mats, be, lnp) from pass A's [B, 3, C, C] grams: the
    contexts folded into the end projections, their biases, the two
    LayerNorms."""
    mats = fold_mats(grams, w["wkv1"], w["wkv2"], w["wkv3"], w["we1"],
                     w["we2"], scale, num_heads)
    be = torch.stack([w["be1"], w["be2"]]).float()
    lnp = torch.stack([torch.stack([w["ln1_scale"], w["ln1_bias"]]),
                       torch.stack([w["ln2_scale"], w["ln2_bias"]])]).float()
    return mats, be, lnp


# ---------------------------------------------------------------- backward

_BWD_STEP = 128   # tokens a backward block takes a step (8 warps x 16)


def _bwd_chunk(n: int, bsz: int, parts: int, device: torch.device) -> int:
    """Tokens per block of a backward pass, a multiple of 128: on the card
    each image's tokens split so that the grid ((chunks, B, parts), one
    block per SM by shared memory) is about four waves of SMs; on the CPU
    one chunk an image."""
    steps = math.ceil(n / _BWD_STEP)
    if device.type != "cuda":
        return steps * _BWD_STEP
    per_image = max(1, min(steps, math.ceil(4 * _sm_count(device) /
                                            (parts * bsz))))
    return math.ceil(steps / per_image) * _BWD_STEP


def _ln_grad(t, g, gamma):
    """(dh, xhat): the gradient at ``_layer_norm``'s input t for the output
    cotangent g, and t normalised; the variance's clamp passes no gradient
    where it holds."""
    mu = t.mean(-1, keepdim=True)
    var = (t * t).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var.clamp_min(0.0) + LN_EPS)
    xhat = (t - mu) * rstd
    a = g * gamma
    dh = rstd * (a - a.mean(-1, keepdim=True) - xhat * (
        (a * xhat).mean(-1, keepdim=True) * (var >= 0)))
    return dh, xhat


def _chunks(n: int, chunk: int):
    return [slice(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]


def _bwd_reduce_plain(x1, x2, s, g1, g2, wp, bp, mats, be, lnp, chunk):
    """Plain pass A' on the kernel's operands (wp, mats in the tokens'
    type; bp, be, lnp in the arithmetic type): per chunk of each image's
    tokens the sums of ``ffm_bwd_reduce``, then the chunks summed in
    order. -> dM [B, 4, C, C] (y3^T dh1, u1^T dh1, y3^T dh2, u2^T dh2) and
    sums [B, 2, 3, C] (per output: sum(dh), sum(g xhat), sum(g))."""
    acc = _build.acc_dtype(x1.dtype)
    n, c = x1.shape[1:]
    wp, m = wp.to(acc), mats.to(acc)
    total = 0
    for sl in _chunks(n, chunk):
        y3 = _relu_proj(s[:, sl], wp[2, :, :c], bp[2, :c])
        outs = []
        for o, (x, g) in enumerate(((x1, g1), (x2, g2))):
            xo, go = x[:, sl].to(acc), g[:, sl].to(acc)
            u = _relu_proj(x[:, sl], wp[o, :, c:], bp[o, c:])
            dh, xhat = _ln_grad(
                xo + (y3 @ m[:, 2 * o] + u @ m[:, 2 * o + 1] + be[o]), go,
                lnp[o, 0])
            outs.append(torch.cat([
                (y3.transpose(1, 2) @ dh).flatten(1),
                (u.transpose(1, 2) @ dh).flatten(1),
                dh.sum(1), (go * xhat).sum(1), go.sum(1)], 1))
        total = total + torch.stack(outs, 1)
    return _reduce_outputs(total, c)


def _reduce_outputs(out: torch.Tensor, c: int):
    """[B, 2, 2 C C + 3 C] -> (dM [B, 4, C, C], sums [B, 2, 3, C])."""
    bsz, cc = out.shape[0], c * c
    return (out[..., :2 * cc].reshape(bsz, 4, c, c).contiguous(),
            out[..., 2 * cc:].reshape(bsz, 2, 3, c).contiguous())


def _relu_grad(dr, r, dt):
    """The gradient at a projection's pre-activation from dr, the one at
    its output r = relu(pre) rounded to dt: dr rounded to dt (the cast's
    gradient), then relu's mask."""
    return dr.to(dt).to(dr.dtype) * (r > 0)


def _bwd_rows_plain(x1, x2, s, g1, g2, wp, bp, mats, sym, be, lnp, chunk):
    """Plain pass B' on the kernel's operands (as ``_bwd_reduce_plain``;
    sym [B, 3, C, C] the grams' symmetrised gradients dG_i + dG_i^T) ->
    dx1, dx2, ds (the tokens' type), dWp [B, 3, C, 2C] and dbp [B, 3, 2C]
    (the arithmetic type) summed over each image's chunks in order."""
    dt = x1.dtype
    acc = _build.acc_dtype(dt)
    n, c = x1.shape[1:]
    wp, m = wp.to(acc), mats.to(acc)
    dxs = [torch.empty_like(x) for x in (x1, x2, s)]
    total = 0
    for sl in _chunks(n, chunk):
        xs = [x[:, sl] for x in (x1, x2, s)]
        r = [_relu_proj(x, wp[i], bp[i]) for i, x in enumerate(xs)]
        y3 = r[2][..., :c]
        dh = []
        for o, g in enumerate((g1, g2)):
            u = r[o][..., c:]
            dh.append(_ln_grad(xs[o].to(acc) + (
                y3 @ m[:, 2 * o] + u @ m[:, 2 * o + 1] + be[o]),
                g[:, sl].to(acc), lnp[o, 0])[0])
        dr = [torch.cat([r[o][..., :c] @ sym[:, o],
                         dh[o] @ m[:, 2 * o + 1].transpose(1, 2)], -1)
              for o in (0, 1)]
        dr.append(torch.cat([dh[0] @ m[:, 0].transpose(1, 2) +
                             dh[1] @ m[:, 2].transpose(1, 2),
                             r[2][..., c:] @ sym[:, 2]], -1))
        dpre = [_relu_grad(d, ri, dt) for d, ri in zip(dr, r)]
        for i, (x, p) in enumerate(zip(xs, dpre)):
            dx = (p @ wp[i].transpose(0, 1)).to(dt)
            dxs[i][:, sl] = dx + dh[i].to(dt) if i < 2 else dx
        total = total + torch.stack([torch.cat(
            [(x.to(acc).transpose(1, 2) @ p).flatten(1), p.sum(1)], 1)
            for x, p in zip(xs, dpre)], 1)
    return (*dxs, *_rows_outputs(total, c))


def _rows_outputs(out: torch.Tensor, c: int):
    """[B, 3, 2 C C + 2 C] -> (dWp [B, 3, C, 2C], dbp [B, 3, 2C])."""
    bsz, cc = out.shape[0], 2 * c * c
    return (out[..., :cc].reshape(bsz, 3, c, 2 * c).contiguous(),
            out[..., cc:].contiguous())


def _check_bwd(name: str, *ts: torch.Tensor) -> None:
    _check_tokens(name, *ts)
    if ts[0].dtype != torch.bfloat16:
        raise ValueError(f"{name}: dtype {ts[0].dtype}; the backward "
                         "kernels take bf16")


def _bwd_operands(x1, wp, bp, mats, be, lnp):
    """The passes' weights as the kernels read them: wp and mats in the
    tokens' type, bp rounded to it, in the arithmetic type with be and
    lnp."""
    dt, dev = x1.dtype, x1.device
    acc = _build.acc_dtype(dt)
    return (wp.to(dev, dt).contiguous(), bp.to(dev, dt).to(acc).contiguous(),
            mats.to(dev, dt).contiguous(), be.to(dev, acc).contiguous(),
            lnp.to(dev, acc).contiguous())


def crosspath_bwd_reduce(x1, x2, s, g1, g2, wp, bp, mats, be, lnp,
                         chunk=None):
    """Pass A' of the backward, through the operator
    ``segmif::ffm_bwd_reduce`` (``ffm_bwd_reduce_op``). x_i, s and the
    cotangents g1, g2 [B, N, C]; wp [3, C, 2C], bp [3, 2C]; mats [B, 4, C,
    C] (the forward's, rounded to the tokens' type here); be [2, C]; lnp
    [2, 2, C]. -> (dM [B, 4, C, C], sums [B, 2, 3, C]) in the arithmetic
    type. CPU tensors take the plain version; CUDA tensors (bf16, the
    forward kernels' token contract) launch ``segmif_ffm_bwd_reduce``.
    ``chunk`` (a multiple of 128) overrides the tokens per block."""
    if x1.is_cuda:
        _check_bwd("crosspath_bwd_reduce", x1, x2, s, g1, g2)
    chunk = chunk or _bwd_chunk(x1.shape[1], x1.shape[0], 2, x1.device)
    return torch.ops.segmif.ffm_bwd_reduce(
        x1, x2, s, g1, g2, *_bwd_operands(x1, wp, bp, mats, be, lnp), chunk)


@torch.library.custom_op("segmif::ffm_bwd_reduce", mutates_args=(),
                         device_types="cuda")
def ffm_bwd_reduce_op(x1: torch.Tensor, x2: torch.Tensor, s: torch.Tensor,
                      g1: torch.Tensor, g2: torch.Tensor, wp: torch.Tensor,
                      bp: torch.Tensor, mats: torch.Tensor, be: torch.Tensor,
                      lnp: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``segmif_ffm_bwd_reduce`` (and its in-order sum of the
    chunks) on the current stream; the partials and the output are
    allocated here."""
    _check_aligned("crosspath_bwd_reduce", x1, x2, s, g1, g2)
    bsz, n, c = x1.shape
    n_chunks = math.ceil(n / chunk)
    per = 2 * c * c + 3 * c
    partial = torch.empty((bsz, n_chunks, 2, per), dtype=torch.float32,
                          device=x1.device)
    out = torch.empty((bsz, 2, per), dtype=torch.float32, device=x1.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    with torch.cuda.device(x1.device):
        err = lib.segmif_ffm_bwd_reduce(
            x1.data_ptr(), x2.data_ptr(), s.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), wp.data_ptr(), bp.data_ptr(), mats.data_ptr(),
            be.data_ptr(), lnp.data_ptr(), partial.data_ptr(),
            out.data_ptr(), bsz, n, chunk, n_chunks,
            _build.DTYPE_CODES[x1.dtype], stream)
    _build.check(err, "crosspath_bwd_reduce")
    crosspath_bwd_reduce.launches += 1
    return _reduce_outputs(out, c)


@ffm_bwd_reduce_op.register_kernel("cpu")
def _ffm_bwd_reduce_cpu(x1, x2, s, g1, g2, wp, bp, mats, be, lnp, chunk):
    return _bwd_reduce_plain(x1, x2, s, g1, g2, wp, bp, mats, be, lnp, chunk)


@ffm_bwd_reduce_op.register_fake
def _ffm_bwd_reduce_fake(x1, x2, s, g1, g2, wp, bp, mats, be, lnp, chunk):
    bsz, c = x1.shape[0], x1.shape[-1]
    return (be.new_empty((bsz, 4, c, c)), be.new_empty((bsz, 2, 3, c)))


crosspath_bwd_reduce.launches = 0


def crosspath_bwd_rows(x1, x2, s, g1, g2, wp, bp, mats, sym, be, lnp,
                       chunk=None):
    """Pass B' of the backward, through the operator
    ``segmif::ffm_bwd_rows`` (``ffm_bwd_rows_op``): operands as
    ``crosspath_bwd_reduce``'s, and sym [B, 3, C, C] (dG_i + dG_i^T, the
    arithmetic type) -> (dx1, dx2, ds) [B, N, C] in the tokens' type, dWp
    [B, 3, C, 2C] and dbp [B, 3, 2C] in the arithmetic type. CPU tensors
    take the plain version; CUDA tensors launch ``segmif_ffm_bwd_rows``."""
    if x1.is_cuda:
        _check_bwd("crosspath_bwd_rows", x1, x2, s, g1, g2)
    chunk = chunk or _bwd_chunk(x1.shape[1], x1.shape[0], 3, x1.device)
    wp, bp, mats, be, lnp = _bwd_operands(x1, wp, bp, mats, be, lnp)
    sym = sym.to(x1.device, bp.dtype).contiguous()
    return torch.ops.segmif.ffm_bwd_rows(x1, x2, s, g1, g2, wp, bp, mats,
                                         sym, be, lnp, chunk)


@torch.library.custom_op("segmif::ffm_bwd_rows", mutates_args=(),
                         device_types="cuda")
def ffm_bwd_rows_op(x1: torch.Tensor, x2: torch.Tensor, s: torch.Tensor,
                    g1: torch.Tensor, g2: torch.Tensor, wp: torch.Tensor,
                    bp: torch.Tensor, mats: torch.Tensor, sym: torch.Tensor,
                    be: torch.Tensor, lnp: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """One launch of ``segmif_ffm_bwd_rows`` (and its in-order sum of the
    chunks) on the current stream; the outputs and partials are allocated
    here."""
    _check_aligned("crosspath_bwd_rows", x1, x2, s, g1, g2)
    bsz, n, c = x1.shape
    n_chunks = math.ceil(n / chunk)
    per = 2 * c * c + 2 * c
    dev = x1.device
    dxs = [torch.empty_like(x) for x in (x1, x2, s)]
    partial = torch.empty((bsz, n_chunks, 3, per), dtype=torch.float32,
                          device=dev)
    out = torch.empty((bsz, 3, per), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.segmif_ffm_bwd_rows(
            x1.data_ptr(), x2.data_ptr(), s.data_ptr(), g1.data_ptr(),
            g2.data_ptr(), wp.data_ptr(), bp.data_ptr(), mats.data_ptr(),
            sym.data_ptr(), be.data_ptr(), lnp.data_ptr(),
            *(d.data_ptr() for d in dxs), partial.data_ptr(), out.data_ptr(),
            bsz, n, chunk, n_chunks, _build.DTYPE_CODES[x1.dtype], stream)
    _build.check(err, "crosspath_bwd_rows")
    crosspath_bwd_rows.launches += 1
    return (*dxs, *_rows_outputs(out, c))


@ffm_bwd_rows_op.register_kernel("cpu")
def _ffm_bwd_rows_cpu(x1, x2, s, g1, g2, wp, bp, mats, sym, be, lnp, chunk):
    return _bwd_rows_plain(x1, x2, s, g1, g2, wp, bp, mats, sym, be, lnp,
                           chunk)


@ffm_bwd_rows_op.register_fake
def _ffm_bwd_rows_fake(x1, x2, s, g1, g2, wp, bp, mats, sym, be, lnp, chunk):
    bsz, c = x1.shape[0], x1.shape[-1]
    return (x1.new_empty(x1.shape), x2.new_empty(x2.shape),
            s.new_empty(s.shape), be.new_empty((bsz, 3, c, 2 * c)),
            be.new_empty((bsz, 3, 2 * c)))


crosspath_bwd_rows.launches = 0


def bwd_takes_kernels(x1, x2, s) -> bool:
    """Whether ``_CrossPathFn``'s backward runs the kernels: bf16 CUDA
    tokens [B, N, 64], contiguous and 16-byte aligned (the forward
    kernels' contract). Every other input takes the plain VJP."""
    return (x1.is_cuda and x1.dtype == torch.bfloat16 and x1.dim() == 3
            and x1.shape[-1] == 64 and all(
                t.shape == x1.shape and t.dtype == x1.dtype
                and t.device == x1.device and t.is_contiguous()
                and t.data_ptr() % 16 == 0 for t in (x1, x2, s)))


def crosspath_backward(x1, x2, s, grams, ws, g1, g2, needs, scale: float,
                       num_heads: int, chunk=None) -> tuple:
    """The gradients of ``crosspath_folded_ref`` with respect to x1, x2, s
    and the 17 weights ``ws`` (``W_KEYS`` order; None where ``needs`` is
    False), from the forward's grams [B, 3, C, C] and the cotangents g1, g2
    (made contiguous here if autograd hands them in another layout): pass
    A' (``crosspath_bwd_reduce``), the fold's gradient (autograd through
    ``fold_mats`` on the grams: dM rounded to the tokens' type, as the
    fold's cast passes it; the contexts', the end projections' and the
    grams' gradients), pass B' (``crosspath_bwd_rows``). On CUDA tensors
    the two passes are kernels; on CPU tensors their plain versions (the
    CPU tests hold this chain to autograd's VJP)."""
    w = dict(zip(W_KEYS, ws))
    dt = x1.dtype
    acc = _build.acc_dtype(dt)
    g1, g2 = g1.contiguous(), g2.contiguous()
    wp, bp = projections(w)
    be = torch.stack([w["be1"], w["be2"]])
    lnp = torch.stack([torch.stack([w["ln1_scale"], w["ln1_bias"]]),
                       torch.stack([w["ln2_scale"], w["ln2_bias"]])])
    fold_keys = ("wkv1", "wkv2", "wkv3", "we1", "we2")
    leaves = [grams.detach().requires_grad_(True)] + [
        w[k].detach().requires_grad_(True) for k in fold_keys]
    with torch.enable_grad():
        mats = fold_mats(*leaves, scale, num_heads)
    dmats, sums = crosspath_bwd_reduce(x1, x2, s, g1, g2, wp, bp,
                                       mats.detach(), be, lnp, chunk)
    dgrams, *dfold = torch.autograd.grad(mats, leaves,
                                         dmats.to(dt).to(acc))
    grads = dict(zip(fold_keys, dfold))
    sums = sums.sum(0)
    for o in (0, 1):
        i = str(o + 1)
        grads["be" + i] = sums[o, 0]
        grads[f"ln{i}_scale"], grads[f"ln{i}_bias"] = sums[o, 1], sums[o, 2]
    dx = [None] * 3
    if any(needs[:3]) or any(n for k, n in zip(W_KEYS, needs[3:])
                             if k[:2] in ("wp", "bp")):
        sym = dgrams + dgrams.transpose(-1, -2)
        *dx, dwp, dbp = crosspath_bwd_rows(x1, x2, s, g1, g2, wp, bp,
                                           mats.detach(), sym, be, lnp,
                                           chunk)
        dwp, dbp = dwp.sum(0).to(dt), dbp.sum(0).to(dt)
        for i in range(3):
            grads[f"wp{i + 1}"], grads[f"bp{i + 1}"] = dwp[i], dbp[i]
    out = list(dx) + [grads.get(k) for k in W_KEYS]
    return tuple(t.to(ref.dtype) if t is not None and n else None
                 for t, ref, n in zip(out, (x1, x2, s, *ws), needs))


class _CrossPathFn(torch.autograd.Function):
    """The two kernels' forward. The backward: the two backward kernels
    where ``bwd_takes_kernels`` (bf16 on the card), else the VJP of the
    plain folded CrossPath recomputed under autograd; both under the span
    ``bwd/crosspath``. ``plain_backwards`` counts the plain VJPs run on
    CUDA tensors."""

    plain_backwards = 0

    @staticmethod
    def forward(ctx, scale, num_heads, forward, x1, x2, s, *ws):
        ctx.scale, ctx.num_heads = scale, num_heads
        w = dict(zip(W_KEYS, ws))
        ctx.kernels = forward is None and bwd_takes_kernels(x1, x2, s)
        if ctx.kernels:
            o1, o2, grams = _crosspath_passes(x1, x2, s, w, scale, num_heads)
            ctx.save_for_backward(x1, x2, s, grams, *ws)
            return o1, o2
        ctx.save_for_backward(x1, x2, s, *ws)
        return (forward or _crosspath_kernels)(x1, x2, s, w, scale,
                                               num_heads)

    @staticmethod
    def backward(ctx, g1, g2):
        needs = ctx.needs_input_grad[3:]
        if ctx.kernels:
            x1, x2, s, grams, *ws = ctx.saved_tensors
            with span("bwd/crosspath"):
                return (None, None, None) + crosspath_backward(
                    x1, x2, s, grams, ws, g1, g2, needs, ctx.scale,
                    ctx.num_heads)

        def plain(x1, x2, s, *ws):
            return crosspath_folded_ref(x1, x2, s, dict(zip(W_KEYS, ws)),
                                        ctx.scale, ctx.num_heads)

        if ctx.saved_tensors[0].is_cuda:
            _CrossPathFn.plain_backwards += 1
        return (None, None, None) + _build.plain_vjp(
            "bwd/crosspath", plain, ctx.saved_tensors, needs, (g1, g2))


def _crosspath_grad(x1, x2, s, w: Dict, scale: float, num_heads: int,
                    forward=None):
    """The fused CrossPath that carries a gradient. ``forward`` stands in
    for the kernels (a test passes the plain version to gradcheck the
    Function on the CPU; the backward is then the plain VJP); nothing on
    the main path sets it."""
    return _CrossPathFn.apply(scale, num_heads, forward, x1, x2, s,
                              *(w[k] for k in W_KEYS))


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
