"""The dilated residual dense block (DRDB), counterpart of
``segmif_tpu/kernels/pallas_drdb.py`` and ``pallas_drdb_tail.py``.

Five dilated (2) 3x3 convs with dense growth (+32 channels each), a 1x1
bottleneck, relu and a residual. Activations are NCHW views on
channels_last memory (the fusion trunk's layout); weights are the
``nn.Conv2d`` OIHW tensors.

 - ``drdb_chain``: the plain conv chain with ``torch.cat`` growth (the
   JAX default ``drdb_xla``).
 - ``drdb_growth_ref`` / ``drdb_tail_ref``: the plain growth chain
   (r1..r5, counterpart of ``_growth_rs(..., dil=2)``) and the plain tail
   (``_tail_xla``).
 - ``drdb_growth`` / ``drdb_tail``: CUDA kernels in ``csrc/drdb.cu`` on
   CUDA tensors (replacing the TPU kernels ``_drdb_pallas_impl`` and
   ``_tail_impl``), the plain versions on CPU tensors. The growth kernel
   writes r1..r5 into one [B, H, W, 160] buffer; the tail reads x and
   the buffer's slices through their strides, so no concat exists.
 - ``pack_growth`` / ``pack_tail``: the weights as the kernels read them;
   ``DRDB`` packs once and passes them as ``wpk``.
 - ``drdb_block``: growth then tail; what ``DRDB.forward`` runs. Under
   autograd the two kernels sit in one ``autograd.Function`` that saves
   only its inputs and whose backward is the VJP of ``drdb_chain`` with
   respect to x and the 12 conv tensors, recomputed in plain PyTorch (the
   JAX ``custom_vjp`` of ``pallas_drdb.py``: ``_bwd`` recomputes
   ``drdb_xla``; saving only the inputs is what the JAX package's
   ``nn.remat(DRDB)`` buys). ``drdb_growth`` and ``drdb_tail`` called
   alone are forward-only.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

Conv = Tuple[torch.Tensor, torch.Tensor]   # (OIHW weight, bias)

C = 64          # trunk channels
G = 32          # growth per conv
NCONV = 5
KC = 32         # input channels per chunk the growth kernel stages


def drdb_chain(x: torch.Tensor, dconvs: Sequence[Conv],
               bottleneck: Conv) -> torch.Tensor:
    """x: [B, C, H, W] (NCHW view, any memory format) -> same shape."""
    feat = x
    for w, b in dconvs:
        y = F.conv2d(feat, w, b, padding=2, dilation=2)
        feat = torch.cat([feat, torch.relu(y)], dim=1)
    w, b = bottleneck
    return x + torch.relu(F.conv2d(feat, w, b))


def drdb_growth_ref(x: torch.Tensor,
                    dconvs: Sequence[Conv]) -> Tuple[torch.Tensor, ...]:
    """Plain growth chain: r_t = relu(conv_t([x, r1..r_{t-1}])), each
    conv's output (bias included) in x's dtype. Returns (r1..r5), each
    [B, 32, H, W]."""
    rs = []
    for w, b in dconvs:
        feat = torch.cat([x, *rs], dim=1)
        rs.append(torch.relu(F.conv2d(feat, w, b, padding=2, dilation=2)))
    return tuple(rs)


def drdb_tail_ref(x: torch.Tensor, rs: Sequence[torch.Tensor],
                  wb: torch.Tensor, bb: torch.Tensor) -> torch.Tensor:
    """Plain tail: the 1x1 bottleneck over [x, r1..r5] rounded to x's
    dtype, then bias, relu and the residual in that dtype. wb: [64, 224,
    1, 1]; bb: [64]."""
    y = F.conv2d(torch.cat([x, *rs], dim=1), wb)
    return x + torch.relu(y + bb.to(x.dtype)[:, None, None])


def _pixel_stride(t: torch.Tensor, channels: int, what: str) -> int:
    """The element stride between pixels of an NCHW view whose channels
    are contiguous and whose pixels are evenly spaced (channels_last
    memory, or a channel slice of it). Raises on any other layout."""
    if t.dim() != 4 or t.shape[1] != channels:
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"[B, {channels}, H, W]")
    b, c, h, w = t.shape
    ps = t.stride(3)
    want = (h * w * ps, 1, w * ps, ps)
    if any(n > 1 and s != e for n, s, e in zip(t.shape, t.stride(), want)):
        raise ValueError(
            f"{what}: strides {t.stride()}; the kernel reads channels_last "
            f"memory with contiguous channels, expected {want}")
    if ps < channels or (ps * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(f"{what}: pixel stride {ps} or address not "
                         "16-byte aligned")
    return ps


def _check_dtype_device(x: torch.Tensor, ts: Sequence[torch.Tensor],
                        what: str) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {x.dtype}; the kernel takes f32 "
                         "or bf16")
    for t in ts:
        if t.dtype != x.dtype:
            raise ValueError(f"{what}: dtypes {x.dtype} and {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on {x.device} and {t.device}")


def pack_growth_weights(dconvs: Sequence[Conv],
                        dtype: torch.dtype) -> torch.Tensor:
    """The five convs' OIHW weights, per 32-channel input chunk, as the
    growth kernel stages them: [chunk][tap][k granule of 8][n][8] for bf16
    (the wgmma B operand: 8 x 8 core matrices of 8 output channels by 8
    input channels, K-major) and [chunk][tap][k][n] for f32. Flat, 20
    chunks of 9 x 32 x 32."""
    parts = []
    for w, _ in dconvs:
        o, cin = w.shape[:2]
        # [n, chunk, granule, e, tap]: input channel 32 chunk + 8 granule + e
        wk = w.to(dtype).reshape(o, cin // KC, KC // 8, 8, 9)
        order = ((1, 4, 2, 0, 3) if dtype == torch.bfloat16
                 else (1, 4, 2, 3, 0))
        parts.append(wk.permute(*order).reshape(-1))
    return torch.cat(parts).contiguous()


def pack_tail_weights(wb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bottleneck [64, 224, 1, 1] as the tail kernel stages it:
    [n][k] for bf16, [k][n] for f32."""
    w = wb.to(dtype).reshape(wb.shape[0], wb.shape[1])
    return (w if dtype == torch.bfloat16 else w.t()).contiguous()


Packed = Tuple[torch.Tensor, torch.Tensor]   # (packed weights, f32 bias)


def pack_growth(dconvs: Sequence[Conv], dtype: torch.dtype) -> Packed:
    """What the growth kernel reads: ``pack_growth_weights`` and the five
    biases as one f32 [160]."""
    return (pack_growth_weights(dconvs, dtype),
            torch.cat([b for _, b in dconvs]).float().contiguous())


def pack_tail(wb: torch.Tensor, bb: torch.Tensor,
              dtype: torch.dtype) -> Packed:
    """What the tail kernel reads: ``pack_tail_weights`` and the f32 bias."""
    return pack_tail_weights(wb, dtype), bb.float().contiguous()


def _check_packed(wpk: Packed, numel: int, nbias: int, x: torch.Tensor,
                  what: str) -> None:
    w, b = wpk
    if (w.numel() != numel or w.dtype != x.dtype or b.shape != (nbias,)
            or b.dtype != torch.float32 or not w.is_contiguous()
            or w.data_ptr() % 16 or w.device != x.device
            or b.device != x.device):
        raise ValueError(f"{what}: wpk is not this DRDB's packing for "
                         f"{x.dtype} on {x.device}")


def drdb_growth(x: torch.Tensor, dconvs: Sequence[Conv],
                wpk: Optional[Packed] = None) -> Tuple[torch.Tensor, ...]:
    """x: [B, 64, H, W] -> (r1..r5), each [B, 32, H, W].

    CPU tensors take ``drdb_growth_ref``. CUDA tensors launch the growth
    kernel five times (one wrapper call, one count); the r_t are channel
    slices of one channels_last [B, H, W, 160] buffer. ``wpk``: the
    weights as ``pack_growth`` packs them for x's dtype (a caller that
    keeps them packs once); without it they are packed here."""
    if x.device.type == "cpu":
        return drdb_growth_ref(x, dconvs)
    if x.device.type != "cuda":
        raise ValueError(f"drdb_growth: unsupported device {x.device}")
    ws = [t for wb in dconvs for t in wb]
    _build.refuse_grad(x, *ws, instead="drdb_block")
    if len(dconvs) != NCONV:
        raise ValueError(f"drdb_growth: {len(dconvs)} convs, expected 5")
    for t, (w, b) in enumerate(dconvs):
        if w.shape != (G, C + G * t, 3, 3) or b.shape != (G,):
            raise ValueError(f"drdb_growth: conv {t + 1} weight "
                             f"{tuple(w.shape)} bias {tuple(b.shape)}")
    _check_dtype_device(x, ws, "drdb_growth")
    x_ps = _pixel_stride(x, C, "drdb_growth x")
    bsz, _, h, w_ = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        if wpk is None:
            wpk = pack_growth(dconvs, x.dtype)
        _check_packed(wpk, 20 * 9 * KC * G, G * NCONV, x, "drdb_growth")
        buf = torch.empty((bsz, h, w_, G * NCONV), dtype=x.dtype,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.segmif_drdb_growth(
            x.data_ptr(), x_ps, buf.data_ptr(), wpk[0].data_ptr(),
            wpk[1].data_ptr(), bsz, h, w_, _build.DTYPE_CODES[x.dtype],
            stream)
    _build.check(err, "drdb_growth")
    drdb_growth.launches += 1
    view = buf.permute(0, 3, 1, 2)
    return tuple(view[:, G * t:G * (t + 1)] for t in range(NCONV))


drdb_growth.launches = 0


def drdb_tail(x: torch.Tensor, rs: Sequence[torch.Tensor], wb: torch.Tensor,
              bb: torch.Tensor,
              wpk: Optional[Packed] = None) -> torch.Tensor:
    """x: [B, 64, H, W]; rs: five [B, 32, H, W]; wb: [64, 224, 1, 1];
    bb: [64] -> x + relu(bottleneck([x, r1..r5]) + bb), [B, 64, H, W].

    CPU tensors take ``drdb_tail_ref``. CUDA tensors launch the tail
    kernel, which reads x and each r_i through its strides (channels_last
    memory, the r_i sharing one pixel stride) and writes a channels_last
    output. ``wpk``: (wb, bb) as ``pack_tail`` packs them, or None."""
    if x.device.type == "cpu":
        return drdb_tail_ref(x, rs, wb, bb)
    if x.device.type != "cuda":
        raise ValueError(f"drdb_tail: unsupported device {x.device}")
    _build.refuse_grad(x, *rs, wb, bb, instead="drdb_block")
    if len(rs) != NCONV:
        raise ValueError(f"drdb_tail: {len(rs)} growth tensors, expected 5")
    if wb.shape != (C, C + G * NCONV, 1, 1) or bb.shape != (C,):
        raise ValueError(f"drdb_tail: bottleneck {tuple(wb.shape)} bias "
                         f"{tuple(bb.shape)}")
    _check_dtype_device(x, [*rs, wb, bb], "drdb_tail")
    x_ps = _pixel_stride(x, C, "drdb_tail x")
    r_ps = {_pixel_stride(r, G, f"drdb_tail r{i + 1}")
            for i, r in enumerate(rs)}
    if len(r_ps) != 1 or any(r.shape[0:1] + r.shape[2:] !=
                             x.shape[0:1] + x.shape[2:] for r in rs):
        raise ValueError("drdb_tail: r1..r5 must match x's B, H, W and "
                         "share one pixel stride")
    bsz, _, h, w_ = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        if wpk is None:
            wpk = pack_tail(wb, bb, x.dtype)
        _check_packed(wpk, C * (C + G * NCONV), C, x, "drdb_tail")
        out = torch.empty_like(x, memory_format=torch.channels_last)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.segmif_drdb_tail(
            x.data_ptr(), x_ps, *(r.data_ptr() for r in rs), r_ps.pop(),
            wpk[0].data_ptr(), wpk[1].data_ptr(), out.data_ptr(),
            bsz * h * w_, _build.DTYPE_CODES[x.dtype], stream)
    _build.check(err, "drdb_tail")
    drdb_tail.launches += 1
    return out


drdb_tail.launches = 0


def _drdb_kernels(x, dconvs, bottleneck, wpk=None) -> torch.Tensor:
    gpk, tpk = (None, None) if wpk is None else wpk
    return drdb_tail(x, drdb_growth(x, dconvs, gpk), *bottleneck, wpk=tpk)


def _convs(ws) -> Tuple[list, Conv]:
    """(w1, b1, ..., w5, b5, wb, bb) -> (dconvs, bottleneck)."""
    return [(ws[2 * t], ws[2 * t + 1]) for t in range(NCONV)], (ws[-2],
                                                                 ws[-1])


class _DrdbFn(torch.autograd.Function):
    """The growth and tail kernels' forward; the backward recomputes
    ``drdb_chain`` from the saved inputs."""

    @staticmethod
    def forward(ctx, forward, wpk, x, *ws):
        ctx.save_for_backward(x, *ws)
        return forward(x, *_convs(ws), wpk)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + _build.plain_vjp(
            lambda x, *ws: drdb_chain(x, *_convs(ws)), ctx.saved_tensors,
            ctx.needs_input_grad[2:], (g,))


def _drdb_grad(x, dconvs, bottleneck, wpk=None, forward=None):
    """The DRDB that carries a gradient. ``forward`` stands in for the
    kernels (a test passes the plain chain to gradcheck the Function on
    the CPU); nothing on the main path sets it."""
    ws = [t for c in (*dconvs, bottleneck) for t in c]
    return _DrdbFn.apply(forward or _drdb_kernels, wpk, x, *ws)


def drdb_block(x: torch.Tensor, dconvs: Sequence[Conv], bottleneck: Conv,
               wpk: Optional[Tuple[Packed, Packed]] = None) -> torch.Tensor:
    """The whole DRDB: ``drdb_growth`` then ``drdb_tail``, each the
    kernel on a CUDA tensor and the plain version on a CPU tensor.
    x: [B, 64, H, W] -> same shape (channels_last on the card). ``wpk``:
    (``pack_growth``, ``pack_tail``) for x's dtype, or None. On the card,
    when a gradient is needed the kernels run inside ``_DrdbFn``."""
    if x.is_cuda and _build.needs_grad(
            x, *(t for c in (*dconvs, bottleneck) for t in c)):
        return _drdb_grad(x, dconvs, bottleneck, wpk)
    return _drdb_kernels(x, dconvs, bottleneck, wpk)
