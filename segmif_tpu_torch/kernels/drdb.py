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
 - ``drdb_growth`` / ``drdb_tail``: the operators ``segmif::drdb_growth``
   and ``segmif::drdb_tail``: CUDA kernels in ``csrc/drdb.cu`` on CUDA
   tensors (replacing the TPU kernels ``_drdb_pallas_impl`` and
   ``_tail_impl``), the plain versions on CPU tensors. The growth kernel
   writes r1..r5 into one [B, H, W, 160] buffer; the tail reads x and
   the buffer's slices through their strides, so no concat exists.
 - ``pack_growth`` / ``pack_tail``: the weights as the kernels read them;
   ``DRDB`` packs once and passes them as ``wpk``. ``unpack_growth`` /
   ``unpack_tail`` invert them for the operators' CPU versions.
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

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

Conv = Tuple[torch.Tensor, torch.Tensor]   # (OIHW weight, bias)

C = 64          # trunk channels
G = 32          # growth per conv
NCONV = 5
KC = 32         # input channels per bf16 chunk (f32: 16)


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


def _pixel_stride(t: torch.Tensor, channels: int, what: str,
                  address: bool = True) -> int:
    """The element stride between pixels of an NCHW view whose channels
    are contiguous and whose pixels are evenly spaced (channels_last
    memory, or a channel slice of it). Raises on any other layout, and
    with ``address`` on an address off 16 bytes (read where the kernel
    launches: a traced call has no address)."""
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
    if ps < channels or (ps * t.element_size()) % 16 or (
            address and t.data_ptr() % 16):
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


def _growth_layout(dtype: torch.dtype) -> Tuple[int, int, int]:
    """(input channels per chunk, k granule, halves) of the growth
    kernel's packing: 16, 4 and 2 (big and small) for f32; 32, 8 and 1 for
    bf16 (and f64, which only the CPU versions read)."""
    return (KC // 2, 4, 2) if dtype == torch.float32 else (KC, 8, 1)


def growth_numel(dtype: torch.dtype) -> int:
    """Elements of ``pack_growth_weights`` for ``dtype``: the five convs'
    weights once, or a big and a small half in f32."""
    return _growth_layout(dtype)[2] * 20 * 9 * KC * G


def pack_growth_weights(dconvs: Sequence[Conv],
                        dtype: torch.dtype) -> torch.Tensor:
    """The five convs' OIHW weights, per input chunk, as the growth
    kernel stages them: the wgmma B operand, K-major core matrices of 8
    output channels by 16 bytes of input channels. bf16: per 32 channels,
    [chunk][tap][k granule of 8][n][8]. f32: per 16 channels,
    [chunk][big, small][tap][k granule of 4][n][4], the 3xTF32 halves
    (``_build.tf32_big``; the kernel reads small as TF32). f64 as bf16.
    Flat."""
    kc, gr, _ = _growth_layout(dtype)
    parts = []
    for w, _ in dconvs:
        o, cin = w.shape[:2]
        # [n, chunk, granule, e, tap]: input channel kc chunk + gr granule
        # + e -> [chunk][tap][granule][n][e]
        wk = w.to(dtype).reshape(o, cin // kc, kc // gr, gr, 9).permute(
            1, 4, 2, 0, 3)
        if dtype == torch.float32:
            big = _build.tf32_big(wk)
            wk = torch.stack([big, wk - big], dim=1)
        parts.append(wk.reshape(-1))
    return torch.cat(parts).contiguous()


def pack_tail_weights(wb: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bottleneck [64, 224, 1, 1] as the tail kernel stages it: [n][k]
    rows in ``dtype``, for every dtype (bf16 feeds ldmatrix, f32 the
    3xTF32 split, which the kernel makes as it reads each value). Always a
    copy: ``DRDB.kernel_weights`` keeps it, and a view of a weight that an
    optimizer then updates in place could not be deep-copied."""
    w = wb.reshape(wb.shape[0], wb.shape[1])
    return w.to(dtype, copy=True).contiguous()


Packed = Tuple[torch.Tensor, torch.Tensor]   # (packed weights, bias)


def pack_growth(dconvs: Sequence[Conv], dtype: torch.dtype) -> Packed:
    """What the growth kernel reads: ``pack_growth_weights`` and the five
    biases as one [160] in the arithmetic type (f32; f64 for f64)."""
    return (pack_growth_weights(dconvs, dtype),
            torch.cat([b for _, b in dconvs]).to(_build.acc_dtype(dtype))
            .contiguous())


def pack_tail(wb: torch.Tensor, bb: torch.Tensor,
              dtype: torch.dtype) -> Packed:
    """What the tail kernel reads: ``pack_tail_weights`` and the bias in
    the arithmetic type (f32; f64 for f64)."""
    return (pack_tail_weights(wb, dtype),
            bb.to(_build.acc_dtype(dtype)).contiguous())


def unpack_growth(wpk: Packed, dtype: torch.dtype) -> list:
    """Inverse of ``pack_growth`` for activations of ``dtype``: the five
    (OIHW weight, bias), weights in ``dtype`` (f32's halves summed, which
    is exact) and biases as packed."""
    w, b = wpk
    kc, gr, halves = _growth_layout(dtype)
    dconvs, at = [], 0
    for t in range(NCONV):
        cin = C + G * t
        size = halves * G * cin * 9
        part = w[at:at + size].reshape(cin // kc, halves, 9, kc // gr, G, gr)
        at += size
        dconvs.append((part.sum(1).permute(3, 0, 2, 4, 1).reshape(
            G, cin, 3, 3), b[G * t:G * (t + 1)]))
    return dconvs


def unpack_tail(wpk: Packed, dtype: torch.dtype) -> Conv:
    """Inverse of ``pack_tail``: (the [64, 224, 1, 1] bottleneck in
    ``dtype``, the bias as packed)."""
    w, b = wpk
    return w.reshape(C, C + G * NCONV, 1, 1).contiguous(), b


def _check_packed(wpk: Packed, numel: int, nbias: int, x: torch.Tensor,
                  what: str, address: bool = True) -> None:
    w, b = wpk
    if (w.numel() != numel or w.dtype != x.dtype or b.shape != (nbias,)
            or b.dtype != torch.float32 or not w.is_contiguous()
            or (address and w.data_ptr() % 16) or w.device != x.device
            or b.device != x.device):
        raise ValueError(f"{what}: wpk is not this DRDB's packing for "
                         f"{x.dtype} on {x.device}")


def drdb_growth(x: torch.Tensor, dconvs: Sequence[Conv],
                wpk: Optional[Packed] = None) -> Tuple[torch.Tensor, ...]:
    """x: [B, 64, H, W] -> (r1..r5), each [B, 32, H, W], through the
    operator ``segmif::drdb_growth`` (``drdb_growth_op``).

    CPU tensors take ``drdb_growth_ref`` (through autograd when a gradient
    is needed). CUDA tensors launch the growth kernel five times (one
    wrapper call, one count). The operator's r_t are channel slices of one
    channels_last [B, H, W, 160] buffer. ``wpk``: the weights as
    ``pack_growth`` packs them for x's dtype (a caller that keeps them
    packs once); without it they are packed here."""
    ws = [t for wb in dconvs for t in wb]
    if x.device.type == "cpu" and _build.needs_grad(x, *ws):
        return drdb_growth_ref(x, dconvs)
    if len(dconvs) != NCONV:
        raise ValueError(f"drdb_growth: {len(dconvs)} convs, expected 5")
    if x.is_cuda:
        _build.refuse_grad(x, *ws, instead="drdb_block")
        for t, (w, b) in enumerate(dconvs):
            if w.shape != (G, C + G * t, 3, 3) or b.shape != (G,):
                raise ValueError(f"drdb_growth: conv {t + 1} weight "
                                 f"{tuple(w.shape)} bias {tuple(b.shape)}")
        _check_dtype_device(x, ws, "drdb_growth")
        _pixel_stride(x, C, "drdb_growth x", address=False)
    if wpk is None:
        wpk = pack_growth(dconvs, x.dtype)
    if x.is_cuda:
        _check_packed(wpk, growth_numel(x.dtype), G * NCONV, x,
                      "drdb_growth", address=False)
    buf = torch.ops.segmif.drdb_growth(x, *wpk)
    view = buf.permute(0, 3, 1, 2)
    return tuple(view[:, G * t:G * (t + 1)] for t in range(NCONV))


@torch.library.custom_op("segmif::drdb_growth", mutates_args=(),
                         device_types="cuda")
def drdb_growth_op(x: torch.Tensor, wpk: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Five launches of the growth kernel (``segmif_drdb_growth``) on the
    current stream, into the [B, H, W, 160] buffer allocated here."""
    x_ps = _pixel_stride(x, C, "drdb_growth x")
    _check_packed((wpk, bias), growth_numel(x.dtype), G * NCONV, x,
                  "drdb_growth")
    bsz, _, h, w_ = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        buf = torch.empty((bsz, h, w_, G * NCONV), dtype=x.dtype,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.segmif_drdb_growth(
            x.data_ptr(), x_ps, buf.data_ptr(), wpk.data_ptr(),
            bias.data_ptr(), bsz, h, w_, _build.DTYPE_CODES[x.dtype],
            stream)
    _build.check(err, "drdb_growth")
    drdb_growth.launches += 1
    return buf


@drdb_growth_op.register_kernel("cpu")
def _drdb_growth_cpu(x, wpk, bias):
    dconvs = [(w, b.to(x.dtype)) for w, b in unpack_growth((wpk, bias),
                                                           x.dtype)]
    rs = drdb_growth_ref(x, dconvs)
    return torch.cat(rs, dim=1).permute(0, 2, 3, 1).contiguous()


@drdb_growth_op.register_fake
def _drdb_growth_fake(x, wpk, bias):
    bsz, _, h, w_ = x.shape
    return x.new_empty((bsz, h, w_, G * NCONV))


drdb_growth.launches = 0


def drdb_tail(x: torch.Tensor, rs: Sequence[torch.Tensor], wb: torch.Tensor,
              bb: torch.Tensor,
              wpk: Optional[Packed] = None) -> torch.Tensor:
    """x: [B, 64, H, W]; rs: five [B, 32, H, W]; wb: [64, 224, 1, 1];
    bb: [64] -> x + relu(bottleneck([x, r1..r5]) + bb), [B, 64, H, W]
    channels_last, through the operator ``segmif::drdb_tail``
    (``drdb_tail_op``).

    CPU tensors take ``drdb_tail_ref`` (through autograd when a gradient
    is needed). CUDA tensors launch the tail kernel, which reads x and
    each r_i through its strides (channels_last memory, the r_i sharing
    one pixel stride) and writes a channels_last output. ``wpk``: (wb, bb)
    as ``pack_tail`` packs them, or None."""
    if x.device.type == "cpu" and _build.needs_grad(x, *rs, wb, bb):
        return drdb_tail_ref(x, rs, wb, bb)
    if len(rs) != NCONV:
        raise ValueError(f"drdb_tail: {len(rs)} growth tensors, expected 5")
    if x.is_cuda:
        _build.refuse_grad(x, *rs, wb, bb, instead="drdb_block")
        if wb.shape != (C, C + G * NCONV, 1, 1) or bb.shape != (C,):
            raise ValueError(f"drdb_tail: bottleneck {tuple(wb.shape)} "
                             f"bias {tuple(bb.shape)}")
        _check_dtype_device(x, [*rs, wb, bb], "drdb_tail")
        _tail_strides(x, rs, address=False)
    if wpk is None:
        wpk = pack_tail(wb, bb, x.dtype)
    if x.is_cuda:
        _check_packed(wpk, C * (C + G * NCONV), C, x, "drdb_tail",
                      address=False)
    return torch.ops.segmif.drdb_tail(x, list(rs), *wpk)


def _tail_strides(x, rs, address: bool = True) -> Tuple[int, int]:
    """(x's pixel stride, the r_i's shared pixel stride); raises on a
    layout the tail kernel does not read."""
    x_ps = _pixel_stride(x, C, "drdb_tail x", address)
    r_ps = {_pixel_stride(r, G, f"drdb_tail r{i + 1}", address)
            for i, r in enumerate(rs)}
    if len(r_ps) != 1 or any(r.shape[0:1] + r.shape[2:] !=
                             x.shape[0:1] + x.shape[2:] for r in rs):
        raise ValueError("drdb_tail: r1..r5 must match x's B, H, W and "
                         "share one pixel stride")
    return x_ps, r_ps.pop()


@torch.library.custom_op("segmif::drdb_tail", mutates_args=(),
                         device_types="cuda")
def drdb_tail_op(x: torch.Tensor, rs: List[torch.Tensor], wpk: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """One launch of the tail kernel (``segmif_drdb_tail``) on the current
    stream; the channels_last output is allocated here."""
    x_ps, r_ps = _tail_strides(x, rs)
    _check_packed((wpk, bias), C * (C + G * NCONV), C, x, "drdb_tail")
    bsz, _, h, w_ = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x, memory_format=torch.channels_last)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.segmif_drdb_tail(
            x.data_ptr(), x_ps, *(r.data_ptr() for r in rs), r_ps,
            wpk.data_ptr(), bias.data_ptr(), out.data_ptr(),
            bsz * h * w_, _build.DTYPE_CODES[x.dtype], stream)
    _build.check(err, "drdb_tail")
    drdb_tail.launches += 1
    return out


@drdb_tail_op.register_kernel("cpu")
def _drdb_tail_cpu(x, rs, wpk, bias):
    wb, bb = unpack_tail((wpk, bias), x.dtype)
    return drdb_tail_ref(x, rs, wb, bb).contiguous(
        memory_format=torch.channels_last)


@drdb_tail_op.register_fake
def _drdb_tail_fake(x, rs, wpk, bias):
    return torch.empty_like(x, memory_format=torch.channels_last)


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
            "bwd/drdb", lambda x, *ws: drdb_chain(x, *_convs(ws)),
            ctx.saved_tensors, ctx.needs_input_grad[2:], (g,))


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
