"""The int8 DRDB for calibrated serving, counterpart of
``segmif_tpu/kernels/int8.py`` and ``segmif_tpu/kernels/pallas_drdb_int8.py``.

Post-training quantisation of the DRDB (the JAX package's scheme):
 - weights: per-output-channel symmetric int8; each source s (x, r1..r4)
   is quantised over all later targets' columns, so a column scale exists
   per (source, target, output channel);
 - activations: per-tensor symmetric int8 with static scales s = amax/127
   + eps, the amaxes of (x, r1..r5) recorded by one calibration pass;
 - growth conv t: exact int32 sums per source, dequantised by the column
   scales sw_s * s_in[s] into f32 partial sums in the TPU kernel's order,
   requantised by multiplying with 1 / s_{t+1};
 - bottleneck: each source's activation scale folded into its slice of the
   f32 weight before quantising, so the int8 buffer [xq, r1..r5] feeds one
   int8 1x1 conv; residual and relu in f32 against x.

The partial sums are f32, as the TPU kernel keeps them
(``pallas_drdb_int8.py:129-142``); ``drdb_chain_int8`` rounds them to bf16
to save device-memory traffic that a kernel keeping them in registers does
not have.

 - ``quantize_kernel`` / ``quantize_act`` / ``record_amax``: the quantisers.
 - ``quantize_drdb``: a DRDB's weights and amaxes -> ``Int8Drdb``, made
   once when a model is quantised (packed for the kernel as well).
 - ``drdb_int8_ref``: the plain version (image layout, dilation 2). Its
   integer convolutions are float64 per-tap products, exact on any device:
   every partial sum is an integer below 2^53.
 - ``drdb_int8_growth`` / ``drdb_int8_tail``: the operators
   ``segmif::drdb_int8_growth`` and ``segmif::drdb_int8_tail``: the CUDA
   kernels in ``csrc/drdb_int8.cu`` on CUDA tensors (replacing the TPU kernel
   ``drdb_strips_int8_pallas``; the growth convs on wgmma with TMA-fed
   halos), the plain versions on CPU tensors. The growth wrapper writes xq
   and r1..r5 into one int8 [B, H, W, 224] buffer that the tail reads.
 - ``drdb_int8``: growth then tail; what ``DRDB.forward`` runs in "int8"
   mode. Serving-only: a gradient through it raises.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .drdb import C, G, KC, NCONV, Conv, _pixel_stride

_EPS = 1e-12
CT = C + G * NCONV      # channels of the int8 feature buffer (224)


class _ServingOnly(torch.autograd.Function):
    """Identity whose backward raises: round and clip have zero gradients,
    so without it a gradient through the int8 DRDB would be silently zero
    (counterpart of ``_serving_only``, ``segmif_tpu/kernels/int8.py``)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the int8 DRDB path is serving-only: gradients through the "
            "quantize/requant rounds are identically zero. Train with "
            "quant='none' and quantize the trained weights with "
            "serving.quantize_for_serving.")


def quantize_kernel(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (dim 0) symmetric int8 for an OIHW (or [O, I])
    weight: sw = max|k| / 127 + eps, kq = round(k / sw). Returns (kq int8,
    sw f32 [O])."""
    kf = k.float()
    sw = kf.abs().amax(dim=tuple(range(1, kf.dim()))) / 127.0 + _EPS
    kq = torch.round(kf / sw.reshape((-1,) + (1,) * (kf.dim() - 1)))
    return kq.to(torch.int8), sw


def quantize_act(t: torch.Tensor, amax) -> torch.Tensor:
    """Symmetric per-tensor int8 at the static scale s = amax / 127 + eps."""
    s = torch.as_tensor(amax, dtype=torch.float32, device=t.device) / 127.0 \
        + _EPS
    return torch.clamp(torch.round(t.float() / s), -127, 127).to(torch.int8)


def record_amax(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """[len(tensors)] f32 per-tensor abs-max: the calibration record."""
    return torch.stack([t.float().abs().amax() for t in tensors])


class Int8Drdb(NamedTuple):
    """A DRDB's int8 serving weights (``quantize_drdb``). Sources s = 0..4
    are x, r1..r4; source s feeds targets s..4 (n_s = G (5 - s) columns)."""
    kq: Tuple[torch.Tensor, ...]   # int8 [n_s, cin_s, 3, 3] per source
    sv: Tuple[torch.Tensor, ...]   # f32 [n_s]: sw_s * s_in[s]
    bias: torch.Tensor             # f32 [5 G]
    s_in: torch.Tensor             # f32 [6]: scales of x, r1..r5
    invs: torch.Tensor             # f32 [6]: 0, then 1 / s_in[1..5]
    kbq: torch.Tensor              # int8 [C, C + 5 G], scale-folded
    svb: torch.Tensor              # f32 [C]
    bb: torch.Tensor               # f32 [C]
    wpk: Optional[torch.Tensor]    # int8: kq as the kernel reads it
    svk: Optional[torch.Tensor]    # f32 [5 targets, 5 sources, G]

    def tensors(self) -> Dict[str, Optional[torch.Tensor]]:
        """Flat {name: tensor}, the tuples as kq0..kq4 and sv0..sv4."""
        out = {}
        for f in self._fields:
            v = getattr(self, f)
            if isinstance(v, tuple):
                out.update({f"{f}{i}": t for i, t in enumerate(v)})
            else:
                out[f] = v
        return out

    @classmethod
    def from_tensors(cls, get) -> "Int8Drdb":
        """Inverse of ``tensors``; get(name) returns each tensor."""
        return cls(kq=tuple(get(f"kq{s}") for s in range(NCONV)),
                   sv=tuple(get(f"sv{s}") for s in range(NCONV)),
                   **{f: get(f) for f in cls._fields[2:]})


# the operators' int8 weight list: ``Int8Drdb.tensors()``'s names in order
Q_NAMES = tuple(f"{f}{i}" for f in ("kq", "sv") for i in range(NCONV)) + \
    Int8Drdb._fields[2:]


def _source_range(s: int, c: int, g: int) -> Tuple[int, int]:
    lo = 0 if s == 0 else c + (s - 1) * g
    return lo, lo + (c if s == 0 else g)


def pack_int8_growth(kq: Sequence[torch.Tensor]) -> torch.Tensor:
    """The per-source int8 weights as the growth kernel stages them: per
    conv t, per 32-channel chunk of its input (x's two, then r1..r_t), per
    tap, [k granule of 16][n = 32][16] (the wgmma B operand: 8 x 16-byte
    core matrices of 8 output channels by 16 input channels, K-major).
    Flat, 20 chunks of 9 x 32 x 32."""
    parts = []
    for t in range(NCONV):
        for chunk in range(2 + t):
            s = 0 if chunk < 2 else chunk - 1
            k0 = KC * chunk if s == 0 else 0
            w = kq[s][G * (t - s):G * (t - s + 1), k0:k0 + KC]  # [n, k, 3, 3]
            # [n, granule, e, ky, kx] -> [ky, kx, granule, n, e]
            w = w.reshape(G, KC // 16, 16, 3, 3).permute(3, 4, 1, 0, 2)
            parts.append(w.reshape(-1))
    return torch.cat(parts).contiguous()


def quantize_drdb(dconvs: Sequence[Conv], bottleneck: Conv,
                  amax: torch.Tensor) -> Int8Drdb:
    """Quantise a DRDB's weights (five (OIHW 3x3 weight, bias), the 1x1
    bottleneck) with its calibrated amaxes [6] of (x, r1..r5), in the f32
    operations of ``pallas_drdb_int8.py:175-201``. The kernel's packing
    (``wpk``, ``svk``) is made for C = 64, G = 32 only."""
    ws = [w.detach().float() for w, _ in dconvs]
    g, c = ws[0].shape[0], ws[0].shape[1]
    s_in = amax.detach().float() / 127.0 + _EPS
    kq, sv = [], []
    for s in range(NCONV):
        lo, hi = _source_range(s, c, g)
        q, sw = quantize_kernel(torch.cat([ws[i][:, lo:hi]
                                           for i in range(s, NCONV)]))
        kq.append(q)
        sv.append(sw * s_in[s])
    one = torch.ones(NCONV, device=s_in.device)
    invs = torch.cat([torch.zeros(1, device=s_in.device), one / s_in[1:]])
    wb, bb = bottleneck
    kb = wb.detach().float().reshape(wb.shape[0], wb.shape[1])
    per_k = torch.cat([s_in[0].expand(c)] +
                      [s_in[i + 1].expand(g) for i in range(NCONV)])
    kbq, svb = quantize_kernel(kb * per_k)
    wpk = svk = None
    if (c, g) == (C, G):
        wpk = pack_int8_growth(kq)
        svk = torch.zeros((NCONV, NCONV, G), device=s_in.device)
        for t in range(NCONV):
            for s in range(t + 1):
                svk[t, s] = sv[s][G * (t - s):G * (t - s + 1)]
    return Int8Drdb(kq=tuple(kq), sv=tuple(sv),
                    bias=torch.cat([b.detach().float() for _, b in dconvs]),
                    s_in=s_in, invs=invs, kbq=kbq.contiguous(), svb=svb,
                    bb=bb.detach().float(), wpk=wpk, svk=svk)


def _iconv(src: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """int8 [B, H, W, cin] conv int8 OIHW [n, cin, 3, 3], zero padding 2,
    dilation 2 -> the exact int32 sums as f32 [B, H, W, n] (below 2^24)."""
    _, h, w, _ = src.shape
    p = F.pad(src.to(torch.float64), (0, 0, 2, 2, 2, 2))
    k = kq.to(torch.float64)
    acc = 0
    for ky in range(3):
        for kx in range(3):
            acc = acc + p[:, 2 * ky:2 * ky + h, 2 * kx:2 * kx + w] @ \
                k[:, :, ky, kx].t()
    return acc.float()


def drdb_int8_growth_ref(x: torch.Tensor, q: Int8Drdb) -> torch.Tensor:
    """Plain entry quantise and growth chain. x: [B, C, H, W] -> the int8
    buffer [B, H, W, C + 5 G]: xq, then r1..r5."""
    xs = x.permute(0, 2, 3, 1).float()
    xq = torch.clamp(torch.round(xs / q.s_in[0]), -127, 127).to(torch.int8)
    g = q.bias.numel() // NCONV
    pre = _iconv(xq, q.kq[0]) * q.sv[0] + q.bias    # x's share of all 5
    feat = [xq]
    for t in range(NCONV):
        r = torch.round(torch.relu(pre[..., :g]) * q.invs[t + 1])
        feat.append(torch.clamp(r, -127, 127).to(torch.int8))
        if t + 1 < NCONV:
            pre = pre[..., g:] + _iconv(feat[-1], q.kq[t + 1]) * q.sv[t + 1]
    return torch.cat(feat, -1)


def drdb_int8_tail_ref(x: torch.Tensor, feat: torch.Tensor,
                       q: Int8Drdb) -> torch.Tensor:
    """Plain tail: x + relu(feat kbq^T * svb + bb) in f32, in x's dtype.
    x: [B, C, H, W]; feat: int8 [B, H, W, C + 5 G] -> [B, C, H, W] (an
    NCHW view on channels_last memory)."""
    acc = (feat.to(torch.float64) @ q.kbq.to(torch.float64).t()).float()
    out = x.permute(0, 2, 3, 1).float() + torch.relu(acc * q.svb + q.bb)
    return out.to(x.dtype).permute(0, 3, 1, 2)


def drdb_int8_ref(x: torch.Tensor, q: Int8Drdb) -> torch.Tensor:
    """The plain int8 DRDB; a gradient through it raises."""
    x = _ServingOnly.apply(x)
    return drdb_int8_tail_ref(x, drdb_int8_growth_ref(x, q), q)


def _check(x: torch.Tensor, q: Int8Drdb, what: str,
           address: bool = True) -> int:
    """Refuse what the kernels do not take; return x's pixel stride.
    ``address``: also x's address (read where the kernel launches)."""
    _build.refuse_grad(x)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{what}: dtype {x.dtype}; the kernel takes f32 or "
                         "bf16")
    if q.wpk is None:
        raise ValueError(f"{what}: the kernel takes C = {C}, G = {G} only")
    for name, t in q.tensors().items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
    return _pixel_stride(x, C, f"{what} x", address)


def _q_list(q: Int8Drdb) -> List[torch.Tensor]:
    return list(q.tensors().values())


def _q_from(ts: Sequence[torch.Tensor]) -> Int8Drdb:
    return Int8Drdb.from_tensors(dict(zip(Q_NAMES, ts)).__getitem__)


def drdb_int8_growth(x: torch.Tensor, q: Int8Drdb) -> torch.Tensor:
    """x: [B, 64, H, W] -> the int8 buffer [B, H, W, 224] (xq, r1..r5),
    through the operator ``segmif::drdb_int8_growth``
    (``drdb_int8_growth_op``).

    CPU tensors take ``drdb_int8_growth_ref``. CUDA tensors launch the
    entry kernel and the growth conv kernel five times (one wrapper call,
    one count)."""
    if x.device.type == "cpu" and (q.wpk is None or _build.needs_grad(x)):
        return drdb_int8_growth_ref(x, q)
    if x.is_cuda:
        _check(x, q, "drdb_int8_growth", address=False)
    return torch.ops.segmif.drdb_int8_growth(x, _q_list(q))


@torch.library.custom_op("segmif::drdb_int8_growth", mutates_args=(),
                         device_types="cuda")
def drdb_int8_growth_op(x: torch.Tensor,
                        q: List[torch.Tensor]) -> torch.Tensor:
    """The entry quantise and the five growth launches
    (``segmif_drdb_int8_growth``) on the current stream, into the int8
    buffer allocated here. ``q``: ``Int8Drdb.tensors()``'s values."""
    qd = _q_from(q)
    x_ps = _check(x, qd, "drdb_int8_growth")
    bsz, _, h, w_ = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        feat = torch.empty((bsz, h, w_, CT), dtype=torch.int8,
                           device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.segmif_drdb_int8_growth(
            x.data_ptr(), x_ps, feat.data_ptr(), qd.wpk.data_ptr(),
            qd.svk.data_ptr(), qd.bias.data_ptr(), qd.s_in.data_ptr(),
            qd.invs.data_ptr(), bsz, h, w_, _build.DTYPE_CODES[x.dtype],
            stream)
    _build.check(err, "drdb_int8_growth")
    drdb_int8_growth.launches += 1
    return feat


@drdb_int8_growth_op.register_kernel("cpu")
def _drdb_int8_growth_cpu(x, q):
    return drdb_int8_growth_ref(x, _q_from(q))


@drdb_int8_growth_op.register_fake
def _drdb_int8_growth_fake(x, q):
    bsz, _, h, w_ = x.shape
    return x.new_empty((bsz, h, w_, CT), dtype=torch.int8)


drdb_int8_growth.launches = 0


def drdb_int8_tail(x: torch.Tensor, feat: torch.Tensor,
                   q: Int8Drdb) -> torch.Tensor:
    """x: [B, 64, H, W]; feat: the int8 buffer [B, H, W, 224] ->
    x + relu(bottleneck), [B, 64, H, W] in x's dtype (channels_last),
    through the operator ``segmif::drdb_int8_tail``
    (``drdb_int8_tail_op``).

    CPU tensors take ``drdb_int8_tail_ref``. CUDA tensors launch the tail
    kernel, which writes a channels_last output."""
    if x.device.type == "cpu" and (q.wpk is None or _build.needs_grad(x)):
        return drdb_int8_tail_ref(x, feat, q)
    if x.is_cuda:
        _check(x, q, "drdb_int8_tail", address=False)
        bsz, _, h, w_ = x.shape
        if (feat.dtype != torch.int8 or feat.shape != (bsz, h, w_, CT)
                or not feat.is_contiguous() or feat.device != x.device):
            raise ValueError(f"drdb_int8_tail: feat {feat.dtype} "
                             f"{tuple(feat.shape)}, expected a contiguous "
                             f"int8 [{bsz}, {h}, {w_}, {CT}] on {x.device}")
    return torch.ops.segmif.drdb_int8_tail(x, feat, _q_list(q))


@torch.library.custom_op("segmif::drdb_int8_tail", mutates_args=(),
                         device_types="cuda")
def drdb_int8_tail_op(x: torch.Tensor, feat: torch.Tensor,
                      q: List[torch.Tensor]) -> torch.Tensor:
    """One launch of the int8 tail (``segmif_drdb_int8_tail``) on the
    current stream; the channels_last output is allocated here."""
    qd = _q_from(q)
    x_ps = _check(x, qd, "drdb_int8_tail")
    bsz, _, h, w_ = x.shape
    lib = _build.library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x, memory_format=torch.channels_last)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.segmif_drdb_int8_tail(
            x.data_ptr(), x_ps, feat.data_ptr(), qd.kbq.data_ptr(),
            qd.svb.data_ptr(), qd.bb.data_ptr(), out.data_ptr(),
            bsz * h * w_, _build.DTYPE_CODES[x.dtype], stream)
    _build.check(err, "drdb_int8_tail")
    drdb_int8_tail.launches += 1
    return out


@drdb_int8_tail_op.register_kernel("cpu")
def _drdb_int8_tail_cpu(x, feat, q):
    return drdb_int8_tail_ref(x, feat, _q_from(q)).contiguous(
        memory_format=torch.channels_last)


@drdb_int8_tail_op.register_fake
def _drdb_int8_tail_fake(x, feat, q):
    return torch.empty_like(x, memory_format=torch.channels_last)


drdb_int8_tail.launches = 0


def drdb_int8(x: torch.Tensor, q: Int8Drdb) -> torch.Tensor:
    """The int8 DRDB: growth then tail, the two operators (the kernels on
    a CUDA tensor, which refuse tensors that require a gradient; the plain
    versions on a CPU tensor, where a gradient through ``drdb_int8_ref``
    raises). x: [B, 64, H, W] -> same shape."""
    if x.device.type == "cpu" and (q.wpk is None or _build.needs_grad(x)):
        return drdb_int8_ref(x, q)
    return drdb_int8_tail(x, drdb_int8_growth(x, q), q)
