"""The f32 kernels' 3xTF32 arithmetic, emulated in plain PyTorch on the CPU.

The f32 sr-attention (mma.sync m16n8k8 .tf32) and DRDB growth (wgmma
.tf32) kernels split each f32 operand a into big = a rounded to TF32
(10 mantissa bits; nearest, ties away from zero) and small = a - big,
and compute each product as big*big + big*small + small*big in f32
accumulators; the tensor cores read small as TF32, its low 13 bits
ignored ("truncated"). Here the same arithmetic runs in torch, one k8 step
at a time: each step's products summed exactly (f64) and added to an f32
accumulator (the kernels add each k8 step's products, in sr-attention,
or each 16-channel chunk's, in the growth, into a fresh accumulator that
is then added to the running f32 sum). Each emulation is
held against an f64 reference within half of chip_smoke.py's unchanged
f32 limits (SR_TOL["float32"]: atol 1e-5; GROWTH_TOL["float32"]: rtol and
atol 1e-4), with small fed truncated and, as the alternative, rounded
(both hold: the sr-attention cases read up to 0.11 of the limit, the
growth 0.008); a 1xTF32 version (big*big alone) must exceed the same
limits twice over (it reads 27-112x and 3.4-5.2x), so the limits tell the
two apart. Also the f32 growth packing (big and small halves, 16-channel
chunks) by its index formula and through ``unpack_growth``.

No card: CPU tensors only.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segmif_tpu_torch.kernels import _build
from segmif_tpu_torch.kernels import drdb as tdrdb
from segmif_tpu_torch.kernels.attention import sr_attention_ref

SR_TOL_F32 = (0.0, 1e-5)          # chip_smoke.SR_TOL["float32"]: rtol, atol
GROWTH_TOL_F32 = (1e-4, 1e-4)     # chip_smoke.GROWTH_TOL["float32"]
# mit_b3's four stages at 480x640 (tokens N, heads), N cut to 256; M 300
STAGES = [(256, 1), (256, 2), (256, 5), (256, 8)]
LOG2E = 1.4426950408889634


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: how the tensor cores read
    an f32 value as TF32."""
    return (x.float().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, small: str):
    """(big, small) of an f32 tensor as the kernels split it; ``small``:
    "truncated" (as the kernels feed it) or "rounded" (to TF32 again)."""
    big = _build.tf32_big(x)
    rest = x - big
    return big, (tf32_trunc(rest) if small == "truncated"
                 else _build.tf32_big(rest))


def mm(a: torch.Tensor, b: torch.Tensor, terms: int, small: str):
    """a [..., M, K] @ b [..., K, N], f32, as the kernels compute it: per
    k8 step the TF32 products (3xTF32: small*big, big*small, big*big;
    1xTF32: big*big of the operands rounded to TF32) summed exactly and
    added to an f32 accumulator."""
    ab, as_ = split(a, small)
    bb, bs = split(b, small)
    pairs = ([(as_, bb), (ab, bs), (ab, bb)] if terms == 3 else [(ab, bb)])
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            part = x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double()
            acc = (acc.double() + part).float()
    return acc


def attention_emulated(q, k, v, scale, terms, small, tile=64):
    """The f32 sr-attention kernel's arithmetic: S = Q K^T (``mm``), the
    logits in log2 units (scale * log2(e) folded into one f32 multiply),
    the online softmax over 64-key tiles in f32 (exp2), O += P V
    (``mm``), divided by the row sum at the end. q [B, N, H, D], k and v
    [B, M, H, D] f32 -> [B, N, H, D]."""
    qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    mrow = torch.full(qt.shape[:-1], -math.inf)
    lrow = torch.zeros(qt.shape[:-1])
    o = torch.zeros(qt.shape)
    for j0 in range(0, kt.shape[2], tile):
        s = mm(qt, kt[:, :, j0:j0 + tile].transpose(-1, -2), terms, small)
        x = s * c
        mx = torch.maximum(mrow, x.amax(-1))
        alpha = torch.exp2(mrow - mx)
        p = torch.exp2(x - mx[..., None])
        lrow = lrow * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vt[:, :, j0:j0 + tile], terms,
                                      small)
        mrow = mx
    return (o / lrow[..., None]).permute(0, 2, 1, 3)


def _sr_case(seed, n, h, m=300, d=64):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((1, n, h, d), np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, m, 2, h, d), np.float32))
    return q, kv[:, :, 0], kv[:, :, 1]


def _worst(got, want, tol):
    """Largest |got - ref| / (atol + rtol |ref|)."""
    rtol, atol = tol
    want = want.double()
    return ((got.double() - want).abs() / (atol + rtol * want.abs())
            ).max().item()


def test_split_is_exact():
    """big has its low 13 bits clear, big + small == x exactly, |small| at
    most 2^-11 |x| (nearest rounding), ties away from zero."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(100_000) *
                          10.0 ** rng.integers(-6, 6, 100_000)
                          ).astype(np.float32))
    big = _build.tf32_big(x)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(big + (x - big), x)
    assert bool(((x - big).abs() <= x.abs() * 2.0 ** -11).all())
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)])
    assert torch.equal(_build.tf32_big(tie),
                       torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10)]))


@pytest.mark.parametrize("small", ["truncated", "rounded"])
@pytest.mark.parametrize("n,h", STAGES)
def test_sr_attention_3xtf32_holds_the_f32_limit(n, h, small):
    q, k, v = _sr_case(n + h, n, h)
    got = attention_emulated(q, k, v, 0.125, 3, small)
    want = sr_attention_ref(q.double(), k.double(), v.double(), 0.125)
    assert _worst(got, want, SR_TOL_F32) <= 0.5


@pytest.mark.parametrize("n,h", STAGES)
def test_sr_attention_1xtf32_fails_the_f32_limit(n, h):
    q, k, v = _sr_case(n + h, n, h)
    got = attention_emulated(q, k, v, 0.125, 1, "truncated")
    want = sr_attention_ref(q.double(), k.double(), v.double(), 0.125)
    assert _worst(got, want, SR_TOL_F32) > 2.0


def _growth_case(seed, b=1, h=12, w=16):
    """x and the five convs at torch's default conv init, as chip_smoke's
    drdb_inputs draws them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 64, h, w), generator=g)
    dconvs = []
    for t in range(5):
        cin = 64 + 32 * t
        bnd = (cin * 9) ** -0.5
        dconvs.append(((torch.rand((32, cin, 3, 3), generator=g) * 2 - 1)
                       * bnd, (torch.rand((32,), generator=g) * 2 - 1)
                       * bnd))
    return x, dconvs


def growth_emulated(x, dconvs, terms, small):
    """The f32 growth kernel's arithmetic: each conv an implicit GEMM over
    16-channel chunks, per chunk 9 taps x 2 k8 steps (``mm``), then bias
    and relu in f32; conv t reads x and the emulated r1..r_{t-1}."""
    feat, rs = x, []
    for w, bias in dconvs:
        cin = feat.shape[1]
        cols = F.unfold(feat, 3, dilation=2, padding=2)   # [B, cin*9, HW]
        cols = cols.view(x.shape[0], cin // 16, 16, 9, -1)
        # K in the kernel's order: chunk, tap, channel
        a = cols.permute(0, 4, 1, 3, 2).reshape(x.shape[0], -1, cin * 9)
        wk = w.view(32, cin // 16, 16, 9).permute(1, 3, 2, 0).reshape(
            cin * 9, 32)
        y = torch.relu(mm(a, wk, terms, small) + bias)      # [B, HW, 32]
        r = y.transpose(1, 2).reshape(x.shape[0], 32, *x.shape[2:])
        rs.append(r)
        feat = torch.cat([feat, r], 1)
    return rs


@pytest.mark.parametrize("small", ["truncated", "rounded"])
def test_growth_3xtf32_holds_the_f32_limit(small):
    x, dconvs = _growth_case(3)
    got = growth_emulated(x, dconvs, 3, small)
    want = tdrdb.drdb_growth_ref(x.double(), [(w.double(), b.double())
                                              for w, b in dconvs])
    for g, e in zip(got, want):
        assert _worst(g, e, GROWTH_TOL_F32) <= 0.5


def test_growth_1xtf32_fails_the_f32_limit():
    x, dconvs = _growth_case(3)
    got = growth_emulated(x, dconvs, 1, "truncated")
    want = tdrdb.drdb_growth_ref(x.double(), [(w.double(), b.double())
                                              for w, b in dconvs])
    assert max(_worst(g, e, GROWTH_TOL_F32) for g, e in zip(got, want)) > 2.0


def test_f32_growth_packing_by_index_formula():
    """Conv t's weight (n, k, ky, kx), k = 16 c + 4 gr + e, as the f32
    growth kernel reads it: the big half at base_t + 9216 c + 512 tap +
    128 gr + 4 n + e, a TF32 value, and the small half 4608 elements on;
    base_t = 18432 (2 + 3 + ... ) over the earlier convs."""
    x, dconvs = _growth_case(4)
    wpk = tdrdb.pack_growth_weights(dconvs, torch.float32).numpy()
    assert wpk.shape == (tdrdb.growth_numel(torch.float32),) == (368640,)
    base = 0
    for t, (w, _) in enumerate(dconvs):
        w = w.numpy()
        n, k, ky, kx = np.meshgrid(np.arange(32), np.arange(w.shape[1]),
                                   np.arange(3), np.arange(3), indexing="ij")
        c, kc = k // 16, k % 16
        flat = base + 9216 * c + 512 * (3 * ky + kx) + 128 * (kc // 4) \
            + 4 * n + kc % 4
        big, small = wpk[flat], wpk[flat + 4608]
        np.testing.assert_array_equal(
            big, _build.tf32_big(torch.from_numpy(w)).numpy())
        np.testing.assert_array_equal(big + small, w)
        base += 18432 * (2 + t)
    assert base == wpk.size


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_f32_growth_packing_round_trip(dtype):
    """``unpack_growth`` sums the halves back to the weights exactly; the
    biases come back as packed."""
    _, dconvs = _growth_case(5)
    dconvs = [(w.to(dtype), b.to(dtype)) for w, b in dconvs]
    back = tdrdb.unpack_growth(tdrdb.pack_growth(dconvs, dtype), dtype)
    for (w, b), (wu, bu) in zip(dconvs, back):
        assert wu.dtype == dtype and torch.equal(w, wu)
        assert torch.equal(b.double(), bu.double())
