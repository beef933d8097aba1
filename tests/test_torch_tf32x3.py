"""The f32 kernels' 3xTF32 arithmetic, emulated in plain PyTorch on the CPU.

The f32 sr-attention, DRDB tail, FFM grams and FFM apply (mma.sync
m16n8k8 .tf32) and the DRDB growth (wgmma .tf32) kernels split each f32
operand a into big = a rounded to TF32 (10 mantissa bits; nearest, ties
away from zero) and small = a - big, and compute each product as
big*big + big*small + small*big in f32 accumulators; the tensor cores
read small as TF32, its low 13 bits ignored ("truncated"). Here the same
arithmetic runs in torch (``mm``): the products of each group of k8 steps
that the kernel sends into one fresh accumulator summed exactly (f64) and
added to an f32 sum (sr-attention and the growth here per k8 step; the
tail per 32-channel chunk, the apply per product and the grams per
16-token tile, as their kernels do, with the tensor cores' adds inside
one rounded toward zero). Each emulation is held against an f64
reference within half of chip_smoke.py's f32 limits (SR_TOL["float32"]:
atol 1e-5; GROWTH_TOL and TAIL_TOL["float32"]: rtol and atol 1e-4;
APPLY_TOL["float32"]: atol 1e-4; GRAM_RTOL["float32"]: 1e-5 of the
largest entry), with small fed truncated and, as the alternative, rounded
(both hold: the sr-attention cases read up to 0.055 of the limit, the
growth 0.005, the tail 0.003, the apply 0.035, the grams 0.11); a 1xTF32
version (big*big alone) must exceed the same limits twice over (it reads
27-112x, 3.4-5.2x, 3.2-3.9x, 15-17x and 15x), so the limits tell
the two apart. The apply's and the grams' chained products take the
accumulator's columns 2t, 2t + 1 as mma k = t, t + 4, and the other
operand's rows likewise (the grams' k is the token); rows read in the
plain order fail. The grams need their fresh accumulators: chained over a
warp's tiles they drift past the limit. Also the f32 growth packing (big
and small halves, 16-channel chunks) and the tail's ([n][k]) by their
index formulas and round trips, the grams' staged W^T fragments, and the
f32 tail's and apply's shared-memory layouts as the kernels read them
(each read finds its element, in 32 distinct banks).

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
from segmif_tpu_torch.kernels import ffm as tffm
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


def trunc_f32(x: torch.Tensor) -> torch.Tensor:
    """An f64 tensor to f32 rounded toward zero: how the tensor cores add
    a product into their f32 accumulator."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mm(a: torch.Tensor, b: torch.Tensor, terms: int, small: str,
       fold: int = 1, acc: torch.Tensor = None, truncate: bool = False):
    """a [..., M, K] @ b [..., K, N], f32, as the kernels compute it: per
    ``fold`` k8 steps the TF32 products (3xTF32: small*big, big*small,
    big*big; 1xTF32: big*big of the operands rounded to TF32) summed into
    a fresh accumulator, exactly or, with ``truncate``, one mma (one
    product of one k8 step) at a time rounded toward zero as the tensor
    cores add; the fresh accumulator is then added to the f32 sum
    (``acc``, zero when not given: a chained product goes on adding to
    the sum of the one before), rounded to nearest."""
    ab, as_ = split(a, small)
    bb, bs = split(b, small)
    pairs = ([(as_, bb), (ab, bs), (ab, bb)] if terms == 3 else [(ab, bb)])
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    step = 8 * fold
    for k0 in range(0, a.shape[-1], step):
        part = torch.zeros_like(acc, dtype=torch.float64)
        for k1 in range(k0, min(k0 + step, a.shape[-1]), 8):
            for x, y in pairs:
                p = x[..., k1:k1 + 8].double() @ y[..., k1:k1 + 8, :].double()
                part = (trunc_f32(part + p).double() if truncate
                        else part + p)
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


def _worst(got, want, tol, x=None):
    """Largest |got - ref| / (atol + rtol (|ref| + |ref - x|)), the last
    term only when x is given (chip_smoke.worst)."""
    rtol, atol = tol
    want = want.double()
    ref = want.abs() if x is None else want.abs() + (want - x.double()).abs()
    return ((got.double() - want).abs() / (atol + rtol * ref)).max().item()


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


# ------------------------------------------------------------ the f32 tail

TAIL_TOL_F32 = (1e-4, 1e-4)       # chip_smoke.TAIL_TOL["float32"]
APPLY_TOL_F32 = (0.0, 1e-4)       # chip_smoke.APPLY_TOL["float32"]


def _tail_case(seed, b=1, h=12, w=16):
    """x, r1..r5 (relu'd, as the growth leaves them) and the bottleneck at
    torch's default conv init, as chip_smoke's drdb_inputs draws it."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 64, h, w), np.float32))
    rs = [torch.relu(torch.from_numpy(
        rng.standard_normal((b, 32, h, w), np.float32))) for _ in range(5)]
    bnd = 224 ** -0.5
    wb = torch.from_numpy(rng.uniform(-bnd, bnd, (64, 224, 1, 1)
                                      ).astype(np.float32))
    bb = torch.from_numpy(rng.uniform(-bnd, bnd, 64).astype(np.float32))
    return x, rs, wb, bb


def tail_emulated(x, rs, wb, bb, terms, small):
    """The f32 tail kernel's arithmetic: per pixel the row [x, r1..r5]
    (224 channels) times the bottleneck as ``pack_tail_weights`` packs it
    ([n][k], read as the B operand), 28 k8 steps, each 32-channel chunk's
    products into a fresh accumulator, one mma at a time rounded toward
    zero (``mm``, fold 4, truncating), then bias, relu and the residual in
    f32."""
    b, _, h, w = x.shape
    a = torch.cat([x, *rs], 1).permute(0, 2, 3, 1).reshape(-1, 224)
    wk = tdrdb.pack_tail_weights(wb, torch.float32)          # [n][k]
    y = mm(a, wk.t(), terms, small, fold=4, truncate=True)
    out = a[:, :64] + torch.relu(y + bb)
    return out.reshape(b, h, w, 64).permute(0, 3, 1, 2)


def _tail_want(x, rs, wb, bb):
    return tdrdb.drdb_tail_ref(x.double(), [r.double() for r in rs],
                               wb.double(), bb.double())


@pytest.mark.parametrize("small", ["truncated", "rounded"])
def test_tail_3xtf32_holds_the_f32_limit(small):
    x, rs, wb, bb = _tail_case(6)
    got = tail_emulated(x, rs, wb, bb, 3, small)
    assert _worst(got, _tail_want(x, rs, wb, bb), TAIL_TOL_F32, x) <= 0.5


def test_tail_1xtf32_fails_the_f32_limit():
    x, rs, wb, bb = _tail_case(6)
    got = tail_emulated(x, rs, wb, bb, 1, "truncated")
    assert _worst(got, _tail_want(x, rs, wb, bb), TAIL_TOL_F32, x) > 2.0


def test_f32_tail_packing_by_index_formula():
    """The bottleneck's weight (n, k) at n * 224 + k of the f32 pack, and,
    as the kernel stages it (granule c of row n at c ^ (n % 8), 896-byte
    rows), where each lane's B reads find it: b0 = W[n][8 s + t], b1 =
    W[n][8 s + t + 4] for lane (g, t) and n = 8 nt + g, in 32 distinct
    banks for every k8 step s and n8 tile nt."""
    _, _, wb, _ = _tail_case(7)
    wpk = tdrdb.pack_tail_weights(wb, torch.float32)
    assert wpk.shape == (64, 224) and wpk.is_contiguous()
    flat = wpk.reshape(-1).numpy()
    w = wb.reshape(64, 224).numpy()
    n, k = np.meshgrid(np.arange(64), np.arange(224), indexing="ij")
    np.testing.assert_array_equal(flat[n * 224 + k], w)
    # the kernel's shared-memory rows (floats), staged granule by granule
    smem = np.full(64 * 224, np.nan, np.float32)
    for row in range(64):
        for c in range(56):
            dst = row * 224 + 4 * (c ^ (row % 8))
            smem[dst:dst + 4] = flat[row * 224 + 4 * c:row * 224 + 4 * c + 4]
    assert not np.isnan(smem).any()
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for s_ in range(28):
        for nt in range(8):
            rows = 8 * nt + g
            for gran, kk in ((2 * s_, 8 * s_ + t),
                             (2 * s_ + 1, 8 * s_ + t + 4)):
                at = rows * 224 + 4 * (gran ^ g) + t
                np.testing.assert_array_equal(smem[at], w[rows, kk])
                assert len(set(at % 32)) == 32


def test_f32_tail_a_reads_are_free_of_bank_conflicts():
    """The A fragment reads of the f32 tail from a TMA box (64 pixels x 32
    channels, 128-byte rows under the 128-byte swizzle: granule c of row p
    at c ^ (p % 8)): lane (g, t) of warp lw reads pixel 16 lw + g (and + 8)
    at channels 8 (s % 4) + t and + 4; each read is the channel asked for
    and the 32 lanes hit 32 distinct banks."""
    box = np.arange(64 * 32).reshape(64, 32)     # value = 32 p + channel
    smem = np.empty(64 * 32, np.int64)
    for p in range(64):
        for c in range(8):
            smem[p * 32 + 4 * (c ^ (p % 8)):][:4] = box[p, 4 * c:4 * c + 4]
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for lw in range(4):
        for row in (16 * lw + g, 16 * lw + g + 8):
            for q in range(4):                   # s % 4
                for gran, ch in ((2 * q, 8 * q + t),
                                 (2 * q + 1, 8 * q + t + 4)):
                    at = row * 32 + 4 * (gran ^ g) + t
                    np.testing.assert_array_equal(smem[at], 32 * row + ch)
                    assert len(set(at % 32)) == 32


def test_f32_tail_pack_is_a_copy():
    """The f32 tail pack owns its storage: ``DRDB.kernel_weights`` keeps
    it, the optimizer then updates the weight in place, and the model is
    deep-copied after (``make_fuse_fn``); a no-grad view of the weight
    would make that copy fail."""
    import copy

    from segmif_tpu_torch.models.fusion import DRDB

    block = DRDB()
    _, (wpk, _) = block.kernel_weights(torch.float32)
    assert not wpk._is_view()
    assert wpk.data_ptr() != block.conv.weight.data_ptr()
    with torch.no_grad():
        block.conv.weight.add_(1.0)
    copied = copy.deepcopy(block)
    assert torch.equal(copied.conv.weight, block.conv.weight)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_f32_tail_packing_round_trip(dtype):
    """``unpack_tail`` gives the bottleneck back exactly, the bias as
    packed."""
    _, _, wb, bb = _tail_case(8)
    wb, bb = wb.to(dtype), bb.to(dtype)
    wu, bu = tdrdb.unpack_tail(tdrdb.pack_tail(wb, bb, dtype), dtype)
    assert wu.dtype == dtype and torch.equal(wu, wb)
    assert torch.equal(bu.double(), bb.double())


# ------------------------------------------------------------ the f32 apply

def _k_order():
    """The k order of the f32 apply's mma steps: in k8 step j, mma k = t
    (t < 4) stands for column 8 j + 2 t and k = t + 4 for 8 j + 2 t + 1,
    where an m16n8 accumulator holds columns 2 t and 2 t + 1."""
    return torch.tensor([8 * j + 2 * t + h for j in range(8)
                         for h in (0, 1) for t in range(4)])


def _apply_case(seed, b=2, n=200):
    """Pass B's operands as chip_smoke draws them: x1, x2, s [B, N, 64],
    the picked projection halves w [3, 64, 64] and b [3, 64]
    (``_halves``), mats [B, 4, 64, 64], be [2, 64], lnp [2, 2, 64]."""
    rng = np.random.default_rng(seed)

    def r(shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std
                                 ).astype(np.float32))

    xs = [r((b, n, 64)) for _ in range(3)]
    w, bias = tffm._halves(r((3, 64, 128), 64 ** -0.5), r((3, 128), 0.1),
                           torch.float32, tffm._APPLY_PICKS)
    lnp = torch.stack([torch.stack([1 + r((64,), 0.1), r((64,), 0.1)])
                       for _ in range(2)])
    return xs, w, bias, r((b, 4, 64, 64), 0.125), r((2, 64), 0.1), lnp


def apply_emulated(x1, x2, s, w, bias, mats, be, lnp, terms, small,
                   b_order=None):
    """The f32 apply kernel's arithmetic: tokens in 16-row tiles (the
    ragged last one zero-filled and dropped), each of the seven products
    as ``mm`` with a fresh accumulator of its own (fold 8: its 8 k8 steps,
    one mma at a time rounded toward zero), A's columns and
    the matrix's rows in the chained k order (``_k_order``; ``b_order``
    reads the matrix's rows in another), y3 M0 + u1 M1 and y3 M2 + u2 M3
    on one accumulator each, then the residual, be and the LayerNorm in
    f32."""
    order = _k_order()
    b_order = order if b_order is None else b_order
    n = x1.shape[1]
    pad = (-n) % 16

    def tiles(t):
        return torch.cat([t, t.new_zeros(pad, 64)])

    def prod(a, m, acc=None):
        return mm(a[:, order], m[b_order], terms, small, fold=8, acc=acc,
                  truncate=True)

    outs = ([], [])
    for i in range(x1.shape[0]):
        a1, a2, a3 = tiles(x1[i]), tiles(x2[i]), tiles(s[i])
        y3 = torch.relu(prod(a3, w[0]) + bias[0])
        for o, (xi, wi, m0, m1) in enumerate(((a1, 1, 0, 1), (a2, 2, 2, 3))):
            u = torch.relu(prod(xi, w[wi]) + bias[wi])
            acc = prod(u, mats[i, m1], acc=prod(y3, mats[i, m0]))
            t = xi + (acc + be[o])
            outs[o].append(tffm._layer_norm(t, lnp[o, 0], lnp[o, 1])[:n])
    return torch.stack(outs[0]), torch.stack(outs[1])


def _apply_want(x1, x2, s, w, bias, mats, be, lnp):
    """Pass B's plain maths (``_apply_plain``) in f64."""
    d = [t.double() for t in (x1, x2, s, w, bias, mats, be, lnp)]
    x1, x2, s, w, bias, mats, be, lnp = d
    y3 = torch.relu(s @ w[0] + bias[0])
    u1 = torch.relu(x1 @ w[1] + bias[1])
    u2 = torch.relu(x2 @ w[2] + bias[2])
    o1 = y3 @ mats[:, 0] + u1 @ mats[:, 1] + be[0]
    o2 = y3 @ mats[:, 2] + u2 @ mats[:, 3] + be[1]
    return (tffm._layer_norm(x1 + o1, lnp[0, 0], lnp[0, 1]),
            tffm._layer_norm(x2 + o2, lnp[1, 0], lnp[1, 1]))


@pytest.mark.parametrize("small", ["truncated", "rounded"])
def test_apply_3xtf32_holds_the_f32_limit(small):
    (x1, x2, s), *ws = _apply_case(9)
    got = apply_emulated(x1, x2, s, *ws, 3, small)
    for g, e in zip(got, _apply_want(x1, x2, s, *ws)):
        assert g.shape == (2, 200, 64)
        assert _worst(g, e, APPLY_TOL_F32) <= 0.5


def test_apply_1xtf32_fails_the_f32_limit():
    (x1, x2, s), *ws = _apply_case(9)
    got = apply_emulated(x1, x2, s, *ws, 1, "truncated")
    assert max(_worst(g, e, APPLY_TOL_F32)
               for g, e in zip(got, _apply_want(x1, x2, s, *ws))) > 2.0


def test_apply_k_order_must_match_in_a_and_b():
    """The chained k order holds only when the matrix's rows follow A's
    columns: rows read in the plain fragment order (k = t is row 8 j + t)
    against A's chained columns fail the f32 limit."""
    (x1, x2, s), *ws = _apply_case(10)
    got = apply_emulated(x1, x2, s, *ws, 3, "truncated",
                         b_order=torch.arange(64))
    assert max(_worst(g, e, APPLY_TOL_F32)
               for g, e in zip(got, _apply_want(x1, x2, s, *ws))) > 2.0


def _swz(row, col):
    """ffm.cu's swz: float index of (row, col) in [rows][64] f32 with
    granule c of row r at c ^ 2 (r % 4)."""
    return row * 64 + (((col >> 2) ^ (2 * (row & 3))) << 2) + (col & 3)


def test_f32_apply_shared_memory_reads():
    """The f32 apply's staged matrices ([k][n] transposed into [n][k]
    under ``swz``) and token tiles ([16][64] under ``swz``): each lane's
    8-byte B read (b0 = M[8 j + 2 t][n], b1 = M[8 j + 2 t + 1][n], n = 8
    nt + g) and A read (X[g or g + 8][8 j + 2 t], + 1) finds those
    elements, and the four rows of each half-warp fall in 32 distinct
    banks."""
    m = np.arange(64 * 64).reshape(64, 64)        # [k][n], value 64 k + n
    smem = np.full(64 * 64, -1)
    for k in range(64):
        for n in range(64):
            smem[_swz(n, k)] = m[k, n]
    assert (np.sort(smem) == np.arange(64 * 64)).all()
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for j in range(8):
        for nt in range(8):
            at = _swz(8 * nt + g, 8 * j + 2 * t)
            np.testing.assert_array_equal(smem[at], m[8 * j + 2 * t,
                                                      8 * nt + g])
            np.testing.assert_array_equal(smem[at + 1],
                                          m[8 * j + 2 * t + 1, 8 * nt + g])
            for half in (slice(0, 16), slice(16, 32)):
                banks = np.concatenate([at[half] % 32, (at[half] + 1) % 32])
                assert len(set(banks)) == 32
        for rows in (g, g + 8):                   # the token tile as A
            at = _swz(rows, 8 * j + 2 * t)
            for half in (slice(0, 16), slice(16, 32)):
                banks = np.concatenate([at[half] % 32, (at[half] + 1) % 32])
                assert len(set(banks)) == 32


# ------------------------------------------------------------ the f32 grams

GRAM_RTOL_F32 = 1e-5              # chip_smoke.GRAM_RTOL["float32"]


def _token_order(tiles: int = 1, order=None):
    """The gram's k order over ``tiles`` 16-token tiles: in the tile's k8
    step j, mma k = t (t < 4) stands for token 8 j + 2 t and k = t + 4 for
    8 j + 2 t + 1, where the projection's accumulator holds tokens 2 t and
    2 t + 1 (``order``: another order within a tile)."""
    if order is None:
        order = torch.tensor([8 * j + 2 * t + h for j in range(2)
                              for h in (0, 1) for t in range(4)])
    return torch.cat([16 * i + order for i in range(tiles)])


def _grams_case(seed, b=2, n=3000):
    """Pass A's operands as chip_smoke draws them: x1, x2, s [B, N, 64],
    the picked projection halves w [3, 64, 64] and b [3, 64]
    (``_halves``)."""
    rng = np.random.default_rng(seed)

    def r(shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std
                                 ).astype(np.float32))

    xs = [r((b, n, 64)) for _ in range(3)]
    w, bias = tffm._halves(r((3, 64, 128), 64 ** -0.5), r((3, 128), 0.1),
                           torch.float32, tffm._GRAM_PICKS)
    return xs, w, bias


def grams_emulated(x1, x2, s, w, bias, terms, small, chunk=1024, warps=8,
                   b_order=None, fresh=True):
    """The f32 grams kernel's arithmetic: r = relu(x w + b) per token
    (``mm``: its 8 k8 steps in one fresh accumulator, one mma at a time
    rounded toward zero), tokens past N zero; per (image, chunk of
    ``chunk`` tokens, projection) warp i of ``warps`` walks the chunk's
    16-token tiles i, i + warps, ...; each tile's r^T r (k the tile's
    tokens in the chained order, ``_token_order``; ``b_order`` reads r's
    rows in another) goes into a fresh accumulator (``mm``, fold 2:
    the tile's two k8 steps, truncating) added to the warp's f32 sum
    (``fresh`` False: all of a warp's tiles chained on one accumulator);
    the warps' sums added in warp order, then the chunks' in chunk order.
    x_i [B, N, 64], w [3, 64, 64], bias [3, 64] -> [B, 3, 64, 64]."""
    n = x1.shape[1]
    out = torch.zeros(x1.shape[0], 3, 64, 64)
    for q, x in enumerate((x1, x2, s)):
        r = torch.relu(mm(x, w[q], terms, small, fold=8, truncate=True)
                       + bias[q])
        r = torch.cat([r, r.new_zeros(r.shape[0], (-n) % 16, 64)], 1)
        tiles = r.unflatten(1, (-1, 16))             # [B, T, 16, 64]
        per = chunk // 16
        for t0 in range(0, tiles.shape[1], per):
            block = None
            for i in range(warps):
                mine = tiles[:, t0 + i:t0 + per:warps]
                if mine.shape[1] == 0:
                    continue
                k = mine.shape[1]
                a = mine.flatten(1, 2)[:, _token_order(k)]
                bb = mine.flatten(1, 2)[:, _token_order(k, b_order)]
                g = mm(a.transpose(1, 2), bb, terms, small,
                       fold=2 if fresh else 2 * k, truncate=True)
                block = g if block is None else block + g
            out[:, q] = out[:, q] + block
    return out


def _grams_want(x1, x2, s, w, bias):
    """Pass A's plain maths (``_grams_plain``) in f64."""
    return tffm._grams_plain(x1.double(), x2.double(), s.double(),
                             w.double(), bias.double())


def _gram_err(got, want):
    """Largest |got - ref| over the largest |ref| (chip_smoke's gram
    check)."""
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("small", ["truncated", "rounded"])
def test_grams_3xtf32_holds_the_f32_limit(small):
    """Two images of 3000 tokens (a ragged last tile) in chunks of 1024:
    the emulation reads about 0.1 of the limit."""
    xs, w, bias = _grams_case(11)
    got = grams_emulated(*xs, w, bias, 3, small)
    assert got.shape == (2, 3, 64, 64)
    assert _gram_err(got, _grams_want(*xs, w, bias)) <= 0.5 * GRAM_RTOL_F32


def test_grams_1xtf32_fails_the_f32_limit():
    """W rounded to TF32 moves every token's projection alike: 1xTF32
    reads about 15 times the limit."""
    xs, w, bias = _grams_case(11)
    got = grams_emulated(*xs, w, bias, 1, "truncated")
    assert _gram_err(got, _grams_want(*xs, w, bias)) > 2 * GRAM_RTOL_F32


def test_grams_token_order_must_match_in_a_and_b():
    """The gram's k is the token: r's rows read in the plain fragment
    order (k = t is token 8 j + t) against r^T's chained columns pair
    different tokens and fail the limit."""
    xs, w, bias = _grams_case(12, b=1, n=1000)
    got = grams_emulated(*xs, w, bias, 3, "truncated",
                         b_order=torch.arange(16))
    assert _gram_err(got, _grams_want(*xs, w, bias)) > 2 * GRAM_RTOL_F32


def test_grams_need_fresh_accumulators():
    """One warp over 188 tiles (a main-path warp walks about 110): chained
    on one accumulator through the tensor cores' truncating adds, its
    gram drifts beyond the limit; a fresh accumulator per tile holds half
    of it."""
    xs, w, bias = _grams_case(13, b=1)
    want = _grams_want(*xs, w, bias)
    kw = {"chunk": 3008, "warps": 1}
    assert _gram_err(grams_emulated(*xs, w, bias, 3, "truncated", **kw),
                     want) <= 0.5 * GRAM_RTOL_F32
    assert _gram_err(grams_emulated(*xs, w, bias, 3, "truncated",
                                    fresh=False, **kw), want) > GRAM_RTOL_F32


def test_f32_grams_w_fragments_by_index_formula():
    """The f32 grams kernel stages W^T's A fragments in shared memory:
    float i of a half holds element f = i % 4 of lane l = (i / 4) % 32 in
    m16 tile m and k8 step j (mj = i / 128 = 8 m + j), W^T[o][k] = w[k][o]
    at o = 16 m + g + 8 (f % 2), k = 8 j + 2 t + f / 2 for lane (g, t):
    the A fragment (a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3
    = A[g + 8][t + 4]) with mma k = t standing for channel 8 j + 2 t and
    k = t + 4 for 8 j + 2 t + 1, x's chained order. Every (k, o) is
    staged once, and m16 tile m, k8 step j holds rows 16 m .. 16 m + 15
    and channels 8 j .. 8 j + 7."""
    i = np.arange(64 * 64)
    f, lane, mj = i % 4, (i // 4) % 32, i // 128
    g, t = lane // 4, lane % 4
    m, j = mj // 8, mj % 8
    k = 8 * j + 2 * t + f // 2
    o = 16 * m + g + 8 * (f % 2)
    assert len(set(zip(k, o))) == 64 * 64
    assert ((o // 16 == m) & (k // 8 == j)).all()
    # A's element (row, column) of the mma, and the channel column stands for
    row = g + 8 * (f % 2)
    col = t + 4 * (f // 2)
    np.testing.assert_array_equal(o, 16 * m + row)
    np.testing.assert_array_equal(k, 8 * j + 2 * (col % 4) + col // 4)
