"""The port's kernel modules (plain versions, CPU) against the JAX package.

Same numpy-seeded inputs through both sides, f32. The Pallas kernels run
in interpret mode, as tests/test_kernels.py runs them on the CPU.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segmif_tpu.kernels import pallas_attention as pa
from segmif_tpu.kernels import pallas_drdb as pd
from segmif_tpu.kernels import pallas_drdb_tail as pdt
from segmif_tpu.kernels import pallas_ffm as pf
from segmif_tpu.kernels.pallas_drdb import drdb_xla
from segmif_tpu_torch.convert import _conv
from segmif_tpu_torch.kernels import drdb as tdrdb
from segmif_tpu_torch.kernels import ffm as tffm
from segmif_tpu_torch.kernels.attention import sr_attention
from segmif_tpu_torch.kernels.drdb import drdb_chain

C = 64


def _interpret(monkeypatch, mod):
    orig = mod.pl.pallas_call
    monkeypatch.setattr(mod.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n,m,h,d", [
    (512, 128, 2, 64),     # aligned
    (300, 300, 8, 64),     # stage-4-like: N and M both unaligned
    (1200, 300, 5, 64),    # stage-3-like
    (256, 1980, 1, 64),    # 1080p stage-1 key count: many key tiles
])
def test_sr_attention_matches_pallas(monkeypatch, n, m, h, d):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, n, h, d), (1, m, h, d), (1, m, h, d)))
    scale = d ** -0.5
    _interpret(monkeypatch, pa)
    expect = pa._sr_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale)
    got = sr_attention(_t(q), _t(k), _t(v), scale)   # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-5)


def _ffm_arrays(seed, b, n):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, n, C)).astype(np.float32)
          for _ in range(3)]
    wp = (rng.standard_normal((3, C, 2 * C)) * 0.1).astype(np.float32)
    bp = (rng.standard_normal((3, 2 * C)) * 0.1).astype(np.float32)
    return rng, xs, wp, bp


@pytest.mark.parametrize("n", [200, 256])  # 200: not a multiple of the tile
def test_grams_match_pallas(monkeypatch, n):
    _, (x1, x2, s), wp, bp = _ffm_arrays(1, 2, n)
    _interpret(monkeypatch, pf)
    monkeypatch.setattr(pf, "TILE_N", 64)
    expect = np.asarray(pf._grams_pallas(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s), jnp.asarray(wp),
        jnp.asarray(bp[:, None, :])))
    got = tffm.crosspath_grams(_t(x1), _t(x2), _t(s), _t(wp), _t(bp)).numpy()
    # the port returns the three blocks the contexts read
    for i, blk in ((0, np.s_[:C, :C]), (1, np.s_[:C, :C]),
                   (2, np.s_[C:, C:])):
        np.testing.assert_allclose(got[:, i], expect[:, i][(slice(None),)
                                                           + blk],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [200, 256])
def test_apply_rows_match_pallas(monkeypatch, n):
    rng, (x1, x2, s), wp, bp = _ffm_arrays(2, 2, n)
    mats = (rng.standard_normal((2, 4, C, C)) * 0.1).astype(np.float32)
    be = (rng.standard_normal((2, C)) * 0.1).astype(np.float32)
    lnp = np.stack([np.stack([1 + 0.1 * rng.standard_normal(C),
                              0.1 * rng.standard_normal(C)])
                    for _ in range(2)]).astype(np.float32)
    # the TPU kernel takes the contexts zero-padded to [2C, C]: M0 and M2
    # read the y3 half of r3, M1 and M3 the u half of r1 / r2
    padded = np.zeros((2, 4, 2 * C, C), np.float32)
    padded[:, 0, :C], padded[:, 1, C:] = mats[:, 0], mats[:, 1]
    padded[:, 2, :C], padded[:, 3, C:] = mats[:, 2], mats[:, 3]
    _interpret(monkeypatch, pf)
    monkeypatch.setattr(pf, "TILE_N", 64)
    e1, e2 = pf._apply_pallas(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s), jnp.asarray(wp),
        jnp.asarray(bp[:, None, :]), jnp.asarray(padded), jnp.asarray(be),
        jnp.asarray(lnp))
    g1, g2 = tffm.crosspath_apply_rows(_t(x1), _t(x2), _t(s), _t(wp),
                                       _t(bp), _t(mats), _t(be), _t(lnp))
    np.testing.assert_allclose(g1.numpy(), np.asarray(e1), atol=3e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(e2), atol=3e-5)


def _crosspath_weights(seed):
    rng = np.random.default_rng(seed)
    w = {}
    for i in (1, 2, 3):
        w[f"wp{i}"] = rng.standard_normal((C, 2 * C)) * 0.1
        w[f"bp{i}"] = rng.standard_normal(2 * C) * 0.1
        w[f"wkv{i}"] = rng.standard_normal((C, 2 * C)) * 0.05
    for i in (1, 2):
        w[f"we{i}"] = rng.standard_normal((2 * C, C)) * 0.1
        w[f"be{i}"] = rng.standard_normal(C) * 0.1
        w[f"ln{i}_scale"] = 1 + 0.1 * rng.standard_normal(C)
        w[f"ln{i}_bias"] = 0.1 * rng.standard_normal(C)
    w = {k: v.astype(np.float32) for k, v in w.items()}
    xs = [rng.uniform(0, 1, (2, 8, 12, C)).astype(np.float32)
          for _ in range(3)]
    return w, xs


def test_crosspath_folded_ref_matches_xla():
    """Plain folded CrossPath vs crosspath_folded_xla, in the NHWC layout
    (rank-polymorphic like the JAX function)."""
    w, (x1, x2, s) = _crosspath_weights(3)
    scale = (C // 8) ** -0.5
    e1, e2 = pf.crosspath_folded_xla(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s),
        {k: jnp.asarray(v) for k, v in w.items()}, scale, 8)
    g1, g2 = tffm.crosspath_folded_ref(
        _t(x1), _t(x2), _t(s), {k: _t(v) for k, v in w.items()}, scale, 8)
    np.testing.assert_allclose(g1.numpy(), np.asarray(e1), atol=3e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(e2), atol=3e-5)


def test_crosspath_fused_assembly_matches_xla():
    """grams -> contexts -> unpadded folded mats -> apply (the CUDA path's
    assembly, with the plain passes on CPU) vs crosspath_folded_xla."""
    w, xs = _crosspath_weights(4)
    x1, x2, s = (x.reshape(2, -1, C) for x in xs)
    scale = (C // 8) ** -0.5
    e1, e2 = pf.crosspath_folded_xla(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(s),
        {k: jnp.asarray(v) for k, v in w.items()}, scale, 8)
    g1, g2 = tffm.crosspath_fused(
        _t(x1), _t(x2), _t(s), {k: _t(v) for k, v in w.items()}, scale, 8)
    np.testing.assert_allclose(g1.numpy(), np.asarray(e1), atol=3e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(e2), atol=3e-5)


def _drdb_params(rng):
    """JAX-layout DRDB params (HWIO kernels), f32, at a scale that keeps
    activations of order 1."""
    w = {}
    cin = C
    for i in range(5):
        w[f"dconv{i + 1}"] = {
            "kernel": rng.standard_normal((3, 3, cin, 32)).astype(np.float32)
            * np.float32(np.sqrt(2 / (9 * 32))),
            "bias": (0.1 * rng.standard_normal(32)).astype(np.float32)}
        cin += 32
    w["bottleneck"] = {
        "kernel": rng.standard_normal((1, 1, cin, C)).astype(np.float32)
        * np.float32(np.sqrt(2 / C)),
        "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    return w


def _jax_tree(w):
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
            for k, v in w.items()}


def _port_convs(w):
    """(five (OIHW weight, bias)), (bottleneck weight, bias)."""
    def conv(p):
        sd = {}
        _conv(p, "", sd)
        return sd["weight"], sd["bias"]

    return ([conv(w[f"dconv{i + 1}"]) for i in range(5)],
            conv(w["bottleneck"]))


def _nchw(a):
    """NHWC numpy -> NCHW view on channels_last memory (the trunk's)."""
    return _t(a).permute(0, 3, 1, 2)


def test_drdb_chain_matches_xla():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (2, 16, 20, C)).astype(np.float32)
    w = _drdb_params(rng)
    expect = drdb_xla(jnp.asarray(x), _jax_tree(w))
    dconvs, bottleneck = _port_convs(w)
    got = drdb_chain(_nchw(x), dconvs, bottleneck)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(expect), atol=3e-5)


@pytest.mark.parametrize("shape", [(2, 16, 20), (1, 9, 13)])
def test_drdb_growth_ref_matches_grouped_chain(shape):
    """The plain growth chain r1..r5 against the JAX package's grouped-wide
    formulation ``_growth_rs(..., dil=2)`` (conv-over-concat as per-source
    wide convs). f32; 3e-5 absolute plus 1e-5 relative: sums of up to
    9 x 192 products in another order, and r4, r5 grow to about 10 under
    these fan-out-scaled weights."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, shape + (C,)).astype(np.float32)
    w = _drdb_params(rng)
    jw = _jax_tree(w)
    expect = pd._growth_rs(
        jnp.asarray(x), [jw[f"dconv{i + 1}"]["kernel"] for i in range(5)],
        [jw[f"dconv{i + 1}"]["bias"] for i in range(5)], None, dil=2)
    dconvs, _ = _port_convs(w)
    got = tdrdb.drdb_growth(_nchw(x), dconvs)   # CPU: the plain version
    assert len(got) == 5
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(e), rtol=1e-5, atol=3e-5)


def test_drdb_tail_ref_matches_pallas_tail(monkeypatch):
    """The plain tail against the TPU kernel ``_tail_impl`` in interpret
    mode (it needs S*R*W divisible by 4096). f32; 1e-5: sums of 224
    products in another order, outputs of order 1."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 64, 64, C)).astype(np.float32)
    rs = [np.maximum(rng.standard_normal((1, 64, 64, 32)), 0
                     ).astype(np.float32) for _ in range(5)]
    w = _drdb_params(rng)["bottleneck"]
    _interpret(monkeypatch, pdt)
    expect = pdt._tail_impl(jnp.asarray(x), [jnp.asarray(r) for r in rs],
                            jnp.asarray(w["kernel"][0, 0]),
                            jnp.asarray(w["bias"]))
    _, (wb, bb) = _port_convs({"bottleneck": w, **{
        f"dconv{i + 1}": w for i in range(5)}})
    got = tdrdb.drdb_tail(_nchw(x), [_nchw(r) for r in rs], wb, bb)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(expect), atol=1e-5)


def test_drdb_block_matches_pallas_drdb(monkeypatch):
    """The whole plain DRDB (``drdb_block`` on the CPU: growth then tail)
    against the TPU whole-block kernel ``_drdb_pallas_impl`` in interpret
    mode, at a shape below one 96x128 tile (padded and masked at the true
    image border). f32; 3e-5 as the chain's test."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (2, 40, 48, C)).astype(np.float32)
    w = _drdb_params(rng)
    _interpret(monkeypatch, pd)
    expect = pd._drdb_pallas_impl(jnp.asarray(x), _jax_tree(w))
    dconvs, bottleneck = _port_convs(w)
    got = tdrdb.drdb_block(_nchw(x), dconvs, bottleneck)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(expect), atol=3e-5)


def _bf16_exact(t):
    """Round to bf16 values held in f32, so a bf16 packing is lossless."""
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drdb_growth_packing_as_the_kernel_reads_it(dtype):
    """The growth kernel's schedule, written out in torch: per conv, per
    input chunk (32 channels in bf16, 16 in f32) and per tap, the
    zero-padded input window times that chunk's packed [kc, 32] weights
    (f32: the big and small halves summed). Holds ``pack_growth_weights``'
    layouts ([tap][k granule][n][8] for bf16, [big, small][tap][k granule]
    [n][4] for f32) to the plain chain (f32 arithmetic on bf16-exact
    weights; 3e-5 as above). The 3xTF32 products themselves:
    tests/test_torch_tf32x3.py."""
    rng = np.random.default_rng(9)
    x = _t(rng.uniform(0, 1, (1, 11, 14, C)).astype(np.float32))
    dconvs, _ = _port_convs(_drdb_params(rng))
    dconvs = [(_bf16_exact(w), b) for w, b in dconvs]
    wpk = tdrdb.pack_growth_weights(dconvs, dtype).float()
    assert wpk.numel() == tdrdb.growth_numel(dtype)
    kc, gr = (32, 8) if dtype == torch.bfloat16 else (16, 4)
    halves = 1 if dtype == torch.bfloat16 else 2
    bias = torch.cat([b for _, b in dconvs])
    feat, off, got = x, 0, []
    h, wd = x.shape[1:3]
    for t in range(5):
        xp = F.pad(feat, (0, 0, 2, 2, 2, 2))
        acc = torch.zeros(x.shape[:3] + (32,))
        for c in range((64 + 32 * t) // kc):
            size = halves * 9 * kc * 32
            wc = wpk[off:off + size].reshape(halves, 9, kc // gr, 32, gr)
            off += size
            # -> [tap][k][n]
            wc = wc.sum(0).permute(0, 1, 3, 2).reshape(9, kc, 32)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                win = xp[:, 2 * ky:2 * ky + h, 2 * kx:2 * kx + wd,
                         kc * c:kc * c + kc]
                acc += win @ wc[tap]
        r = torch.relu(acc + bias[32 * t:32 * t + 32])
        got.append(r)
        feat = torch.cat([feat, r], -1)
    assert off == wpk.numel()
    want = tdrdb.drdb_growth_ref(x.permute(0, 3, 1, 2), dconvs)
    for g, e in zip(got, want):
        np.testing.assert_allclose(g.numpy(), e.permute(0, 2, 3, 1).numpy(),
                                   atol=3e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drdb_growth_packing_by_index_formula(dtype):
    """Every element of ``pack_growth_weights`` read back by its flat index
    equals the OIHW weight it stands for. Conv t, tap (ky, kx), output n,
    input channel k: in bf16 (chunks of 32, k = 32 c + 8 gr + e) at
    base_t + 9216 c + 1024 tap + 256 gr + 8 n + e ([chunk][tap][gr][n][8],
    the wgmma B operand); in f32 (chunks of 16, k = 16 c + 4 gr + e) the
    big half at base_t + 9216 c + 512 tap + 128 gr + 4 n + e and the small
    half 4608 on ([chunk][big, small][tap][gr][n][4]), the two summing to
    the weight; base_t counts the earlier convs' chunks."""
    rng = np.random.default_rng(11)
    dconvs, _ = _port_convs(_drdb_params(rng))
    if dtype == torch.bfloat16:
        dconvs = [(_bf16_exact(w), b) for w, b in dconvs]
    wpk = tdrdb.pack_growth_weights(dconvs, dtype).float().numpy()
    assert wpk.shape == (tdrdb.growth_numel(dtype),)
    base = 0
    for t, (w, _) in enumerate(dconvs):
        w = w.numpy()                            # [32, 64 + 32 t, 3, 3]
        n, k, ky, kx = np.meshgrid(np.arange(32), np.arange(w.shape[1]),
                                   np.arange(3), np.arange(3), indexing="ij")
        tap = 3 * ky + kx
        if dtype == torch.bfloat16:
            c, kc = k // 32, k % 32
            flat = base + 9216 * c + 1024 * tap + 256 * (kc // 8) + 8 * n \
                + kc % 8
            np.testing.assert_array_equal(wpk[flat], w)
        else:
            c, kc = k // 16, k % 16
            flat = base + 9216 * c + 512 * tap + 128 * (kc // 4) + 4 * n \
                + kc % 4
            np.testing.assert_array_equal(wpk[flat] + wpk[flat + 4608], w)
            bits = wpk[flat].view(np.int32)
            assert not (bits & 0x1FFF).any()     # big: a TF32 value
        base += 9216 * (2 + t) * (1 if dtype == torch.bfloat16 else 2)
    assert base == wpk.size


def test_drdb_kernel_weights_repack_only_when_a_weight_changes(
        monkeypatch):
    """``DRDB.kernel_weights`` packs once and returns the same packs until
    the dtype or a weight changes: it repacks after ``load_state_dict``,
    after ``.to(torch.bfloat16)`` and after an in-place weight edit, and
    not otherwise. The packs equal ``pack_growth`` / ``pack_tail``."""
    from segmif_tpu_torch.models import fusion

    calls = []
    real = fusion.pack_growth
    monkeypatch.setattr(fusion, "pack_growth",
                        lambda *a: calls.append(1) or real(*a))
    torch.manual_seed(0)
    block = fusion.DRDB()
    dconvs, (wb, bb) = block._weights()
    first = block.kernel_weights(torch.float32)
    want_g = tdrdb.pack_growth(dconvs, torch.float32)
    want_t = tdrdb.pack_tail(wb, bb, torch.float32)
    for got, want in zip(first, (want_g, want_t)):
        for g, e in zip(got, want):
            assert torch.equal(g, e)
    assert block.kernel_weights(torch.float32) is first
    with torch.no_grad():
        block(torch.rand(1, 64, 6, 7))           # a CPU forward: no pack
    assert block.kernel_weights(torch.float32) is first and len(calls) == 1

    sd = {k: v.clone() for k, v in block.state_dict().items()}
    sd["Dcov3.weight"][0, 0, 0, 0] += 1.0
    block.load_state_dict(sd)
    second = block.kernel_weights(torch.float32)
    assert second is not first and len(calls) == 2
    # conv 3's first element: f32 chunks of 16 channels, big and small
    # halves 4608 apart (test_drdb_growth_packing_by_index_formula)
    assert (second[0][0][9216 * 10] + second[0][0][9216 * 10 + 4608]
            == sd["Dcov3.weight"][0, 0, 0, 0])
    assert block.kernel_weights(torch.float32) is second

    with torch.no_grad():
        block.Dcov5.weight.mul_(2.0)
    third = block.kernel_weights(torch.float32)
    assert third is not second and len(calls) == 3
    assert torch.equal(third[0][0], tdrdb.pack_growth_weights(
        block._weights()[0], torch.float32))

    block.to(torch.bfloat16)
    fourth = block.kernel_weights(torch.bfloat16)
    assert fourth is not third and len(calls) == 4
    assert fourth[0][0].dtype == torch.bfloat16
    assert fourth[0][1].dtype == torch.float32
    assert block.kernel_weights(torch.bfloat16) is fourth and len(calls) == 4

    # new weight tensors put in place of the old ones (version 0 again)
    sd = {k: v.clone() for k, v in block.state_dict().items()}
    sd["Dcov1.bias"][0] += 1.0
    block.load_state_dict(sd, assign=True)
    fifth = block.kernel_weights(torch.bfloat16)
    assert fifth is not fourth and len(calls) == 5
    assert fifth[0][1][0] == sd["Dcov1.bias"][0].float()


def _tail_bf16_schedule(rows, wpk, bb):
    """The bf16 tail kernel on one 128-pixel tile, written out in torch.
    rows: [128, 224] (x's 64 channels, then r1..r5's 32). The TMA boxes
    land in shared memory as 16-byte chunks (8 channels) under the
    swizzle whose span is the box row: x's 128-byte rows at chunk c ^ (row
    % 8), each r_i's 64-byte rows at c ^ (row / 2 % 4). Lane l of warp w
    reads row 16 w + l % 16, chunk 2 ks + l / 16 of x (k16 step ks < 4),
    or chunk 2 kk + l / 16 of r_i (ks = 4 + 2 i + kk), at the kernel's
    swizzled address; the product runs against the [n][k] weights; the
    epilogue (bf16 rounding steps) overwrites x's elements in place, and
    the store un-swizzles the x box. Returns the [128, 64] output."""
    tp = rows.shape[0]
    x_box = torch.zeros((tp, 8, 8))               # [row][physical chunk][8]
    r_boxes = torch.zeros((5, tp, 4, 8))
    for p in range(tp):
        for c in range(8):
            x_box[p, c ^ (p % 8)] = rows[p, 8 * c:8 * c + 8]
        for i in range(5):
            for c in range(4):
                r_boxes[i, p, c ^ ((p // 2) % 4)] = \
                    rows[p, 64 + 32 * i + 8 * c:64 + 32 * i + 8 * c + 8]
    a = torch.zeros((tp, 224))
    for w in range(tp // 16):
        for lane in range(32):
            row, hi = 16 * w + lane % 16, lane // 16
            for ks in range(14):
                if ks < 4:
                    frag = x_box[row, (2 * ks + hi) ^ (row % 8)]
                else:
                    i, kk = divmod(ks - 4, 2)
                    frag = r_boxes[i, row, (2 * kk + hi) ^ ((row // 2) % 4)]
                a[row, 16 * ks + 8 * hi:16 * ks + 8 * hi + 8] = frag
    assert torch.equal(a, rows)
    acc = (a.double() @ wpk.double().t()).float()          # f32 accumulate
    y = (acc.bfloat16().float() + bb).bfloat16().float()
    for p in range(tp):
        for nt in range(8):
            xs = x_box[p, nt ^ (p % 8)]
            x_box[p, nt ^ (p % 8)] = (xs + torch.relu(
                y[p, 8 * nt:8 * nt + 8])).bfloat16().float()
    return torch.stack([torch.cat([x_box[p, nt ^ (p % 8)]
                                   for nt in range(8)]) for p in range(tp)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drdb_tail_packing_as_the_kernel_reads_it(dtype):
    """The tail kernel's product: the rows of x and r1..r5 side by side
    times the packed bottleneck ([n][k] in either dtype), bias,
    relu, residual; for bf16, on swizzled shared-memory tiles as
    ``_tail_bf16_schedule`` walks them, with the kernel's rounding steps,
    against the plain tail in bf16 within the card tests' bf16 tail limit
    (one bf16 step of the output and of the bottleneck term: the CPU's
    bf16 conv sums in another order, so a rounding may land one step
    away); for f32 against the plain tail (1e-5)."""
    rng = np.random.default_rng(10)
    x = _t(rng.standard_normal((2, 5, 7, C)).astype(np.float32))
    rs = [torch.relu(_t(rng.standard_normal((2, 5, 7, 32)
                                            ).astype(np.float32)))
          for _ in range(5)]
    _, (wb, bb) = _port_convs(_drdb_params(rng))
    wb = _bf16_exact(wb)
    wpk = tdrdb.pack_tail_weights(wb, dtype).float()
    w_kn = wpk.t()
    assert w_kn.shape == (224, C)
    if dtype == torch.float32:
        got = x + torch.relu(torch.cat([x, *rs], -1) @ w_kn + bb)
        want = tdrdb.drdb_tail_ref(x.permute(0, 3, 1, 2),
                                   [r.permute(0, 3, 1, 2) for r in rs], wb, bb)
        np.testing.assert_allclose(got.numpy(),
                                   want.permute(0, 2, 3, 1).numpy(),
                                   atol=1e-5)
        return
    x, rs, bb = _bf16_exact(x), [_bf16_exact(r) for r in rs], _bf16_exact(bb)
    rows = torch.cat([x, *rs], -1).reshape(-1, 224)
    tile = torch.zeros((128, 224))                # the TMA zero fill
    tile[:rows.shape[0]] = rows
    got = _tail_bf16_schedule(tile, wpk, bb)[:rows.shape[0]]
    bf = torch.bfloat16
    want = tdrdb.drdb_tail_ref(x.permute(0, 3, 1, 2).to(bf),
                               [r.permute(0, 3, 1, 2).to(bf) for r in rs],
                               wb.to(bf), bb.to(bf))
    want = want.permute(0, 2, 3, 1).reshape(-1, C).float()
    xr = x.reshape(-1, C)
    limit = 2 ** -10 + 2 ** -7 * (want.abs() + (want - xr).abs())
    assert bool(((got - want).abs() <= limit).all())
    assert (got != want).float().mean().item() < 0.01


def test_port_imports_no_jax():
    """Every module of segmif_tpu_torch imports in a fresh interpreter
    without pulling in jax, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import segmif_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'segmif_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'segmif_tpu'))\n"
        "assert len(mods) >= 13, mods\n"
        "assert 'segmif_tpu_torch.kernels.int8' in mods, mods\n"
        "assert {'segmif_tpu_torch.parallel.' + m for m in ('dist', "
        "'mesh', 'tensor', 'spatial', 'dryrun')} <= set(mods), mods\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_calls_no_library_attention_or_compile():
    """No source of segmif_tpu_torch calls PyTorch's fused attention or
    torch.compile: the kernels on its path are its own."""
    from pathlib import Path

    import segmif_tpu_torch

    root = Path(segmif_tpu_torch.__file__).parent
    srcs = sorted(root.rglob("*.py")) + sorted((root / "kernels" / "csrc")
                                               .glob("*.cu*"))
    assert len(srcs) >= 15, srcs
    bad = [f"{p.relative_to(root)}: {w}" for p in srcs
           for w in ("scaled_dot_product_attention", "torch.compile",
                     "flash_attn", "cudnn_attention")
           if w in p.read_text()]
    assert not bad, bad
