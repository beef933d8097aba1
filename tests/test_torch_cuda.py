"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, so every
worker collects the same tests) unless a CUDA device and nvcc are present.
Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -q

This file imports no JAX: the machine with the card has none.

Tolerances (both sides compute in f32; TF32 is off for the plain side):
 - sr-attention and FFM apply, per element: |got - ref| <= atol + rtol *
   |ref|, and in bf16 at most a share of the elements differ at all.
   f32: reduction order (and, for sr-attention, 3xTF32 products to about
   2^-21 of each), atol 1e-5 (attention) / 1e-4 (FFM apply, whose
   LayerNorm scales errors by 1/std), rtol 0. The 3xTF32 kernels run on
   an A operand rounded to TF32 (a dropped small*big product: Q, x, the
   tail's r1..r5, the apply's s) must fail the f32 limits:
   test_f32_check_catches_a_dropped_small_big_product; the f32 tail and
   apply hold theirs on seeds 0-4 at the main-path shapes:
   test_f32_tail_and_apply_limits_hold_over_seeds; f32 apply faults fail
   them: test_f32_apply_check_catches_a_fault. bf16
   attention: rtol 2^-7 (one bf16 step of the output, so any one-step difference passes:
   the kernel's P V is f32-accurate to about 2^-17, and the two sides
   round f32 values that differ in their last bits), atol 2^-14 (outputs
   near zero, where sums of terms of order 1 cancel); chip_smoke.py reads
   up to 0.98 of the limit and 0.34% of elements differing on the H100 at
   the main-path and 1080p shapes; the share is held to 2%.
   bf16 FFM apply: rtol 2^-7 (one output step), atol 2^-5 (a projection
   activation rounded to bf16 on the other side of a boundary moves a
   context product by up to one activation step times a context entry,
   then through the LayerNorm); chip_smoke.py reads 0.33 of the limit and
   0.02% of elements differing; the share is held to 1%. The limits hold
   on other seeds at those shapes: test_bf16_limits_hold_over_seeds. A
   planted fault fails one of the two limits:
   test_sr_attention_and_apply_checks_catch_a_fault.
 - grams: 1e-4 relative to their largest entry in f32 (non-negative
   summands in another order), 1e-3 in bf16 (rare one-step flips of an
   activation).
 - DRDB, per element: |got - ref| <= atol + rtol * (|ref| + |ref - x|),
   the last term only for the tail and the block, whose output is x plus
   a bottleneck term rounded on its own. f32: 1e-4 and 1e-4, for sums in
   other orders and cuDNN's f32 algorithms. bf16, rtol one bf16 step
   (2^-7): the growth chain with atol 2^-7 (the kernel rounds conv + bias
   once, cuDNN rounds the conv, then adds the bias; earlier r's steps
   carry through the next conv, up to 3.9e-3 measured on the H100 at the
   main-path shape), the tail with atol 2^-10 (both sides round the same
   f32 accumulator; measured 0), the block with atol 2^-6 (the growth
   chain's steps through the bottleneck, up to 7.4e-3 measured). A
   dropped or shifted bias exceeds them: test_drdb_check_catches_a_fault;
   so do swapped conv taps and a zeroed weight chunk in the bf16 growth,
   and a zeroed bias or swapped projections in the bf16 grams:
   test_growth_and_grams_checks_catch_a_fault.
 - int8 DRDB: bit for bit. The int32 sums are exact in any order and the
   kernels' f32 epilogues (explicit _rn intrinsics, no FMA) run the plain
   version's operations in its order, so the int8 buffer and the output
   are compared with torch.equal; a planted fault must change them.
 - bf16 serving against f32 end to end (test_bf16_vs_f32_pipeline):
   segmif_tpu_torch.drift's limits, those of tests/test_bf16_drift.py;
   a dropped DRDB1 tail bias must fail them.
 - gradients (test_function_gradients_match_plain): each kernel's
   autograd.Function against autograd through its plain version on the
   same inputs, the computation its backward repeats: every input's
   gradient within 1e-5 (f32) or 2^-7 (bf16, one step) of its largest
   magnitude (cuDNN's and cuBLAS's backward kernels may sum in another
   order between the two runs).
 - a fusion-phase train step on the card in f32 against the CPU
   (test_train_step_card_matches_cpu): the losses within 1e-4 relative,
   every gradient leaf within TRAIN_LEAF_RTOL of its largest magnitude;
   a DRDB Function that returns a zero bottleneck-bias gradient fails it.
 - a seg-phase train step on the card in f32 against the CPU, drop-path
   and dropout at 0 (test_seg_step_card_matches_cpu): the loss within
   1e-4 relative, every gradient leaf and BatchNorm buffer within
   TRAIN_LEAF_RTOL of its largest magnitude (the five leaves whose exact
   gradient is zero, within 1e-6 of the largest gradient), and the
   running variance folded as flax folds it (``compare.bn_fold_ratio``
   below 1/4); the unbiased variance folded instead fails the last.
 - the fusion variants at 64x96, f32 (test_variant_on_card_matches_cpu):
   each interaction's mit_b0 pipeline, the short tail and
   SimpleFusionNetwork on the card against the CPU, fused Y within 1e-4
   and logits within 1e-3 of their largest magnitude (chip_smoke.py's
   PIPE_RTOL), with the launches (no FFM kernel but for 'both');
   test_return_attention_matches_folded_on_card: 'both' with
   return_attention (the modular path, no FFM launch) against the folded
   FFM kernels, fused Y within 1e-4 of its largest magnitude, two [B, 8, 8,
   8] maps whose columns sum to 1.
 - the disk-to-disk path at 64x96 (test_disk_to_disk_checks): exact.
   Every decoder returns the written bytes, and the CLIs' PNGs and mIoU
   table equal in-memory runs of the same arrays through the same kernels
   (deterministic: no atomics, cuDNN in deterministic mode); each planted
   fault of ``disk_check.planted_faults`` fails a check.
"""
import numpy as np
import pytest
import torch

from segmif_tpu_torch.kernels import _build
from segmif_tpu_torch.kernels import drdb as kdrdb
from segmif_tpu_torch.kernels import ffm as kffm
from segmif_tpu_torch.kernels.attention import sr_attention, sr_attention_ref
from segmif_tpu_torch.kernels.drdb import (
    drdb_block,
    drdb_chain,
    drdb_growth,
    drdb_growth_ref,
    drdb_tail,
    drdb_tail_ref,
)
from segmif_tpu_torch.kernels import int8 as kint8
from segmif_tpu_torch.kernels.ffm import (
    crosspath_apply_rows,
    crosspath_apply_rows_ref,
    crosspath_folded_ref,
    crosspath_fused,
    crosspath_grams,
    crosspath_grams_ref,
)

pytestmark = pytest.mark.cuda

# sr-attention and FFM apply: (rtol, atol, largest share of elements
# that may differ); see the module docstring
SR_TOL = {torch.float32: (0.0, 1e-5, 1.0),
          torch.bfloat16: (2 ** -7, 2 ** -14, 0.02)}
APPLY_TOL = {torch.float32: (0.0, 1e-4, 1.0),
             torch.bfloat16: (2 ** -7, 2 ** -5, 0.01)}
GRAM_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# DRDB (rtol, atol) per element
GROWTH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -7)}
TAIL_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -10)}
BLOCK_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -7, 2 ** -6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if _build.nvcc_path() is None:
        pytest.skip("nvcc not found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device, std=1.0):
    return (torch.randn(shape, generator=gen) * std).to(device=device,
                                                         dtype=dtype)


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _close(got, want, tol):
    """Every element within atol + rtol * |ref| and at most the given share
    of the elements different at all."""
    rtol, atol, share = tol
    d = (got.float() - want.float()).abs()
    return (bool((d <= atol + rtol * want.float().abs()).all())
            and (d > 0).float().mean().item() <= share)


def _sr_inputs(seed, b, n, m, h, d, dtype, device):
    g = torch.Generator().manual_seed(seed)
    q = _randn(g, (b, n, h, d), dtype, device)
    kv = _randn(g, (b, m, 2 * h * d), dtype, device)
    # k and v as the model makes them: strided halves of one projection
    return (q, kv[..., :h * d].unflatten(-1, (h, d)),
            kv[..., h * d:].unflatten(-1, (h, d)))


SR_SHAPES = [
    (1, 4, 3, 2, 32),          # tiny, M below one warp
    (2, 1000, 300, 1, 64),     # ragged query tile
    (2, 19200, 300, 1, 64),    # mit_b3 stage 1 at 480x640
    (2, 4800, 300, 2, 64),     # stage 2
    (2, 1200, 300, 5, 64),     # stage 3
    (2, 300, 300, 8, 64),      # stage 4
    (2, 4096, 256, 1, 32),     # mit_b0 stage 1 (D = 32) at 256x256
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,h,d", SR_SHAPES)
def test_sr_attention_kernel_matches_plain(cuda, dtype, b, n, m, h, d):
    q, k, v = _sr_inputs(0, b, n, m, h, d, dtype, cuda)
    with torch.inference_mode():
        got = sr_attention(q, k, v, d ** -0.5)
        want = sr_attention_ref(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, n, h, d)
    assert _close(got, want, SR_TOL[dtype])


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 70, 1, 2, 64),         # one key
    (2, 100, 44, 2, 64),       # one ragged key tile (300 = 4 x 64 + 44)
    (1, 130, 65, 1, 32),       # one key past a whole tile, D = 32
    (2, 4000, 1980, 1, 64),    # the 1080p stage-1 key count (31 tiles)
    (1, 1500, 1980, 5, 64),    # five heads over 1980 keys
])
def test_sr_attention_bf16_takes_any_m(cuda, b, n, m, h, d):
    """The bf16 kernel streams K/V, so M has no limit; ragged key tiles
    and N not a multiple of the 64-query tile are masked."""
    q, k, v = _sr_inputs(16, b, n, m, h, d, torch.bfloat16, cuda)
    with torch.inference_mode():
        got = sr_attention(q, k, v, d ** -0.5)
        want = sr_attention_ref(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (b, n, h, d)
    assert _close(got, want, SR_TOL[torch.bfloat16])


@pytest.mark.parametrize("fault", ["sr_scale_x1.01", "sr_last_key_dropped",
                                   "apply_be_zeroed", "apply_m1_m3_swapped",
                                   "apply_gamma_plus_0.01"])
def test_sr_attention_and_apply_checks_catch_a_fault(cuda, fault):
    """The bf16 kernels run with a fault planted in their arguments fail
    the tolerances above against the plain versions on the true ones."""
    with torch.inference_mode():
        if fault.startswith("sr"):
            q, k, v = _sr_inputs(17, 2, 4800, 300, 2, 64, torch.bfloat16,
                                 cuda)
            want = sr_attention_ref(q, k, v, 0.125)
            got = (sr_attention(q, k, v, 0.125 * 1.01)
                   if fault == "sr_scale_x1.01"
                   else sr_attention(q, k[:, :-1], v[:, :-1], 0.125))
            tol = SR_TOL[torch.bfloat16]
        else:
            g = torch.Generator().manual_seed(18)
            xs, wp, bp, mats, be, lnp = _ffm_inputs(g, 2, 4097,
                                                    torch.bfloat16, cuda)
            want = crosspath_apply_rows_ref(*xs, wp, bp, mats, be, lnp)[0]
            if fault == "apply_be_zeroed":
                be = be * 0
            elif fault == "apply_m1_m3_swapped":
                mats = mats[:, [0, 3, 2, 1]]
            else:
                lnp = lnp + torch.tensor([0.01, 0.0], device=cuda)[:, None]
            got = crosspath_apply_rows(*xs, wp, bp, mats, be, lnp)[0]
            tol = APPLY_TOL[torch.bfloat16]
    torch.cuda.synchronize()
    assert not _close(got, want, tol)


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 70, 1, 2, 64),         # one key
    (1, 130, 65, 1, 32),       # one key past a whole 64-key tile, D = 32
    (2, 1000, 383, 2, 64),     # one key more than the f32 kernel once held
    (2, 4000, 1980, 1, 64),    # the 1080p stage-1 key count (31 tiles)
    (1, 1500, 2040, 5, 64),    # mit_b5 stage 3 at 1080p: five heads
    (1, 300, 1980, 2, 32),     # D = 32 over 31 key tiles
])
def test_sr_attention_f32_takes_any_m(cuda, b, n, m, h, d):
    """The f32 kernel (3xTF32 on mma.sync) streams K/V in 64-key tiles
    with an online softmax, so M has no limit; held to the plain version
    within the unchanged f32 tolerance."""
    q, k, v = _sr_inputs(19, b, n, m, h, d, torch.float32, cuda)
    with torch.inference_mode():
        got = sr_attention(q, k, v, d ** -0.5)
        want = sr_attention_ref(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (b, n, h, d) and got.dtype == torch.float32
    assert _close(got, want, SR_TOL[torch.float32])


def test_sr_attention_refuses_what_it_does_not_take(cuda):
    g = torch.Generator().manual_seed(1)
    q = _randn(g, (1, 8, 1, 64), torch.float32, cuda)
    with torch.inference_mode():
        # bf16 rows are copied 16 bytes at a time
        qb = _randn(g, (1, 8, 1, 68), torch.bfloat16, cuda)[..., :64]
        with pytest.raises(ValueError, match="16 bytes"):
            sr_attention(qb, qb, qb, 0.125)
        with pytest.raises(ValueError, match="dtype"):
            sr_attention(q.half(), q.half(), q.half(), 0.125)
        with pytest.raises(ValueError, match="head dim"):
            q48 = _randn(g, (1, 8, 1, 48), torch.float32, cuda)
            sr_attention(q48, q48, q48, 0.125)
    # under autograd the kernel runs inside its Function and q takes a
    # gradient (test_function_gradients_match_plain holds its values)
    qg = q.clone().requires_grad_(True)
    sr_attention.launches = 0
    (g,) = torch.autograd.grad(sr_attention(qg, q, q, 0.125).sum(), qg)
    assert sr_attention.launches == 1
    assert g.shape == q.shape and bool(torch.isfinite(g).all())


def _ffm_inputs(gen, b, n, dtype, device):
    c = 64
    xs = [_randn(gen, (b, n, c), dtype, device) for _ in range(3)]
    wp = _randn(gen, (3, c, 2 * c), torch.float32, device, c ** -0.5)
    bp = _randn(gen, (3, 2 * c), torch.float32, device, 0.1)
    mats = _randn(gen, (b, 4, c, c), torch.float32, device, 0.125)
    be = _randn(gen, (2, c), torch.float32, device, 0.1)
    lnp = torch.stack([torch.stack([1 + _randn(gen, (c,), torch.float32,
                                               device, 0.1),
                                    _randn(gen, (c,), torch.float32,
                                           device, 0.1)])
                       for _ in range(2)])
    return xs, wp, bp, mats, be, lnp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# (8, 1) and (8, 40): less than one 16-token tile per warp of the bf16
# kernel; padded tokens must add nothing, although relu(bias) != 0
@pytest.mark.parametrize("b,n", [(1, 40), (2, 1000), (2, 4097),
                                 (2, 307200), (8, 1), (8, 40)])
def test_ffm_grams_kernel_matches_plain(cuda, dtype, b, n):
    g = torch.Generator().manual_seed(2)
    (x1, x2, s), wp, bp, _, _, _ = _ffm_inputs(g, b, n, dtype, cuda)
    with torch.inference_mode():
        got = crosspath_grams(x1, x2, s, wp, bp)
        want = crosspath_grams_ref(x1, x2, s, wp, bp)
    torch.cuda.synchronize()
    assert got.shape == (b, 3, 64, 64) and got.dtype == torch.float32
    scale = want.abs().max().item()
    assert _max_err(got, want) <= GRAM_RTOL[dtype] * scale
    # no atomics: the same inputs give the same bits
    with torch.inference_mode():
        again = crosspath_grams(x1, x2, s, wp, bp)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(b, n) for b in (1, 2, 8)
                                 for n in (40, 4097, 307200)] + [(2, 1000)])
def test_ffm_apply_kernel_matches_plain(cuda, dtype, b, n):
    g = torch.Generator().manual_seed(3)
    (x1, x2, s), wp, bp, mats, be, lnp = _ffm_inputs(g, b, n, dtype, cuda)
    with torch.inference_mode():
        o1, o2 = crosspath_apply_rows(x1, x2, s, wp, bp, mats, be, lnp)
        r1, r2 = crosspath_apply_rows_ref(x1, x2, s, wp, bp, mats, be, lnp)
    torch.cuda.synchronize()
    assert o1.dtype == dtype and o1.shape == (b, n, 64)
    assert _close(o1, r1, APPLY_TOL[dtype])
    assert _close(o2, r2, APPLY_TOL[dtype])


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_bf16_limits_hold_over_seeds(cuda, seed):
    """The bf16 sr-attention and FFM apply limits hold on more seeds at the
    main-path shapes (B = 8, the four mit_b3 stages and the fusion trunk)
    and at the 1080p stage-1 shape."""
    bf = torch.bfloat16
    with torch.inference_mode():
        for b, n, m, h in ((8, 19200, 300, 1), (8, 4800, 300, 2),
                           (8, 1200, 300, 5), (8, 300, 300, 8),
                           (2, 129600, 1980, 1)):
            q, k, v = _sr_inputs(seed, b, n, m, h, 64, bf, cuda)
            assert _close(sr_attention(q, k, v, 0.125),
                          sr_attention_ref(q, k, v, 0.125), SR_TOL[bf]), \
                (n, m, h)
            del q, k, v
        g = torch.Generator().manual_seed(seed)
        xs, wp, bp, mats, be, lnp = _ffm_inputs(g, 8, 307200, bf, cuda)
        for got, want in zip(
                crosspath_apply_rows(*xs, wp, bp, mats, be, lnp),
                crosspath_apply_rows_ref(*xs, wp, bp, mats, be, lnp)):
            assert _close(got, want, APPLY_TOL[bf])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_f32_tail_and_apply_limits_hold_over_seeds(cuda, seed):
    """The f32 DRDB tail and FFM apply (3xTF32 on mma.sync) hold their
    unchanged f32 limits on seeds 0-4 at the main-path shapes (the tail
    at [8, 64, 480, 640] on a growth buffer's slices, the apply at
    [8, 307200, 64])."""
    f32 = torch.float32
    g = torch.Generator().manual_seed(seed)
    with torch.inference_mode():
        x, _, (wb, bb) = _drdb_inputs(g, 8, 480, 640, f32, cuda)
        buf = torch.relu(_randn(g, (8, 480, 640, 160), f32, cuda))
        rs = [buf.permute(0, 3, 1, 2)[:, 32 * i:32 * (i + 1)]
              for i in range(5)]
        assert _within(drdb_tail(x, rs, wb, bb), drdb_tail_ref(x, rs, wb, bb),
                       TAIL_TOL[f32], x)
        del x, buf, rs
        xs, wp, bp, mats, be, lnp = _ffm_inputs(g, 8, 307200, f32, cuda)
        for got, want in zip(
                crosspath_apply_rows(*xs, wp, bp, mats, be, lnp),
                crosspath_apply_rows_ref(*xs, wp, bp, mats, be, lnp)):
            assert _close(got, want, APPLY_TOL[f32])


@pytest.mark.parametrize("fault", ["be_zeroed", "m1_m3_swapped",
                                   "gamma_plus_0.01"])
def test_f32_apply_check_catches_a_fault(cuda, fault):
    """The f32 apply run with a fault planted in its arguments fails the
    f32 limit against the plain version on the true ones."""
    g = torch.Generator().manual_seed(30)
    xs, wp, bp, mats, be, lnp = _ffm_inputs(g, 2, 4097, torch.float32,
                                            cuda)
    with torch.inference_mode():
        want = crosspath_apply_rows_ref(*xs, wp, bp, mats, be, lnp)[0]
        if fault == "be_zeroed":
            be = be * 0
        elif fault == "m1_m3_swapped":
            mats = mats[:, [0, 3, 2, 1]]
        else:
            lnp = lnp + torch.tensor([0.01, 0.0], device=cuda)[:, None]
        got = crosspath_apply_rows(*xs, wp, bp, mats, be, lnp)[0]
    torch.cuda.synchronize()
    assert not _close(got, want, APPLY_TOL[torch.float32])


def test_ffm_refuses_what_it_does_not_take(cuda):
    g = torch.Generator().manual_seed(4)
    (x1, x2, s), wp, bp, mats, be, lnp = _ffm_inputs(g, 1, 128,
                                                     torch.float32, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            crosspath_grams(x1[:, ::2], x2[:, ::2], s[:, ::2], wp, bp)
        with pytest.raises(ValueError, match=r"\[B, N, 64\]"):
            crosspath_grams(x1[..., :32], x2[..., :32], s[..., :32], wp, bp)
        with pytest.raises(ValueError, match="dtype"):
            crosspath_apply_rows(x1.half(), x2.half(), s.half(), wp, bp,
                                 mats, be, lnp)


def test_crosspath_fused_matches_folded_plain(cuda):
    """Both kernels and the torch middle step against the plain folded
    CrossPath (f32; the contexts' softmax sees reordered grams)."""
    g = torch.Generator().manual_seed(5)
    b, n, c = 2, 3000, 64
    x1, x2, s = (_randn(g, (b, n, c), torch.float32, cuda)
                 for _ in range(3))
    w = {}
    for i in (1, 2, 3):
        w[f"wp{i}"] = _randn(g, (c, 2 * c), torch.float32, cuda, 0.1)
        w[f"bp{i}"] = _randn(g, (2 * c,), torch.float32, cuda, 0.1)
        w[f"wkv{i}"] = _randn(g, (c, 2 * c), torch.float32, cuda, 0.02)
    for i in (1, 2):
        w[f"we{i}"] = _randn(g, (2 * c, c), torch.float32, cuda, 0.1)
        w[f"be{i}"] = _randn(g, (c,), torch.float32, cuda, 0.1)
        w[f"ln{i}_scale"] = torch.ones(c, device=cuda)
        w[f"ln{i}_bias"] = torch.zeros(c, device=cuda)
    with torch.inference_mode():
        o1, o2 = crosspath_fused(x1, x2, s, w, 8 ** -0.5, 8)
        r1, r2 = crosspath_folded_ref(x1, x2, s, w, 8 ** -0.5, 8)
    assert _max_err(o1, r1) <= 1e-4 and _max_err(o2, r2) <= 1e-4


def _drdb_inputs(gen, b, h, w, dtype, device):
    """x as the trunk holds it (an NCHW view on channels_last memory) and
    the DRDB's weights at torch's default conv init."""
    x = _randn(gen, (b, h, w, 64), dtype, device).permute(0, 3, 1, 2)

    def conv(o, i, k):
        bound = (i * k * k) ** -0.5
        wt = (torch.rand((o, i, k, k), generator=gen) * 2 - 1) * bound
        bs = (torch.rand((o,), generator=gen) * 2 - 1) * bound
        return wt.to(device, dtype), bs.to(device, dtype)

    dconvs = [conv(32, 64 + 32 * t, 3) for t in range(5)]
    return x, dconvs, conv(64, 224, 1)


def _within(got, want, tol, x=None):
    """Every element within atol + rtol * (|ref| + |ref - x|), the last
    term only when x is given."""
    rtol, atol = tol
    ref = want.float().abs()
    if x is not None:
        ref += (want.float() - x.float()).abs()
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * ref).all())


DRDB_SHAPES = [(8, 480, 640), (2, 100, 172), (1, 5, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", DRDB_SHAPES)
def test_drdb_growth_kernel_matches_plain(cuda, dtype, b, h, w):
    x, dconvs, _ = _drdb_inputs(torch.Generator().manual_seed(8), b, h, w,
                                dtype, cuda)
    with torch.inference_mode():
        got = drdb_growth(x, dconvs)
        want = drdb_growth_ref(x, dconvs)
    torch.cuda.synchronize()
    for g, e in zip(got, want):
        assert g.shape == (b, 32, h, w) and g.dtype == dtype
        assert _within(g, e, GROWTH_TOL[dtype])


@pytest.mark.parametrize("b,h,w,sliced", [(1, 17, 33, False),
                                           (2, 5, 7, False),
                                           (2, 17, 33, True),
                                           (2, 100, 172, True)])
def test_drdb_growth_bf16_any_shape_and_channel_slice(cuda, b, h, w, sliced):
    """The bf16 growth (16x16 tiles, TMA halo loads) at H x W that are not
    multiples of the tile, and with x a channel slice (channels 16-79) of
    a wider channels_last tensor, read through its pixel stride of 96."""
    gen = torch.Generator().manual_seed(20)
    x, dconvs, _ = _drdb_inputs(gen, b, h, w, torch.bfloat16, cuda)
    if sliced:
        wide = _randn(gen, (b, h, w, 96), torch.bfloat16, cuda)
        wide[..., 16:80] = x.permute(0, 2, 3, 1)
        x = wide.permute(0, 3, 1, 2)[:, 16:80]
        assert x.stride(3) == 96
    with torch.inference_mode():
        got = drdb_growth(x, dconvs)
        want = drdb_growth_ref(x, dconvs)
    torch.cuda.synchronize()
    for g, e in zip(got, want):
        assert g.shape == (b, 32, h, w)
        assert _within(g, e, GROWTH_TOL[torch.bfloat16])


@pytest.mark.parametrize("b,h,w,sliced", [(1, 17, 33, False),
                                           (2, 5, 7, False),
                                           (2, 17, 33, True),
                                           (2, 100, 172, True)])
def test_drdb_growth_f32_any_shape_and_channel_slice(cuda, b, h, w, sliced):
    """The f32 growth (3xTF32 on wgmma, 16x16 tiles, 16-channel TMA halo
    chunks) at H x W that are not multiples of the tile, and with x a
    channel slice (channels 16-79) of a wider channels_last tensor, read
    through its pixel stride of 96; the unchanged f32 limit."""
    gen = torch.Generator().manual_seed(25)
    x, dconvs, _ = _drdb_inputs(gen, b, h, w, torch.float32, cuda)
    if sliced:
        wide = _randn(gen, (b, h, w, 96), torch.float32, cuda)
        wide[..., 16:80] = x.permute(0, 2, 3, 1)
        x = wide.permute(0, 3, 1, 2)[:, 16:80]
        assert x.stride(3) == 96
    with torch.inference_mode():
        got = drdb_growth(x, dconvs)
        want = drdb_growth_ref(x, dconvs)
    torch.cuda.synchronize()
    for g, e in zip(got, want):
        assert g.shape == (b, 32, h, w)
        assert _within(g, e, GROWTH_TOL[torch.float32])


@pytest.mark.parametrize("kernel", ["sr_attention", "drdb_growth",
                                    "drdb_tail", "ffm_apply"])
def test_f32_check_catches_a_dropped_small_big_product(cuda, kernel):
    """Without its small*big product a 3xTF32 kernel multiplies A's TF32
    half alone: the same as the kernel run on A rounded to TF32 (Q for
    sr-attention's logits, x for the first growth conv, s for the apply's
    y3; for the tail, whose x is also its residual, B: the bottleneck
    rounded, its big*small product dropped). That run fails the f32 limit
    against the plain version on the true inputs; the true run holds
    it."""
    with torch.inference_mode():
        if kernel == "sr_attention":
            q, k, v = _sr_inputs(26, 2, 4800, 300, 2, 64, torch.float32,
                                 cuda)
            want = sr_attention_ref(q, k, v, 0.125)
            good = sr_attention(q, k, v, 0.125)
            bad = sr_attention(_build.tf32_big(q), k, v, 0.125)
            held = [_close(t, want, SR_TOL[torch.float32])
                    for t in (good, bad)]
        elif kernel == "ffm_apply":
            (x1, x2, s), *ws = _ffm_inputs(torch.Generator().manual_seed(31),
                                           2, 4097, torch.float32, cuda)
            want = crosspath_apply_rows_ref(x1, x2, s, *ws)[0]
            good = crosspath_apply_rows(x1, x2, s, *ws)[0]
            bad = crosspath_apply_rows(x1, x2, _build.tf32_big(s), *ws)[0]
            held = [_close(t, want, APPLY_TOL[torch.float32])
                    for t in (good, bad)]
        else:
            x, dconvs, (wb, bb) = _drdb_inputs(
                torch.Generator().manual_seed(27), 2, 100, 172,
                torch.float32, cuda)
            if kernel == "drdb_growth":
                want = drdb_growth_ref(x, dconvs)[0]
                good = drdb_growth(x, dconvs)[0]
                bad = drdb_growth(_build.tf32_big(x), dconvs)[0]
                held = [_within(t, want, GROWTH_TOL[torch.float32])
                        for t in (good, bad)]
            else:
                # the tail's B: the bottleneck rounded to TF32 drops its
                # big*small product (r1..r5 rounded read 1.3x the limit
                # on these inputs, the bottleneck 2.7x)
                rs = drdb_growth(x, dconvs)
                want = drdb_tail_ref(x, rs, wb, bb)
                good = drdb_tail(x, rs, wb, bb)
                bad = drdb_tail(x, rs, _build.tf32_big(wb), bb)
                held = [_within(t, want, TAIL_TOL[torch.float32], x)
                        for t in (good, bad)]
    torch.cuda.synchronize()
    assert held == [True, False]


def test_f32_kernels_repeat_bit_for_bit(cuda):
    """Two calls of each 3xTF32 kernel on the same inputs give the same
    bits: no atomics, a fixed order of sums."""
    q, k, v = _sr_inputs(28, 2, 1000, 383, 2, 64, torch.float32, cuda)
    x, dconvs, (wb, bb) = _drdb_inputs(torch.Generator().manual_seed(29), 2,
                                       40, 56, torch.float32, cuda)
    xs, *ws = _ffm_inputs(torch.Generator().manual_seed(32), 2, 1000,
                          torch.float32, cuda)
    with torch.inference_mode():
        assert torch.equal(sr_attention(q, k, v, 0.125),
                           sr_attention(q, k, v, 0.125))
        rs = drdb_growth(x, dconvs)
        assert all(torch.equal(a, b) for a, b in zip(
            rs, drdb_growth(x, dconvs)))
        assert torch.equal(drdb_tail(x, rs, wb, bb),
                           drdb_tail(x, rs, wb, bb))
        assert all(torch.equal(a, b) for a, b in zip(
            crosspath_apply_rows(*xs, *ws), crosspath_apply_rows(*xs, *ws)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", DRDB_SHAPES)
def test_drdb_tail_kernel_matches_plain(cuda, dtype, b, h, w):
    gen = torch.Generator().manual_seed(9)
    x, _, (wb, bb) = _drdb_inputs(gen, b, h, w, dtype, cuda)
    # r1..r5 as slices of one [B, H, W, 160] buffer, as the growth
    # kernel leaves them
    buf = torch.relu(_randn(gen, (b, h, w, 160), dtype, cuda))
    rs = [buf.permute(0, 3, 1, 2)[:, 32 * i:32 * (i + 1)] for i in range(5)]
    with torch.inference_mode():
        got = drdb_tail(x, rs, wb, bb)
        want = drdb_tail_ref(x, rs, wb, bb)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _within(got, want, TAIL_TOL[dtype], x)


@pytest.mark.parametrize("b,h,w", [(1, 17, 33), (2, 5, 7), (2, 100, 172)])
def test_drdb_tail_bf16_on_a_channel_slice(cuda, b, h, w):
    """The bf16 tail (TMA boxes read through pixel strides) with x a
    channel slice (channels 16-79) of a wider channels_last tensor (pixel
    stride 96) and r1..r5 separate tensors (pixel stride 32), at pixel
    counts that end inside a 128-pixel tile."""
    gen = torch.Generator().manual_seed(23)
    x, _, (wb, bb) = _drdb_inputs(gen, b, h, w, torch.bfloat16, cuda)
    wide = _randn(gen, (b, h, w, 96), torch.bfloat16, cuda)
    wide[..., 16:80] = x.permute(0, 2, 3, 1)
    x = wide.permute(0, 3, 1, 2)[:, 16:80]
    rs = [torch.relu(_randn(gen, (b, h, w, 32), torch.bfloat16, cuda)
                     ).permute(0, 3, 1, 2) for _ in range(5)]
    assert x.stride(3) == 96 and rs[0].stride(3) == 32
    with torch.inference_mode():
        got = drdb_tail(x, rs, wb, bb)
        want = drdb_tail_ref(x, rs, wb, bb)
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _within(got, want, TAIL_TOL[torch.bfloat16], x)


@pytest.mark.parametrize("b,h,w", [(1, 17, 33), (2, 5, 7), (2, 100, 172)])
def test_drdb_tail_f32_on_a_channel_slice(cuda, b, h, w):
    """The f32 tail (3xTF32; 32-channel TMA boxes of 64 pixels read
    through pixel strides) with x a channel slice (channels 16-79) of a
    wider channels_last tensor (pixel stride 96) and r1..r5 separate
    tensors (pixel stride 32), at pixel counts that end inside a 64-pixel
    tile; the unchanged f32 limit."""
    gen = torch.Generator().manual_seed(33)
    x, _, (wb, bb) = _drdb_inputs(gen, b, h, w, torch.float32, cuda)
    wide = _randn(gen, (b, h, w, 96), torch.float32, cuda)
    wide[..., 16:80] = x.permute(0, 2, 3, 1)
    x = wide.permute(0, 3, 1, 2)[:, 16:80]
    rs = [torch.relu(_randn(gen, (b, h, w, 32), torch.float32, cuda)
                     ).permute(0, 3, 1, 2) for _ in range(5)]
    assert x.stride(3) == 96 and rs[0].stride(3) == 32
    with torch.inference_mode():
        got = drdb_tail(x, rs, wb, bb)
        want = drdb_tail_ref(x, rs, wb, bb)
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _within(got, want, TAIL_TOL[torch.float32], x)


@pytest.mark.parametrize("fault", ["r2_r3_swapped", "r5_weights_zeroed",
                                   "x_weights_shifted_one"])
def test_drdb_tail_bf16_check_catches_a_fault(cuda, fault):
    """The bf16 tail run with a fault planted in its arguments (two growth
    slices passed in each other's place; the bottleneck's weights for r5
    zeroed; its weights for x shifted by one input channel) fails the
    tail limit against the plain version on the true arguments."""
    gen = torch.Generator().manual_seed(24)
    x, dconvs, (wb, bb) = _drdb_inputs(gen, 2, 100, 172, torch.bfloat16,
                                       cuda)
    with torch.inference_mode():
        rs = drdb_growth(x, dconvs)   # slices of the kernel's buffer
        want = drdb_tail_ref(x, rs, wb, bb)
        bad_rs, bad_wb = list(rs), wb.clone()
        if fault == "r2_r3_swapped":
            bad_rs[1], bad_rs[2] = rs[2], rs[1]
        elif fault == "r5_weights_zeroed":
            bad_wb[:, 192:] = 0
        else:
            bad_wb[:, :64] = wb[:, :64].roll(1, dims=1)
        got = drdb_tail(x, bad_rs, bad_wb, bb)
    torch.cuda.synchronize()
    assert not _within(got, want, TAIL_TOL[torch.bfloat16], x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", DRDB_SHAPES)
def test_drdb_block_matches_chain(cuda, dtype, b, h, w):
    x, dconvs, bottleneck = _drdb_inputs(torch.Generator().manual_seed(10),
                                         b, h, w, dtype, cuda)
    with torch.inference_mode():
        got = drdb_block(x, dconvs, bottleneck)
        want = drdb_chain(x, dconvs, bottleneck)
    torch.cuda.synchronize()
    assert _within(got, want, BLOCK_TOL[dtype], x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", ["conv1_bias", "conv5_bias", "tail_bias",
                                   "tail_bias_shifted"])
def test_drdb_check_catches_a_fault(cuda, dtype, fault):
    """The kernels run with a fault planted in their arguments fail the
    tolerances above against the plain versions on the true arguments."""
    x, dconvs, (wb, bb) = _drdb_inputs(torch.Generator().manual_seed(12),
                                       2, 100, 172, dtype, cuda)
    with torch.inference_mode():
        if fault.startswith("conv"):
            t = int(fault[4]) - 1
            bad = [(w, torch.zeros_like(b) if i == t else b)
                   for i, (w, b) in enumerate(dconvs)]
            got, want, tol, resid = (drdb_growth(x, bad)[t],
                                     drdb_growth_ref(x, dconvs)[t],
                                     GROWTH_TOL[dtype], None)
        else:
            rs = drdb_growth(x, dconvs)   # slices of the kernel's buffer
            bad = bb.roll(1) if fault.endswith("shifted") else bb * 0
            got, want, tol, resid = (drdb_tail(x, rs, wb, bad),
                                     drdb_tail_ref(x, rs, wb, bb),
                                     TAIL_TOL[dtype], x)
    torch.cuda.synchronize()
    assert not _within(got, want, tol, resid)


def _swap_taps(w, a, b):
    w = w.clone()
    w[..., a[0], a[1]], w[..., b[0], b[1]] = (w[..., b[0], b[1]].clone(),
                                              w[..., a[0], a[1]].clone())
    return w


@pytest.mark.parametrize("fault", ["conv3_taps_swapped",
                                   "conv5_last_chunk_zeroed",
                                   "grams_bias_zeroed",
                                   "grams_y1_y2_weights_swapped"])
def test_growth_and_grams_checks_catch_a_fault(cuda, fault):
    """The bf16 growth and grams kernels run on weights with a planted
    fault (conv 3's taps (0, 0) and (2, 2) swapped; conv 5's weights for
    its last 32 input channels, r4, zeroed; projection y1's bias zeroed;
    the y1 and y2 projections swapped) fail the limits above against the
    plain versions on the true weights."""
    bf = torch.bfloat16
    with torch.inference_mode():
        if fault.startswith("conv"):
            x, dconvs, _ = _drdb_inputs(torch.Generator().manual_seed(21),
                                        2, 100, 172, bf, cuda)
            bad = list(dconvs)
            if fault == "conv3_taps_swapped":
                t = 2
                bad[t] = (_swap_taps(dconvs[t][0], (0, 0), (2, 2)),
                          dconvs[t][1])
            else:
                t = 4
                w5 = dconvs[t][0].clone()
                w5[:, 160:192] = 0
                bad[t] = (w5, dconvs[t][1])
            got = drdb_growth(x, bad)[t]
            want = drdb_growth_ref(x, dconvs)[t]
            torch.cuda.synchronize()
            assert not _within(got, want, GROWTH_TOL[bf])
        else:
            g = torch.Generator().manual_seed(22)
            (x1, x2, s), wp, bp, _, _, _ = _ffm_inputs(g, 2, 4097, bf, cuda)
            want = crosspath_grams_ref(x1, x2, s, wp, bp)
            if fault == "grams_bias_zeroed":
                bp = torch.cat([bp[:1] * 0, bp[1:]])
            else:
                wp = wp[[1, 0, 2]]
            got = crosspath_grams(x1, x2, s, wp, bp)
            torch.cuda.synchronize()
            assert _max_err(got, want) > GRAM_RTOL[bf] * \
                want.abs().max().item()


def test_drdb_forward_on_card_never_runs_the_chain(cuda, monkeypatch):
    """DRDB.forward on a CUDA tensor goes through the two kernels (one
    growth and one tail launch) and never through a plain version."""
    from segmif_tpu_torch.models.fusion import DRDB

    def refuse(*a, **k):
        raise AssertionError("a plain DRDB version ran on the card")

    for name in ("drdb_chain", "drdb_growth_ref", "drdb_tail_ref"):
        monkeypatch.setattr(kdrdb, name, refuse)
    block = DRDB().to(cuda, memory_format=torch.channels_last).eval()
    x = torch.rand((2, 64, 24, 40), device=cuda).contiguous(
        memory_format=torch.channels_last)
    drdb_growth.launches = drdb_tail.launches = 0
    with torch.inference_mode():
        y = block(x)
    torch.cuda.synchronize()
    assert (drdb_growth.launches, drdb_tail.launches) == (1, 1)
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_drdb_refuses_what_it_does_not_take(cuda):
    x, dconvs, (wb, bb) = _drdb_inputs(torch.Generator().manual_seed(11),
                                       1, 8, 8, torch.float32, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="strides"):
            drdb_growth(x.contiguous(), dconvs)      # NCHW memory
        with pytest.raises(ValueError, match="dtype"):
            drdb_growth(x.half(), [(w.half(), b.half()) for w, b in dconvs])
        with pytest.raises(ValueError, match="dtypes"):
            drdb_growth(x.bfloat16(), dconvs)
        rs = drdb_growth(x, dconvs)
        with pytest.raises(ValueError, match="bottleneck"):
            drdb_tail(x, rs, wb[:, :192], bb)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        drdb_growth(xg, dconvs)
    with pytest.raises(RuntimeError, match="forward-only"):
        drdb_tail(xg, [r.clone() for r in rs], wb, bb)
    # the whole block carries a gradient: the kernels run inside its
    # Function (test_function_gradients_match_plain holds the values)
    dg = [(w.clone().requires_grad_(True), b) for w, b in dconvs]
    drdb_growth.launches = drdb_tail.launches = 0
    grads = torch.autograd.grad(drdb_block(x, dg, (wb, bb)).sum(),
                                [w for w, _ in dg])
    assert (drdb_growth.launches, drdb_tail.launches) == (1, 1)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_pipeline_on_card_matches_cpu(cuda):
    """mit_b0 JointPipeline, f32, 64x64: the card (kernels) against the
    same weights on the CPU (plain versions); the counters show the
    kernels ran: 4 guide-pass blocks (stages 1-2) and 8 seg-pass blocks,
    2 FFM rounds, 4 DRDBs."""
    from segmif_tpu_torch.models.network import JointPipeline, init_params
    from segmif_tpu_torch.serving import make_serving_fn

    model = init_params(JointPipeline("mit_b0"),
                        torch.Generator().manual_seed(6))
    g = torch.Generator().manual_seed(7)
    ir = torch.rand((2, 64, 64, 1), generator=g)
    vis = torch.rand((2, 64, 64, 3), generator=g)
    with torch.inference_mode():
        want_rgb, want_y, want_logits = model(ir, vis)
    model.to(cuda)
    counters = (sr_attention, crosspath_grams, crosspath_apply_rows,
                drdb_growth, drdb_tail)
    for fn in counters:
        fn.launches = 0
    with torch.inference_mode():
        rgb, y, logits = model(ir.to(cuda), vis.to(cuda))
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [12, 2, 2, 4, 4]
    # f32 on both devices, sums in other orders: relative to the output
    # scale (the JAX initialisers give fused Y values of order 10)
    assert _max_err(y.cpu(), want_y) <= 1e-4 * want_y.abs().max().item()
    assert _max_err(logits.cpu(), want_logits) <= \
        1e-3 * want_logits.abs().max().item()
    serve = make_serving_fn(model)
    out_rgb, pred = serve(ir.to(cuda), vis.to(cuda))
    assert pred.dtype == torch.int32 and pred.shape == (2, 64, 64)
    assert np.isfinite(out_rgb.cpu().numpy()).all()


def _int8_case(seed, b, h, w, dtype, device):
    """x, the DRDB's weights and their Int8Drdb, with the amaxes that a
    calibration pass of the plain growth chain on x records."""
    x, dconvs, bottleneck = _drdb_inputs(torch.Generator().manual_seed(seed),
                                         b, h, w, dtype, device)
    with torch.inference_mode():
        amax = kint8.record_amax([x, *drdb_growth_ref(x, dconvs)])
        q = kint8.quantize_drdb(dconvs, bottleneck, amax)
    return x, dconvs, bottleneck, q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w", DRDB_SHAPES)
def test_drdb_int8_kernels_match_plain(cuda, dtype, b, h, w):
    x, _, _, q = _int8_case(13, b, h, w, dtype, cuda)
    with torch.inference_mode():
        feat = kint8.drdb_int8_growth(x, q)
        want_feat = kint8.drdb_int8_growth_ref(x, q)
        out = kint8.drdb_int8_tail(x, feat, q)
        want = kint8.drdb_int8_tail_ref(x, want_feat, q)
    torch.cuda.synchronize()
    assert feat.shape == (b, h, w, 224) and feat.dtype == torch.int8
    assert torch.equal(feat, want_feat)
    assert out.dtype == dtype and out.shape == x.shape
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, want)


def _int8_faults(q):
    """The kernels' arguments with one fault planted in each."""
    kq0 = q.kq[0].roll(1, dims=1)          # x's channels shifted by one
    return {
        "conv2_bias_dropped": q._replace(bias=torch.cat(
            [q.bias[:32], q.bias[32:64] * 0, q.bias[64:]])),
        "r3_requant_with_r2_scale": q._replace(invs=torch.cat(
            [q.invs[:3], q.invs[2:3], q.invs[4:]])),
        "bottleneck_bias_dropped": q._replace(bb=q.bb * 0),
        "x_channels_shifted_one": q._replace(
            wpk=kint8.pack_int8_growth((kq0,) + q.kq[1:])),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", ["conv2_bias_dropped",
                                   "r3_requant_with_r2_scale",
                                   "bottleneck_bias_dropped",
                                   "x_channels_shifted_one"])
def test_drdb_int8_check_catches_a_fault(cuda, dtype, fault):
    """The kernels run with a fault planted in their arguments disagree
    with the plain version on the true arguments."""
    x, _, _, q = _int8_case(14, 2, 100, 172, dtype, cuda)
    with torch.inference_mode():
        want = kint8.drdb_int8_ref(x, q)
        got = kint8.drdb_int8(x, _int8_faults(q)[fault])
    torch.cuda.synchronize()
    assert not torch.equal(got, want)


def test_drdb_int8_refuses_what_it_does_not_take(cuda):
    x, _, _, q = _int8_case(15, 1, 8, 8, torch.float32, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="strides"):
            kint8.drdb_int8_growth(x.contiguous(), q)      # NCHW memory
        with pytest.raises(ValueError, match="dtype"):
            kint8.drdb_int8_growth(x.half(), q)
        with pytest.raises(ValueError, match="expected"):
            kint8.drdb_int8_growth(x[:, :48], q)
        with pytest.raises(ValueError, match="on cpu"):
            kint8.drdb_int8_growth(x, q._replace(svk=q.svk.cpu()))
        feat = kint8.drdb_int8_growth(x, q)
        with pytest.raises(ValueError, match="contiguous int8"):
            kint8.drdb_int8_tail(x, feat[..., :192], q)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        kint8.drdb_int8(xg, q)


def test_drdb_int8_forward_on_card_runs_only_the_int8_kernels(
        cuda, monkeypatch):
    """A DRDB calibrated and quantised on the card launches the int8
    kernels once each per forward, never the bf16 growth or tail kernels
    and never a plain version."""
    from segmif_tpu_torch.models.fusion import DRDB

    block = DRDB(quant="calibrate").to(
        cuda, torch.bfloat16, memory_format=torch.channels_last).eval()
    x = torch.rand((2, 64, 24, 40), device=cuda).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with torch.inference_mode():
        block(x)
    block.set_quant("int8")
    assert block.amax.dtype == torch.float32 and bool((block.amax > 0).all())

    def refuse(*a, **k):
        raise AssertionError("a plain DRDB version ran on the card")

    for name in ("drdb_int8_ref", "drdb_int8_growth_ref",
                 "drdb_int8_tail_ref"):
        monkeypatch.setattr(kint8, name, refuse)
    counters = (kint8.drdb_int8_growth, kint8.drdb_int8_tail, drdb_growth,
                drdb_tail)
    for fn in counters:
        fn.launches = 0
    with torch.inference_mode():
        y = block(x)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [1, 1, 0, 0]
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("fault", [None, "drdb1_tail_bias_dropped"])
def test_bf16_vs_f32_pipeline(cuda, fault):
    """mit_b3 JointPipeline at 480x640, batch 2, weights at the reference
    modules' scale: the bf16 serving form (channels_last) against f32 on
    the card holds the limits of tests/test_bf16_drift.py (fused-Y max abs
    < 0.02, argmax agreement > 0.95, logits max abs < 1 f32 std); the
    bf16 run with DRDB1's tail bias dropped must fail them."""
    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import JointPipeline

    model = drift.init_reference_scale(JointPipeline("mit_b3"),
                                       torch.Generator().manual_seed(25))
    g = torch.Generator().manual_seed(26)
    ir = torch.rand((2, 480, 640, 1), generator=g)
    vis = torch.rand((2, 480, 640, 3), generator=g)
    ref = drift.pipeline_outputs(model, ir, vis, torch.float32, cuda)
    if fault is not None:
        with torch.no_grad():
            model.fusion.DRDB1.conv.bias.zero_()
    got = drift.pipeline_outputs(model, ir, vis, torch.bfloat16, cuda)
    torch.cuda.synchronize()
    d = drift.drift(ref, got)
    assert drift.within_limits(d) == (fault is None), drift.describe(d)


GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
GRAD_CASES = [("sr_attention", (2, 70, 65, 2, 64)),
              ("sr_attention", (8, 19200, 300, 1, 64)),   # mit_b3 stage 1
              ("sr_attention", (8, 1200, 300, 5, 64)),    # stage 3
              ("ffm", (2, 1000)), ("ffm", (8, 307200)),
              ("drdb", (1, 5, 7)), ("drdb", (8, 480, 640))]


def _grad_case(kind, shape, dtype, device, gen):
    """(inputs needing a gradient, kernel-path output, plain output, the
    counters that must move by one)."""
    from segmif_tpu_torch.kernels.drdb import drdb_chain
    from segmif_tpu_torch.models.fusion import DRDB, CrossPath

    if kind == "sr_attention":
        b, n, m, h, d = shape
        q = _randn(gen, (b, n, h, d), dtype, device).requires_grad_(True)
        kv = _randn(gen, (b, m, 2 * h * d), dtype,
                    device).requires_grad_(True)
        k = kv[..., :h * d].unflatten(-1, (h, d))
        v = kv[..., h * d:].unflatten(-1, (h, d))
        return ([q, kv], lambda: sr_attention(q, k, v, d ** -0.5),
                lambda: sr_attention_ref(q, k, v, d ** -0.5),
                [sr_attention])
    if kind == "ffm":
        b, n = shape
        cp = CrossPath(64).to(device, dtype)
        xs = [_randn(gen, (b, n, 64), dtype, device).requires_grad_(True)
              for _ in range(3)]
        return ([*xs, *cp.parameters()], lambda: cp(*xs),
                lambda: kffm.crosspath_folded_ref(
                    *xs, cp.folded_weights(), cp.scale, cp.num_heads),
                [crosspath_grams, crosspath_apply_rows])
    b, h, w = shape
    block = DRDB().to(device, dtype, memory_format=torch.channels_last)
    x = _randn(gen, (b, h, w, 64), dtype, device).permute(0, 3, 1, 2)
    x.requires_grad_(True)
    return ([x, *block.parameters()], lambda: block(x),
            lambda: drdb_chain(x, *block._weights()),
            [drdb_growth, drdb_tail])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", GRAD_CASES)
def test_function_gradients_match_plain(cuda, dtype, kind, shape):
    """Each kernel's autograd.Function on the card: the forward launches
    the kernel (each counter moves by one; the backward launches none),
    and every input's gradient equals that of autograd through the plain
    version on the same inputs, which the Function's backward recomputes
    (GRAD_TOL of the gradient's largest magnitude)."""
    gen = torch.Generator().manual_seed(30)
    ins, kernel, plain, counters = _grad_case(kind, shape, dtype, cuda, gen)
    for fn in counters:
        fn.launches = 0
    out = kernel()
    outs = (out,) if torch.is_tensor(out) else tuple(out)
    cot = [_randn(gen, o.shape, dtype, cuda) for o in outs]
    got = torch.autograd.grad(outs, ins, cot)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [1] * len(counters)
    ref = plain()
    want = torch.autograd.grad((ref,) if torch.is_tensor(ref) else ref,
                               ins, cot)
    for i, (g, e) in enumerate(zip(got, want)):
        assert g.shape == e.shape and g.dtype == e.dtype, i
        scale = e.float().abs().max().item()
        assert scale > 0, i
        assert _max_err(g, e) <= GRAD_TOL[dtype] * scale, (i, _max_err(g, e),
                                                           scale)


TRAIN_LEAF_RTOL = 1e-2


def _planted_zero_bias_grad(monkeypatch):
    """The DRDB Function returns a zero gradient for the bottleneck bias."""
    real = kdrdb._DrdbFn.backward

    def faulty(ctx, g):
        grads = list(real(ctx, g))
        grads[-1] = torch.zeros_like(grads[-1])
        return tuple(grads)

    monkeypatch.setattr(kdrdb._DrdbFn, "backward", staticmethod(faulty))


@pytest.mark.parametrize("fault", [None, "drdb_bias_grad_zero"])
def test_train_step_card_matches_cpu(cuda, monkeypatch, fault):
    """One round >= 2 fusion-phase step (mit_b3, batch 2, 120x160, f32,
    weights at the reference modules' scale) on the card, through the
    kernels and their Functions, against the same step on the CPU (plain
    versions): the losses within 1e-4 relative and every gradient leaf
    within TRAIN_LEAF_RTOL of its largest magnitude (f32 sums in other
    orders on two devices, and relu inputs within rounding of zero that
    take the other branch on one device; chip_smoke.py phase 8 reads the
    margin at 240x320). With the DRDB Function's bottleneck-bias gradient
    zeroed, the check fails."""
    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.network import JointPipeline
    from segmif_tpu_torch.train.compare import leaf_errors, step_grads

    model = drift.init_reference_scale(JointPipeline("mit_b3"),
                                       torch.Generator().manual_seed(31))
    g = torch.Generator().manual_seed(32)
    b, h, w = 2, 120, 160
    data = {"ir": torch.rand((b, h, w, 1), generator=g),
            "vis": torch.rand((b, h, w, 3), generator=g),
            "guide": torch.rand((b, h, w, 3), generator=g),
            "label": torch.randint(0, 9, (b, h, w), generator=g)}
    want_m, want = step_grads(model, data, False, torch.float32, "cpu")
    if fault:
        _planted_zero_bias_grad(monkeypatch)
    got_m, got = step_grads(model, {k: v.to(cuda) for k, v in data.items()},
                            False, torch.float32, cuda)
    for k in ("loss", "loss_fusion", "loss_seg"):
        assert abs(got_m[k].item() - want_m[k].item()) <= \
            1e-4 * abs(want_m[k].item()), k
    errs = leaf_errors(got, want)
    assert set(errs) == set(dict(model.fusion.named_parameters()))
    worst = max(errs.values())
    assert (worst <= TRAIN_LEAF_RTOL) == (fault is None), \
        sorted(errs.items(), key=lambda kv: -kv[1])[:4]


@pytest.mark.parametrize("fault", [None, "unbiased_running_var"])
def test_seg_step_card_matches_cpu(cuda, monkeypatch, fault):
    """One seg-phase step (mit_b3, batch 2, 120x160, f32, regularisers at
    0) on the card, through the sr-attention kernel and its Function,
    against the same step on the CPU."""
    from segmif_tpu_torch.models import segformer_head
    from segmif_tpu_torch.models.network import (SegmentationNetwork,
                                                 init_params)
    from segmif_tpu_torch.train.compare import (exact_zero_grad,
                                                leaf_errors, seg_step_grads,
                                                without_regularisers)

    model = without_regularisers(init_params(
        SegmentationNetwork("mit_b3"), torch.Generator().manual_seed(33)))
    g = torch.Generator().manual_seed(34)
    b, h, w = 2, 120, 160
    data = {"image": torch.rand((b, h, w, 3), generator=g),
            "label": torch.randint(0, 9, (b, h, w), generator=g)}
    want_m, want, want_s, _ = seg_step_grads(model, data, torch.float32,
                                             "cpu")
    if fault:
        real = segformer_head.update_running_stats
        monkeypatch.setattr(
            segformer_head, "update_running_stats",
            lambda bn, mean, var, n: real(bn, mean, var * n / (n - 1), n))
    got_m, got, got_s, ratio = seg_step_grads(
        model, {k: v.to(cuda) for k, v in data.items()}, torch.float32, cuda)
    assert abs(got_m["loss"].item() - want_m["loss"].item()) <= \
        1e-4 * abs(want_m["loss"].item())
    top = max(v.abs().max().item() for v in want.values())
    for k in [k for k in want if exact_zero_grad(k)]:
        assert got[k].abs().max().item() <= 1e-6 * top, k
        del got[k], want[k]
    errs = leaf_errors({**got, **got_s}, {**want, **want_s})
    assert max(errs.values()) <= TRAIN_LEAF_RTOL, \
        sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert (ratio < 0.25) == (fault is None), ratio


def test_disk_to_disk_checks(cuda, tmp_path, monkeypatch):
    """chip_smoke.py's phase 10 (a), (c) and (d) at 64x96 on the card,
    mit_b3 bf16, through ``segmif_tpu_torch.disk_check``: the folders
    decode to the written bytes by every decoder the machine has;
    ``cli.test_fusion``'s PNGs (default mode, and the static guide with the
    reference quantisation) are ``fused_to_uint8`` of ``generate_fused``
    in memory bit for bit (cuDNN deterministic: the same algorithms
    twice); ``cli.test_segmentation`` equals ``segmentation_eval`` on the
    decoded arrays; the planted faults fail those checks. The weights are
    seeded role checkpoints (the trainer's part, (b), is chip_smoke's)."""
    from segmif_tpu_torch import disk_check as dc
    from segmif_tpu_torch.data.datasets import FusionFolderDataset
    from segmif_tpu_torch.models.network import JointPipeline, init_params
    from segmif_tpu_torch.train import checkpoint as ckpt

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    train = dc.write_folder(tmp_path / "train", 12, (64, 96), 0)
    val = dc.write_folder(tmp_path / "val", 5, (64, 96), 1, rgb_labels=True)
    for w in (train, val):
        assert dc.folder_problems(FusionFolderDataset(w["root"]), w) == []
    dec = dc.decoder_checks([train, val], threads=4, repeats=1)
    assert dec["problems"] == [] and dec["rates"]["PIL"] > 0
    model = init_params(JointPipeline("mit_b3"),
                        torch.Generator().manual_seed(5))
    ck = tmp_path / "ck"
    ckpt.save_role(ck / "fusion_params.pth", model.fusion)
    ckpt.save_role(ck / "seg_params.pth", model.seg)
    fd = dc.fusion_cli_check(val, tmp_path / "fused", ck, "mit_b3", 2,
                             "bfloat16", cuda)
    fs = dc.fusion_cli_check(val, tmp_path / "static", ck, "mit_b3", 2,
                             "bfloat16", cuda,
                             static_guide=val["root"] / "Mask2" / "frame0.png",
                             reference_quantization=True)
    assert fd["problems"] == fs["problems"] == []
    assert not np.array_equal(fd["pngs"], fs["pngs"])
    sg = dc.segmentation_cli_check(tmp_path / "fused", val, ck, "mit_b3", 2,
                                   "bfloat16", cuda, tmp_path / "seg.txt")
    assert sg["problems"] == []
    faults = dc.planted_faults(train, val, tmp_path / "planted", ck,
                               "mit_b3", "bfloat16", cuda)
    assert len(faults) == 3 and all(faults.values()), faults


VARIANT_HW = (64, 96)


@pytest.mark.parametrize("interaction", ["both", "moam", "soam", "concat",
                                         "add", "average", "none"])
def test_variant_on_card_matches_cpu(cuda, interaction):
    from segmif_tpu_torch.models.network import JointPipeline, init_params

    model = init_params(JointPipeline("mit_b0", interaction=interaction),
                        torch.Generator().manual_seed(8)).eval()
    g = torch.Generator().manual_seed(9)
    ir = torch.rand((2, *VARIANT_HW, 1), generator=g)
    vis = torch.rand((2, *VARIANT_HW, 3), generator=g)
    with torch.inference_mode():
        _, want_y, want_logits = model(ir, vis)
    model.to(cuda, memory_format=torch.channels_last)
    counters = (sr_attention, crosspath_grams, crosspath_apply_rows,
                drdb_growth, drdb_tail)
    for fn in counters:
        fn.launches = 0
    with torch.inference_mode():
        _, y, logits = model(ir.to(cuda), vis.to(cuda))
    torch.cuda.synchronize()
    ffm = 2 if interaction == "both" else 0
    assert [fn.launches for fn in counters] == [12, ffm, ffm, 4, 4]
    assert _max_err(y.cpu(), want_y) <= 1e-4 * want_y.abs().max().item()
    assert _max_err(logits.cpu(), want_logits) <= \
        1e-3 * want_logits.abs().max().item()


@pytest.mark.parametrize("net", ["short_tail", "simple"])
def test_fusion_net_on_card_matches_cpu(cuda, net):
    from segmif_tpu_torch.models.fusion import (FusionNetwork,
                                                SimpleFusionNetwork)
    from segmif_tpu_torch.models.network import init_params

    g = torch.Generator().manual_seed(10)
    ir = torch.rand((2, *VARIANT_HW, 1), generator=g)
    vis_y = torch.rand((2, *VARIANT_HW, 1), generator=g)
    h, w = VARIANT_HW
    taps = (torch.randn((2, h // 4, w // 4, 32), generator=g),
            torch.randn((2, h // 8, w // 8, 64), generator=g))
    if net == "short_tail":
        model = FusionNetwork(tap_channels=(32, 64), tail="short")
        args = (ir, vis_y, *taps)
    else:
        model = SimpleFusionNetwork()
        args = (ir, vis_y)
    init_params(model, torch.Generator().manual_seed(11)).eval()
    with torch.inference_mode():
        want = model(*args)
    model.to(cuda, memory_format=torch.channels_last)
    drdb_growth.launches = 0
    with torch.inference_mode():
        got = model(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert drdb_growth.launches == (4 if net == "short_tail" else 2)
    assert _max_err(got.cpu(), want) <= 1e-4 * want.abs().max().item()


def test_return_attention_matches_folded_on_card(cuda):
    from segmif_tpu_torch import drift
    from segmif_tpu_torch.models.fusion import FusionNetwork
    from segmif_tpu_torch.models.network import JointPipeline

    model = drift.init_reference_scale(JointPipeline("mit_b0"),
                                       torch.Generator().manual_seed(12))
    maps_net = FusionNetwork(tap_channels=(32, 64), return_attention=True)
    maps_net.load_state_dict(model.fusion.state_dict())
    for m in (model, maps_net):
        m.eval().to(cuda, memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(13)
    ir = torch.rand((2, *VARIANT_HW, 1), generator=g).to(cuda)
    vis = torch.rand((2, *VARIANT_HW, 3), generator=g).to(cuda)
    with torch.inference_mode():
        taps = model.guide_taps_raw(vis)
        want = model.fusion(ir, vis[..., :1], *taps)
        crosspath_grams.launches = crosspath_apply_rows.launches = 0
        got, maps = maps_net(ir, vis[..., :1], *taps)
    torch.cuda.synchronize()
    assert crosspath_grams.launches == crosspath_apply_rows.launches == 0
    assert _max_err(got, want) <= 1e-4 * want.abs().max().item()
    assert len(maps) == 2
    for m in maps:
        assert m.shape == (2, 8, 8, 8)
        assert _max_err(m.sum(-2), torch.ones_like(m.sum(-2))) < 1e-5
