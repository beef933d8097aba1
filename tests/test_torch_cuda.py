"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture, so every
worker collects the same tests) unless a CUDA device and nvcc are present.
Run on a machine with the card:  python -m pytest tests/test_torch_cuda.py -q

This file imports no JAX: the machine with the card has none.

Tolerances (both sides compute in f32; TF32 is off for the plain side):
 - f32 outputs: reduction order only, 1e-5 (attention) / 1e-4 (FFM apply,
   whose LayerNorm scales errors by 1/std) absolute; grams 1e-4 relative
   to their largest entry (non-negative summands in another order).
 - bf16 outputs: both sides round the same f32 value, which may differ in
   its last bits, so they can be one bf16 step apart: 1.6e-2 for attention
   outputs below 4 (2^-6), 6.25e-2 for LayerNorm outputs below 8 (two
   steps of 2^-5); grams of bf16-rounded activations 1e-3 relative.
"""
import numpy as np
import pytest
import torch

from segmif_tpu_torch.kernels import _build
from segmif_tpu_torch.kernels.attention import sr_attention, sr_attention_ref
from segmif_tpu_torch.kernels.ffm import (
    crosspath_apply_rows,
    crosspath_apply_rows_ref,
    crosspath_folded_ref,
    crosspath_fused,
    crosspath_grams,
    crosspath_grams_ref,
)

pytestmark = pytest.mark.cuda

SR_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}
APPLY_TOL = {torch.float32: 1e-4, torch.bfloat16: 6.25e-2}
GRAM_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 4, 3, 2, 32),          # tiny, M below one warp
    (2, 1000, 300, 1, 64),     # ragged query tile
    (2, 19200, 300, 1, 64),    # mit_b3 stage 1 at 480x640
    (2, 4800, 300, 2, 64),     # stage 2
    (2, 1200, 300, 5, 64),     # stage 3
    (2, 300, 300, 8, 64),      # stage 4
])
def test_sr_attention_kernel_matches_plain(cuda, dtype, b, n, m, h, d):
    g = torch.Generator().manual_seed(0)
    q = _randn(g, (b, n, h, d), dtype, cuda)
    kv = _randn(g, (b, m, 2 * h * d), dtype, cuda)
    # k and v as the model makes them: strided halves of one projection
    k = kv[..., :h * d].unflatten(-1, (h, d))
    v = kv[..., h * d:].unflatten(-1, (h, d))
    with torch.inference_mode():
        got = sr_attention(q, k, v, d ** -0.5)
        want = sr_attention_ref(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, n, h, d)
    assert _max_err(got, want) <= SR_TOL[dtype]


def test_sr_attention_refuses_what_it_does_not_take(cuda):
    g = torch.Generator().manual_seed(1)
    q = _randn(g, (1, 8, 1, 64), torch.float32, cuda)
    big = _randn(g, (1, 4096, 1, 64), torch.float32, cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="exceed"):
            sr_attention(q, big, big, 0.125)
        with pytest.raises(ValueError, match="dtype"):
            sr_attention(q.half(), q.half(), q.half(), 0.125)
        with pytest.raises(ValueError, match="head dim"):
            q48 = _randn(g, (1, 8, 1, 48), torch.float32, cuda)
            sr_attention(q48, q48, q48, 0.125)
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        sr_attention(qg, q, q, 0.125)


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
@pytest.mark.parametrize("b,n", [(1, 40), (2, 1000), (2, 4097),
                                 (2, 307200)])
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
@pytest.mark.parametrize("b,n", [(1, 40), (2, 1000), (2, 4097),
                                 (2, 307200)])
def test_ffm_apply_kernel_matches_plain(cuda, dtype, b, n):
    g = torch.Generator().manual_seed(3)
    (x1, x2, s), wp, bp, mats, be, lnp = _ffm_inputs(g, b, n, dtype, cuda)
    with torch.inference_mode():
        o1, o2 = crosspath_apply_rows(x1, x2, s, wp, bp, mats, be, lnp)
        r1, r2 = crosspath_apply_rows_ref(x1, x2, s, wp, bp, mats, be, lnp)
    torch.cuda.synchronize()
    assert o1.dtype == dtype and o1.shape == (b, n, 64)
    assert _max_err(o1, r1) <= APPLY_TOL[dtype]
    assert _max_err(o2, r2) <= APPLY_TOL[dtype]


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


def test_pipeline_on_card_matches_cpu(cuda):
    """mit_b0 JointPipeline, f32, 64x64: the card (kernels) against the
    same weights on the CPU (plain versions); the counters show the
    kernels ran: 4 guide-pass blocks (stages 1-2) and 8 seg-pass blocks,
    2 FFM rounds."""
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
    counters = (sr_attention, crosspath_grams, crosspath_apply_rows)
    for fn in counters:
        fn.launches = 0
    with torch.inference_mode():
        rgb, y, logits = model(ir.to(cuda), vis.to(cuda))
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [12, 2, 2]
    # f32 on both devices, sums in other orders: relative to the output
    # scale (the JAX initialisers give fused Y values of order 10)
    assert _max_err(y.cpu(), want_y) <= 1e-4 * want_y.abs().max().item()
    assert _max_err(logits.cpu(), want_logits) <= \
        1e-3 * want_logits.abs().max().item()
    serve = make_serving_fn(model)
    out_rgb, pred = serve(ir.to(cuda), vis.to(cuda))
    assert pred.dtype == torch.int32 and pred.shape == (2, 64, 64)
    assert np.isfinite(out_rgb.cpu().numpy()).all()
