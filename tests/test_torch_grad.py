"""The kernels' autograd.Functions on the CPU: ``torch.autograd.gradcheck``
in float64, with the plain forward standing in for the kernel through the
``forward=`` parameter of each Function's private helper (nothing on the
main path sets it). gradcheck holds every input's analytic gradient (the
Function's backward, which recomputes the plain version) against finite
differences, so it shows that each input receives its gradient: q, k, v;
the FFM's tokens and all 17 weights, given as the ``.t()`` views the
module passes, back to their leaves; the DRDB's x and 12 conv tensors.

Small widths keep the finite differences cheap: attention D = 4, the FFM
at C = 8 with 2 heads, the DRDB at 4 channels with growth 2.

sr-attention's kernel backward (``sr_attention_backward``: the dq pass,
then the dkv pass) on the CPU, where its two operators run their plain
versions: in f64 against autograd's VJP of ``sr_attention_ref`` for q, k
and v (k and v the strided halves of a kv projection), and in bf16
against the plain VJP in bf16, which it must round where that rounds (dq,
dk and dv once, from f32 sums).

The FFM's kernel backward (``crosspath_backward``: pass A', the fold's
gradient, pass B') on the CPU, where its two operators run their plain
versions: in f64 against autograd's VJP of ``crosspath_folded_ref`` for
the tokens and all 17 weights, and in bf16 against the plain VJP in bf16,
which it must round where that rounds (dr and dM to bf16; dx_i as the sum
of two bf16 gradients): a rounding point missed moves up to 26-53 % of a
gradient's elements, f32 sums in another order a few.
"""
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch.kernels import _build
from segmif_tpu_torch.kernels import attention as katt
from segmif_tpu_torch.kernels.attention import (_sr_attention_grad,
                                                sr_attention_ref)
from segmif_tpu_torch.kernels.drdb import _drdb_grad, drdb_chain
from segmif_tpu_torch.kernels import ffm as kffm
from segmif_tpu_torch.kernels.ffm import (W_KEYS, _crosspath_grad,
                                          crosspath_folded_ref)
from segmif_tpu_torch.models.fusion import CrossPath

F64 = torch.float64


def _leaf(gen, *shape, scale=0.5):
    return (torch.randn(shape, generator=gen, dtype=F64) * scale
            ).requires_grad_(True)


def test_sr_attention_function_gradcheck():
    g = torch.Generator().manual_seed(0)
    q, k, v = _leaf(g, 2, 5, 2, 4), _leaf(g, 2, 3, 2, 4), _leaf(g, 2, 3, 2, 4)
    assert torch.autograd.gradcheck(
        lambda q, k, v: _sr_attention_grad(q, k, v, 0.5,
                                           forward=sr_attention_ref),
        (q, k, v))


def _sr_case(b, n, m, h, d, dtype, seed):
    """q [B, N, H, D], k and v the strided halves of one [B, M, 2 H D]
    projection (as the MiT makes them), the cotangent, in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=F64).to(dtype)

    q, kv, g = randn(b, n, h, d), randn(b, m, 2 * h * d), randn(b, n, h, d)
    return (q, kv[..., :h * d].unflatten(-1, (h, d)),
            kv[..., h * d:].unflatten(-1, (h, d)), g)


def _sr_plain_vjp(q, k, v, g, needs):
    scale = q.shape[-1] ** -0.5
    return _build.plain_vjp(
        "bwd/sr_attention", lambda q, k, v: sr_attention_ref(q, k, v, scale),
        [q, k, v], needs, (g,))


SR_NEEDS = {"all": "qkv", "q": "q", "k": "k", "v": "v", "kv": "kv",
            "qv": "qv"}


@pytest.mark.parametrize("needs", list(SR_NEEDS))
@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 70, 1, 1, 32),            # one key
    (3, 130, 65, 5, 64),          # one key past a tile
    (1, 100, 300, 5, 32),         # mit_b3's M = 300, a ragged key tile
    (3, 50, 300, 1, 64),          # N under one tile
])
def test_sr_attention_backward_passes_match_autograd(b, n, m, h, d, needs):
    """f64: the backward through the two passes' plain versions, with M
    ragged, N off the 64-query tiles, D 32 and 64, H 1 and 5, B 1 and 3,
    for each subset of q, k, v needing a gradient, equals autograd's VJP of
    ``sr_attention_ref`` (1e-10 of each gradient's largest magnitude); the
    others get None."""
    q, k, v, g = _sr_case(b, n, m, h, d, F64, 7)
    flags = [c in SR_NEEDS[needs] for c in "qkv"]
    got = katt.sr_attention_backward(q, k, v, g, flags, d ** -0.5)
    want = _sr_plain_vjp(q, k, v, g, flags)
    for name, flag, a, e in zip("qkv", flags, got, want):
        if not flag:
            assert a is None and e is None, name
            continue
        assert a.shape == e.shape and a.dtype == e.dtype, name
        assert (a - e).abs().max() <= 1e-10 * e.abs().max(), name


# the bf16 backward against the plain VJP in bf16: the largest share of a
# gradient's elements that may differ
SR_BF16_SHARE = 0.05


@pytest.mark.parametrize("b,n,m,h,d", [(2, 1000, 300, 2, 64),
                                       (1, 300, 65, 5, 32)])
def test_sr_attention_backward_rounds_as_the_plain_vjp(b, n, m, h, d):
    """bf16: the backward through the two passes' plain versions against
    the plain VJP in bf16: every gradient within 2^-7 of its largest
    magnitude (the CUDA tests' GRAD_TOL) and at most SR_BF16_SHARE of its
    elements different at all: both compute in f32 and round dq, dk and dv
    once, so only f32 sums in another order (the log-sum-exp, D) move an
    element by one bf16 step. Measured over three seeds and four
    shapes (M 65-1,024): up to 0.08 % of a gradient's elements differ; P
    taken at bf16 in both passes moves 40-44 %."""
    q, k, v, g = _sr_case(b, n, m, h, d, torch.bfloat16, 8)
    got = katt.sr_attention_backward(q, k, v, g, [True] * 3, d ** -0.5)
    want = _sr_plain_vjp(q, k, v, g, [True] * 3)
    for name, a, e in zip("qkv", got, want):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        scale = e.float().abs().max()
        assert (a.float() - e.float()).abs().max() <= 2 ** -7 * scale, name
        share = (a != e).float().mean().item()
        assert share <= SR_BF16_SHARE, (name, share)


def test_sr_attention_function_routes_cpu_to_the_plain_vjp(monkeypatch):
    """On CPU tensors (and in f32 or f64 on the card) the Function's
    backward recomputes the plain VJP: the kernel chain is not called, no
    backward operator runs, and the plain-VJP counter counts CUDA tensors
    only."""
    def refuse(*a, **k):
        raise AssertionError("the kernel backward ran on CPU tensors")

    monkeypatch.setattr(katt, "sr_attention_backward", refuse)
    q, k, v, g = _sr_case(2, 70, 65, 2, 64, torch.bfloat16, 9)
    q.requires_grad_(True)
    assert not katt.bwd_takes_kernels(q, k, v)
    katt._SrAttentionFn.plain_backwards = 0
    katt.sr_attention_bwd_dq.launches = 0
    katt.sr_attention_bwd_dkv.launches = 0
    (got,) = torch.autograd.grad(_sr_attention_grad(q, k, v, 0.125), q, g)
    want = _build.plain_vjp(
        "bwd/sr_attention", lambda q, k, v: sr_attention_ref(q, k, v, 0.125),
        [q.detach(), k, v], [True, False, False], (g,))[0]
    assert torch.equal(got, want)
    assert katt._SrAttentionFn.plain_backwards == 0
    assert (katt.sr_attention_bwd_dq.launches,
            katt.sr_attention_bwd_dkv.launches) == (0, 0)


def _ffm_leaves(gen, c):
    """The module's leaves: Linear weights [out, in], biases, norms."""
    leaves = {}
    for i in (1, 2, 3):
        leaves[f"proj{i}.weight"] = _leaf(gen, 2 * c, c)
        leaves[f"proj{i}.bias"] = _leaf(gen, 2 * c, scale=0.1)
        leaves[f"kv{i}.weight"] = _leaf(gen, 2 * c, c, scale=0.3)
    for i in (1, 2):
        leaves[f"end{i}.weight"] = _leaf(gen, c, 2 * c, scale=0.3)
        leaves[f"end{i}.bias"] = _leaf(gen, c, scale=0.1)
        leaves[f"norm{i}.weight"] = (1 + _leaf(gen, c, scale=0.1)
                                     ).detach().requires_grad_(True)
        leaves[f"norm{i}.bias"] = _leaf(gen, c, scale=0.1)
    return leaves


def _folded(leaves):
    """The weight dict as ``CrossPath.folded_weights`` builds it: [in, out]
    ``.t()`` views of the Linear weights."""
    w = {}
    for i in (1, 2, 3):
        w[f"wp{i}"] = leaves[f"proj{i}.weight"].t()
        w[f"bp{i}"] = leaves[f"proj{i}.bias"]
        w[f"wkv{i}"] = leaves[f"kv{i}.weight"].t()
    for i in (1, 2):
        w[f"we{i}"] = leaves[f"end{i}.weight"].t()
        w[f"be{i}"] = leaves[f"end{i}.bias"]
        w[f"ln{i}_scale"] = leaves[f"norm{i}.weight"]
        w[f"ln{i}_bias"] = leaves[f"norm{i}.bias"]
    assert set(w) == set(W_KEYS)
    return w


def test_crosspath_function_gradcheck():
    c, heads = 8, 2
    g = torch.Generator().manual_seed(1)
    xs = [_leaf(g, 2, 6, c, scale=1.0) for _ in range(3)]
    leaves = _ffm_leaves(g, c)
    names = list(leaves)

    def fn(x1, x2, s, *ls):
        return _crosspath_grad(x1, x2, s, _folded(dict(zip(names, ls))),
                               (c // heads) ** -0.5, heads,
                               forward=crosspath_folded_ref)

    assert torch.autograd.gradcheck(fn, (*xs, *leaves.values()))
    # and the leaves take the same gradients as autograd through the
    # plain folded CrossPath
    out = fn(*xs, *leaves.values())
    got = torch.autograd.grad(out, list(leaves.values()),
                              [torch.ones_like(o) for o in out])
    want = torch.autograd.grad(
        crosspath_folded_ref(*xs, _folded(leaves), (c // heads) ** -0.5,
                             heads),
        list(leaves.values()), [torch.ones_like(o) for o in out])
    for name, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, msg=name)


def _crosspath_case(b, n, dtype, seed):
    """A CrossPath (C = 64, 8 heads: the fusion net's) in ``dtype``, its
    weights moved off their initial values, the tokens, the cotangents and
    the grams its forward saves. -> (tokens, weights in ``W_KEYS`` order,
    cotangents, grams, module)."""
    gen = torch.Generator().manual_seed(seed)
    cp = CrossPath(64).to(dtype)
    with torch.no_grad():
        for p in cp.parameters():
            p.add_((torch.randn(p.shape, generator=gen, dtype=F64) * 0.05
                    ).to(dtype))

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=F64).to(dtype)

    xs = [randn(b, n, 64) for _ in range(3)]
    gs = [randn(b, n, 64) for _ in range(2)]
    w = {k: v.detach() for k, v in cp.folded_weights().items()}
    acc = _build.acc_dtype(dtype)
    grams = []   # as crosspath_folded_ref computes them: blocks of r^T r
    for i, (x, half) in enumerate(zip(xs, (0, 0, 1))):
        r = kffm._relu_proj(x, w[f"wp{i + 1}"].to(dtype).to(acc),
                            w[f"bp{i + 1}"].to(dtype).to(acc))
        sl = slice(64 * half, 64 * (half + 1))
        grams.append((r.transpose(1, 2) @ r)[:, sl, sl])
    return xs, [w[k] for k in W_KEYS], gs, torch.stack(grams, 1), cp


def _plain_vjp(xs, ws, gs, needs, cp):
    return _build.plain_vjp(
        "bwd/crosspath",
        lambda x1, x2, s, *ws: crosspath_folded_ref(
            x1, x2, s, dict(zip(W_KEYS, ws)), cp.scale, cp.num_heads),
        [*xs, *ws], needs, gs)


NAMES = ("x1", "x2", "s") + W_KEYS
NEEDS = {"all": NAMES, "tokens": NAMES[:3], "weights": NAMES[3:],
         "some": ("x2", "bp2", "wkv3", "we1", "ln1_bias")}


@pytest.mark.parametrize("needs", list(NEEDS))
@pytest.mark.parametrize("b,n,chunk", [(1, 100, None), (3, 300, 128),
                                       (1, 1, None)])
def test_crosspath_backward_passes_match_autograd(b, n, chunk, needs):
    """f64: the backward through the two passes' plain versions, with N
    off the 64-token tiles, in several chunks of 128 with a ragged last
    one, at B = 1 and 3, for each subset of the inputs needing a
    gradient, equals autograd's VJP of ``crosspath_folded_ref`` (1e-10 of
    each gradient's largest magnitude); the others get None."""
    xs, ws, gs, grams, cp = _crosspath_case(b, n, F64, 3)
    flags = [k in NEEDS[needs] for k in NAMES]
    got = kffm.crosspath_backward(*xs, grams, ws, *gs, flags, cp.scale,
                                  cp.num_heads, chunk)
    want = _plain_vjp(xs, ws, gs, flags, cp)
    for name, flag, g, e in zip(NAMES, flags, got, want):
        if not flag:
            assert g is None and e is None, name
            continue
        assert g.shape == e.shape and g.dtype == e.dtype, name
        assert (g - e).abs().max() <= 1e-10 * e.abs().max(), name


# the bf16 backward against the plain VJP in bf16: (largest share of a
# token gradient's elements that may differ, of a weight gradient's)
BF16_SHARE = (0.05, 0.2)


@pytest.mark.parametrize("b,n,chunk", [(2, 1000, 256), (1, 300, 128)])
def test_crosspath_backward_rounds_as_the_plain_vjp(b, n, chunk):
    """bf16: the backward through the two passes' plain versions against
    the plain VJP in bf16: every gradient within 2^-7 of its largest
    magnitude (the CUDA tests' GRAD_TOL) and at most BF16_SHARE of its
    elements different at all: dr and dM are rounded to bf16 where the
    plain VJP's casts round them. Measured over five seeds and shapes: up
    to 1.2 % of a token gradient's elements and 7.2 % of a weight
    gradient's differ (f32 sums in chunks and in another order, a dM or
    context matrix rounded on the other side of a bf16 step, carried
    through the rest); with dr left unrounded up to 41 % and 34 %, with dM
    left unrounded 26 % and 53 %."""
    xs, ws, gs, grams, cp = _crosspath_case(b, n, torch.bfloat16, 4)
    flags = [True] * len(NAMES)
    got = kffm.crosspath_backward(*xs, grams, ws, *gs, flags, cp.scale,
                                  cp.num_heads, chunk)
    want = _plain_vjp(xs, ws, gs, flags, cp)
    for i, (name, g, e) in enumerate(zip(NAMES, got, want)):
        assert g.shape == e.shape and g.dtype == e.dtype, name
        scale = e.float().abs().max()
        assert (g.float() - e.float()).abs().max() <= 2 ** -7 * scale, name
        share = (g != e).float().mean().item()
        assert share <= BF16_SHARE[i >= 3], (name, share)


def test_crosspath_function_routes_cpu_to_the_plain_vjp(monkeypatch):
    """On CPU tensors (and in f32 or f64 on the card) the Function's
    backward recomputes the plain VJP: the kernel chain is not called, and
    the plain-VJP counter counts CUDA tensors only."""
    def refuse(*a, **k):
        raise AssertionError("the kernel backward ran on CPU tensors")

    monkeypatch.setattr(kffm, "crosspath_backward", refuse)
    xs, ws, gs, _, cp = _crosspath_case(1, 70, torch.bfloat16, 5)
    xs = [x.requires_grad_(True) for x in xs]
    assert not kffm.bwd_takes_kernels(*xs)
    kffm._CrossPathFn.plain_backwards = 0
    out = _crosspath_grad(*xs, dict(zip(W_KEYS, ws)), cp.scale,
                          cp.num_heads)
    got = torch.autograd.grad(out, xs, gs)
    want = _plain_vjp([x.detach() for x in xs], ws, gs,
                      [True] * 3 + [False] * 17, cp)[:3]
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert kffm._CrossPathFn.plain_backwards == 0


def _drdb_leaves(gen, c, growth):
    dconvs = [(_leaf(gen, growth, c + growth * t, 3, 3, scale=0.2),
               _leaf(gen, growth, scale=0.1)) for t in range(5)]
    bottleneck = (_leaf(gen, c, c + 5 * growth, 1, 1, scale=0.2),
                  _leaf(gen, c, scale=0.1))
    return dconvs, bottleneck


def test_drdb_function_gradcheck():
    g = torch.Generator().manual_seed(2)
    x = _leaf(g, 1, 4, 6, 5, scale=1.0).detach().contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    dconvs, bottleneck = _drdb_leaves(g, 4, 2)
    ws = [t for c in (*dconvs, bottleneck) for t in c]
    assert len(ws) == 12

    def fn(x, *ws):
        convs = [(ws[2 * t], ws[2 * t + 1]) for t in range(5)]
        return _drdb_grad(x, convs, (ws[10], ws[11]),
                          forward=lambda x, d, b, wpk: drdb_chain(x, d, b))

    assert torch.autograd.gradcheck(fn, (x, *ws))


@pytest.mark.parametrize("instead", ["drdb_block", "crosspath_fused"])
def test_forward_only_refusal_names_the_function(instead):
    """The refusal that the per-kernel wrappers run on the card names the
    Function to call for a gradient; without a graph it passes."""
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"forward-only.*{instead}"):
        _build.refuse_grad(t, instead=instead)
    with torch.no_grad():
        _build.refuse_grad(t, instead=instead)
