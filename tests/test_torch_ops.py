"""The seven ``segmif::`` operators on the CPU, where each runs its
kernel's plain version: ``torch.library.opcheck`` (schema, autograd
registration, the fake (shape) function's shapes, dtypes and strides
against the CPU version's, and tracing with dynamic shapes); each
operator against the plain function it stands for (bit for bit: the same
arithmetic); the packings the DRDB operators' CPU versions invert; and the
wrappers, whose CPU calls without a gradient go through the operators and
with one through autograd on the plain versions.
"""
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch import kernels  # noqa: F401 (registers the ops)
from segmif_tpu_torch.kernels import attention, drdb, ffm, int8

OPS = ("sr_attention", "ffm_grams", "ffm_apply", "drdb_growth", "drdb_tail",
       "drdb_int8_growth", "drdb_int8_tail")
CL = torch.channels_last


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _convs(gen, dtype=torch.float32):
    dconvs = [(torch.randn((32, 64 + 32 * t, 3, 3), generator=gen) * 0.05,
               torch.randn((32,), generator=gen) * 0.05) for t in range(5)]
    wb = torch.randn((64, 224, 1, 1), generator=gen) * 0.05
    bb = torch.randn((64,), generator=gen) * 0.05
    return ([(w.to(dtype), b.to(dtype)) for w, b in dconvs], wb.to(dtype),
            bb.to(dtype))


def _x(gen, b=1, h=5, w=7, dtype=torch.float32):
    return torch.randn((b, 64, h, w), generator=gen).to(dtype).contiguous(
        memory_format=CL)


def _ffm_operands(gen, n=40):
    x1, x2, s = (torch.randn((2, n, 64), generator=gen) for _ in range(3))
    wp = torch.randn((3, 64, 128), generator=gen) * 0.1
    bp = torch.randn((3, 128), generator=gen) * 0.1
    return x1, x2, s, wp, bp


def _int8_operands(gen):
    dconvs, wb, bb = _convs(gen)
    x = _x(gen)
    amax = int8.record_amax([x, *drdb.drdb_growth_ref(x, dconvs)])
    return x, int8.quantize_drdb(dconvs, (wb, bb), amax)


def _cases():
    """op name -> (args) on CPU tensors, at small shapes."""
    gen = _gen(0)
    q = torch.randn((2, 24, 2, 32), generator=gen)
    kv = torch.randn((2, 6, 2 * 2 * 32), generator=gen)
    k = kv[..., :64].unflatten(-1, (2, 32))    # strided halves, as MiT
    v = kv[..., 64:].unflatten(-1, (2, 32))
    x1, x2, s, wp, bp = _ffm_operands(gen)
    wg, bgr = ffm._halves(wp, bp, x1.dtype, ffm._GRAM_PICKS)
    wa, ba = ffm._halves(wp, bp, x1.dtype, ffm._APPLY_PICKS)
    mats = torch.randn((2, 4, 64, 64), generator=gen) * 0.1
    be = torch.randn((2, 64), generator=gen)
    lnp = torch.randn((2, 2, 64), generator=gen)
    dconvs, wb, bb = _convs(gen)
    x = _x(gen)
    buf = torch.ops.segmif.drdb_growth(x, *drdb.pack_growth(dconvs,
                                                            x.dtype))
    rs = [buf.permute(0, 3, 1, 2)[:, 32 * t:32 * (t + 1)] for t in range(5)]
    xi, qi = _int8_operands(gen)
    feat = int8.drdb_int8_growth_ref(xi, qi)
    return {
        "sr_attention": (q, k, v, 0.125),
        "ffm_grams": (x1, x2, s, wg, bgr),
        "ffm_apply": (x1, x2, s, wa, ba, mats, be, lnp),
        "drdb_growth": (x, *drdb.pack_growth(dconvs, x.dtype)),
        "drdb_tail": (x, rs, *drdb.pack_tail(wb, bb, x.dtype)),
        "drdb_int8_growth": (xi, int8._q_list(qi)),
        "drdb_int8_tail": (xi, feat, int8._q_list(qi)),
    }


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.mark.parametrize("name", OPS)
def test_opcheck(cases, name):
    torch.library.opcheck(getattr(torch.ops.segmif, name).default,
                          cases[name])


@pytest.mark.parametrize("name", OPS)
def test_fake_matches_cpu_version(cases, name):
    """The shape function's outputs (meta tensors) have the CPU version's
    shapes, dtypes and strides."""
    args = cases[name]

    def meta(a):
        if torch.is_tensor(a):
            return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                       device="meta")
        return [meta(t) for t in a] if isinstance(a, list) else a

    op = getattr(torch.ops.segmif, name)
    got, want = op(*map(meta, args)), op(*args)
    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    for g, w in zip(got, want):
        assert (g.shape, g.dtype, g.stride()) == (w.shape, w.dtype,
                                                  w.stride())


def test_wrappers_compute_the_plain_versions():
    """Each CPU wrapper call without a gradient (through the operator)
    gives its plain function's result bit for bit."""
    gen = _gen(6)
    q, k, v = (torch.randn((2, n, 2, 32), generator=gen)
               for n in (24, 6, 6))
    assert torch.equal(attention.sr_attention(q, k, v, 0.125),
                       attention.sr_attention_ref(q, k, v, 0.125))
    x1, x2, s, wp, bp = _ffm_operands(gen)
    assert torch.equal(ffm.crosspath_grams(x1, x2, s, wp, bp),
                       ffm.crosspath_grams_ref(x1, x2, s, wp, bp))
    mats = torch.randn((2, 4, 64, 64), generator=gen) * 0.1
    be, lnp = torch.randn((2, 64), generator=gen), torch.randn(
        (2, 2, 64), generator=gen)
    args = (x1, x2, s, wp, bp, mats, be, lnp)
    for got, want in zip(ffm.crosspath_apply_rows(*args),
                         ffm.crosspath_apply_rows_ref(*args)):
        assert torch.equal(got, want)
    dconvs, wb, bb = _convs(gen)
    x = _x(gen)
    rs = drdb.drdb_growth(x, dconvs)
    for got, want in zip(rs, drdb.drdb_growth_ref(x, dconvs)):
        assert torch.equal(got, want)
    assert torch.equal(drdb.drdb_tail(x, rs, wb, bb),
                       drdb.drdb_tail_ref(x, rs, wb, bb))
    xi, qi = _int8_operands(gen)
    feat = int8.drdb_int8_growth(xi, qi)
    assert torch.equal(feat, int8.drdb_int8_growth_ref(xi, qi))
    assert torch.equal(int8.drdb_int8_tail(xi, feat, qi),
                       int8.drdb_int8_tail_ref(xi, feat, qi))
    assert torch.equal(int8.drdb_int8(xi, qi), int8.drdb_int8_ref(xi, qi))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_unpack_inverts_the_packings(dtype):
    dconvs, wb, bb = _convs(_gen(1), dtype)
    for (w, b), (wu, bu) in zip(dconvs, drdb.unpack_growth(
            drdb.pack_growth(dconvs, dtype), dtype)):
        assert torch.equal(w, wu) and torch.equal(b.double(), bu.double())
    wu, bu = drdb.unpack_tail(drdb.pack_tail(wb, bb, dtype), dtype)
    assert torch.equal(wb, wu) and torch.equal(bb.double(), bu.double())
    # the biases keep the arithmetic type: f64 stays f64
    assert bu.dtype == (torch.float64 if dtype == torch.float64
                        else torch.float32)


def _op_names(t):
    """The names of the autograd nodes under ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(f).__name__ for f in seen}


def test_cpu_wrappers_route_by_gradient(monkeypatch):
    """Without a gradient the CPU wrappers call the operators; with one
    they differentiate the plain versions (the operators have no
    autograd)."""
    called = []
    real = torch.ops.segmif.sr_attention

    class Spy:
        def __call__(self, *a):
            called.append(1)
            return real(*a)

    monkeypatch.setattr(torch.ops.segmif, "sr_attention", Spy())
    q = torch.randn((1, 8, 1, 32))
    k = torch.randn((1, 4, 1, 32))
    v = torch.randn((1, 4, 1, 32))
    attention.sr_attention(q, k, v, 0.2)
    assert called == [1]
    qg = q.clone().requires_grad_(True)
    out = attention.sr_attention(qg, k, v, 0.2)
    assert called == [1] and "SoftmaxBackward0" in _op_names(out)
    dconvs, wb, bb = _convs(_gen(2))
    w0 = dconvs[0][0].clone().requires_grad_(True)
    rs = drdb.drdb_growth(_x(_gen(3)), [(w0, dconvs[0][1])] + dconvs[1:])
    assert "ConvolutionBackward0" in _op_names(rs[0])


def test_meta_tensors_go_through_the_shape_functions():
    """A meta call of each wrapper gives the kernel's output shapes (what
    ``test_torch_stretch_shapes`` traces the 1080p pipeline with)."""
    with torch.device("meta"):
        q = torch.empty((2, 129600, 1, 64), dtype=torch.bfloat16)
        kv = torch.empty((2, 1980, 2, 64), dtype=torch.bfloat16)
        assert attention.sr_attention(q, kv, kv, 0.125).shape == q.shape
        dconvs = [(torch.empty((32, 64 + 32 * t, 3, 3)), torch.empty(32))
                  for t in range(5)]
        wb, bb = torch.empty((64, 224, 1, 1)), torch.empty(64)
        x = torch.empty((2, 64, 1080, 1920)).contiguous(memory_format=CL)
        rs = drdb.drdb_growth(x, dconvs)
        assert [tuple(r.shape) for r in rs] == [(2, 32, 1080, 1920)] * 5
        out = drdb.drdb_tail(x, rs, wb, bb)
        assert out.shape == x.shape and out.is_contiguous(memory_format=CL)


def test_refusals_keep_their_messages():
    """The argument checks stay in the wrappers and raise before any
    operator runs, with the messages the kernels' callers know (checked
    here on meta tensors standing in for the card's: the CPU takes any
    shape the plain versions take)."""
    q = torch.empty((1, 8, 1, 48))
    with pytest.raises(ValueError, match="head dim 48"):
        attention._check_sr(q, q[:, :4], q[:, :4])
    with pytest.raises(ValueError, match="tokens must be"):
        ffm._check_tokens("crosspath_grams", torch.empty((1, 8, 32)))
    with pytest.raises(ValueError, match="expected 5"):
        drdb.drdb_growth(_x(_gen(4)), _convs(_gen(4))[0][:4])
