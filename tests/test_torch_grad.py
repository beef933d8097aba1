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
"""
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch.kernels import _build
from segmif_tpu_torch.kernels.attention import (_sr_attention_grad,
                                                sr_attention_ref)
from segmif_tpu_torch.kernels.drdb import _drdb_grad, drdb_chain
from segmif_tpu_torch.kernels.ffm import (W_KEYS, _crosspath_grad,
                                          crosspath_folded_ref)

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
