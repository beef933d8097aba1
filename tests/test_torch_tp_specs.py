"""The port's tensor-parallel split rule (``parallel.mesh.param_shardings``,
keyed by ``convert.jax_path``) against the JAX package's ``_tp_spec_for``
and ``param_shardings`` over the whole ``JointPipeline`` tree
(``jax.eval_shape``: shapes only, nothing compiled), for mit_b0 and mit_b3
at model 2, 3, 4 and 8 (JAX meshes data 1 x model M over the suite's 8
CPU devices):

 - ``jax_path`` maps the port's parameters one to one onto the JAX params
   tree (every path, both ways);
 - every leaf is split along the same axis into the same piece shape (a
   JAX [in, out] kernel split by column is the port's [out, in] weight
   split along dim 0), and at M = 3 no leaf is split;
 - the decode head's ``linear_c{i}`` stays whole and the FFM's ``kv3``
   (JAX ``kv_seg``) is split; mit_b3 at M = 2 splits 19.00 M parameters by
   column and 13.55 M by row;
 - a rule keyed by the port's names (``linear_c{i}.proj`` read as
   ``proj``) fails the comparison, and ``tensor_parallel`` refuses it;
 - ``local`` / ``join`` (the pieces of a leaf, in one part or in the MiT
   kv's two) invert each other.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_ranks as pr
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu.parallel.mesh import make_mesh as jax_make_mesh
from segmif_tpu.parallel.mesh import param_shardings as jax_param_shardings
from segmif_tpu_torch.convert import jax_path
from segmif_tpu_torch.models.network import JointPipeline
from segmif_tpu_torch.parallel import mesh as mesh_mod
from segmif_tpu_torch.parallel.mesh import Mesh, param_shardings
from segmif_tpu_torch.parallel.tensor import join, local, tensor_parallel
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

MODELS = (2, 3, 4, 8)


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


@pytest.fixture(scope="module", params=["mit_b0", "mit_b3"])
def trees(request):
    """(backbone, JAX params shapes by path, the port's parameters)."""
    bb = request.param
    shapes = jax.eval_shape(lambda: JaxJointPipeline(bb, num_classes=9).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
        jnp.zeros((1, 32, 32, 3))))["params"]
    port = dict(JointPipeline(bb, num_classes=9).named_parameters())
    return bb, shapes, port


def _jax_split(shapes, model):
    """{JAX path: (split axis or None, piece shape)} of the JAX rule."""
    mesh = jax_make_mesh(data=1, model=model)
    shard = jax_param_shardings(mesh, shapes, tensor_parallel=True)
    out = {}
    for (path, leaf), (_, sh) in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree_util.tree_flatten_with_path(shard)[0]):
        axes = [i for i, a in enumerate(sh.spec) if a is not None]
        out[_key(path)] = (axes[0] if axes else None,
                           sh.shard_shape(leaf.shape))
    return out


def _port_split(port, model):
    """{JAX path: (split axis in the JAX layout or None, piece shape in
    the JAX layout)} of the port's rule."""
    out = {}
    for name, dim in param_shardings(model, port).items():
        shape = list(port[name].shape)
        if dim is not None:
            shape[dim] //= model
        jshape = mesh_mod._jax_shape(shape)
        axis = None if dim is None else len(shape) - 1 - dim
        out["/".join(jax_path(name))] = (axis, jshape)
    return out


def test_jax_path_maps_every_leaf(trees):
    _, shapes, port = trees
    want = {_key(p): tuple(leaf.shape) for p, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {"/".join(jax_path(k)): mesh_mod._jax_shape(t.shape)
           for k, t in port.items()}
    assert len(got) == len(port)
    assert set(got) == set(want)
    for k, v in want.items():   # the PReLU slope: JAX () and port (1,)
        assert got[k] == v or int(np.prod(v)) == int(np.prod(got[k])), k


@pytest.mark.parametrize("model", MODELS)
def test_split_matches_jax(trees, model):
    bb, shapes, port = trees
    want, got = _jax_split(shapes, model), _port_split(port, model)
    assert set(got) == set(want)
    for k, (axis, piece) in want.items():
        g_axis, g_piece = got[k]
        assert g_axis == axis, k
        if axis is not None:
            assert tuple(g_piece) == tuple(piece), k
    split = {k for k, (a, _) in want.items() if a is not None}
    if model == 3:
        assert not split
        return
    assert not any("/linear_c" in k for k in split)
    assert "fusion/ffm/cross/cross_attn/kv_seg/kernel" in split
    if (bb, model) == ("mit_b3", 2):
        col = sum(int(np.prod(port[n].shape)) for n, d in
                  param_shardings(2, port).items() if d == 0)
        row = sum(int(np.prod(port[n].shape)) for n, d in
                  param_shardings(2, port).items() if d == 1)
        assert (round(col / 1e6, 2), round(row / 1e6, 2)) == (19.00, 13.55)


def test_name_based_rule_fails(trees, monkeypatch):
    _, shapes, port = trees
    want = _jax_split(shapes, 2)
    monkeypatch.setattr(mesh_mod, "jax_path", pr._name_rule)
    dims = param_shardings(2, port)
    head = "seg.denoise_net.decoder.linear_c1.proj.weight"
    assert dims[head] == 1      # read as 'proj': split by row
    assert dims["fusion.ffm.cross.cross_attn.kv3.weight"] is None
    jax_says = want["seg/seg/decoder/linear_c1/kernel"][0]
    assert jax_says is None and dims[head] is not None
    # the port refuses to run a split that no module runs
    group = types.SimpleNamespace(world=2, rank=0)
    with pytest.raises(ValueError, match="linear_c1.proj"):
        tensor_parallel(JointPipeline("mit_b0", num_classes=9),
                        Mesh(1, None, 2, group, group))


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("dim", [0, 1])
def test_local_and_join_invert(parts, dim):
    t = torch.arange(48.0).reshape(8, 6) if dim == 0 else \
        torch.arange(48.0).reshape(6, 8)
    for world in (2, 4):
        pieces = [local(t, r, world, dim, parts) for r in range(world)]
        assert torch.equal(join(torch.cat(pieces, dim), world, dim, parts),
                           t)
    if parts == 2:   # rank 0 of 2 keeps the first half of each part
        a, b = t.chunk(2, dim)
        want = torch.cat([a.chunk(2, dim)[0], b.chunk(2, dim)[0]], dim)
        assert torch.equal(local(t, 0, 2, dim, parts), want)
