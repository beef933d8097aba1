"""Tensor parallelism of the port's forward (``parallel.tensor``) on gloo
CPU ranks, mit_b0 at 32x32, batch 2:

 - the four primitives (copy, reduce, gather, scatter; gather and scatter
   in one part and in the MiT kv's two) and a Megatron MLP (fc1 by
   column, fc2 by row, biases whole) on 2 and 4 ranks against autograd of
   the unsplit function, f64, within 1e-12;
 - the split ``JointPipeline`` forward (fused Y and logits) against one
   process in f64 within 1e-12 of the largest magnitude: model 2 and 4
   (mit_b0's stage heads 1, 2, 5, 8: the gathered heads at 1 and 5, and at
   2 on 4 ranks), model 3 (every leaf whole) and the modular FFM path
   ('moam') at 2;
 - ``make_serving_fn(mesh=)`` on 2 ranks, default, static guide and
   calibrated int8 (the DRDBs whole), against one process in f64 within
   1e-12, every rank's outputs the same bit for bit;
 - the split forward in f32 on 2 ranks against the JAX package's
   tensor-parallel forward (``make_mesh(data=1, model=2)``,
   ``param_shardings``) at the golden tolerances: fused Y 3e-5, logits
   2e-4;
 - planted faults fail the forward: proj's (and fc2's) bias added on
   every rank before the sum, kv split contiguously (JAX's columns taken
   literally: rank 0 all of K).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_ranks as pr
import train_parity as tp
from segmif_tpu.parallel.mesh import make_mesh as jax_make_mesh
from segmif_tpu.parallel.mesh import param_shardings as jax_param_shardings
from segmif_tpu.parallel.mesh import put_replicated as jax_put_replicated
from segmif_tpu_torch.parallel import dist, tensor
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAUNCH_S = 240
SEED = 7
FAULTS = ("bias_every_rank", "kv_contiguous")


def _with_biases(sd, rng):
    """``sd`` with every bias drawn from N(0, 0.02) (the inits leave the
    linears' biases at zero, where a bias fault would not show)."""
    return {k: (rng.normal(0, 0.02, v.shape).astype(v.dtype)
                if k.endswith(".bias") else v) for k, v in sd.items()}


@pytest.fixture(scope="module")
def setup():
    """JAX variables; the port's state dicts ('jax': the JAX weights;
    'both', 'moam': with drawn biases); f64 inputs, a static guide and an
    int8 calibration batch."""
    _, variables = tp.jax_variables(0)
    _, moam = tp.jax_variables(0, "moam")
    rng = np.random.default_rng(SEED)
    jax_sd = pr.state_dict_numpy(tp.port_model(variables))
    sds = {"jax": jax_sd, "both": _with_biases(jax_sd, rng),
           "moam": _with_biases(pr.state_dict_numpy(
               tp.port_model(moam, "moam")), rng)}
    x = {"ir": rng.uniform(0, 1, (2, 32, 32, 1)),
         "vis": rng.uniform(0, 1, (2, 32, 32, 3))}
    extra = {"guide": rng.uniform(0, 1, (2, 32, 32, 3)),
             "cal_ir": rng.uniform(0, 1, (2, 32, 32, 1)),
             "cal_vis": rng.uniform(0, 1, (2, 32, 32, 3))}
    return variables, sds, x, extra


def _forward(setup, model, interaction="both", dtype="float64",
             faults=(), weights=None):
    _, sds, x, _ = setup
    return ("forward", dict(sd=sds[weights or interaction],
                            classes=tp.CLASSES, interaction=interaction,
                            dtype=dtype, model=model, inputs=x,
                            faults=faults))


SERVING = {"default": (), "static guide": ("guide",),
           "int8": ("cal_ir", "cal_vis")}


def _serving(setup, mode):
    _, sds, x, extra = setup
    inputs = dict(x, **{k: extra[k] for k in SERVING[mode]})
    return ("serving", dict(sd=sds["both"], classes=tp.CLASSES,
                            dtype="float64", model=2, inputs=inputs))


def _todo2(setup):
    """The 2-rank launch, by name."""
    todo = {"primitives": ("primitives", SEED),
            "both": _forward(setup, 2),
            "moam": _forward(setup, 2, "moam"),
            "f32": _forward(setup, 2, dtype="float32", weights="jax")}
    todo.update({f"serving {m}": _serving(setup, m) for m in SERVING})
    todo.update({f"fault {f}": _forward(setup, 2, faults=(f,))
                 for f in FAULTS})
    return todo


def _launch(world, todo, tmp):
    ranks = dist.launch(pr.tp_run, world, (list(todo.values()),),
                        timeout=LAUNCH_S, threads=1, workdir=str(tmp))
    return {n: [r[i] for r in ranks] for i, n in enumerate(todo)}


@pytest.fixture(scope="module")
def ranks2(setup, tmp_path_factory):
    return _launch(2, _todo2(setup), tmp_path_factory.mktemp("r2"))


@pytest.fixture(scope="module")
def ranks4(setup, tmp_path_factory):
    return _launch(4, {"primitives": ("primitives", SEED),
                       "both": _forward(setup, 4)},
                   tmp_path_factory.mktemp("r4"))


@pytest.fixture(scope="module")
def ranks3(setup, tmp_path_factory):
    return _launch(3, {"both": _forward(setup, 3)},
                   tmp_path_factory.mktemp("r3"))


@pytest.fixture(scope="module")
def one(setup):
    """One process: the whole model's forward and serving."""
    todo = {k: v for k, v in _todo2(setup).items()
            if k in ("both", "moam") or k.startswith("serving")}
    with torch.inference_mode():
        return {n: pr.TP_KINDS[kind](None, case)
                for n, (kind, case) in todo.items()}


def _unsplit_primitives(seed, n):
    """The unsplit functions of ``parallel_ranks.tp_primitives`` by
    autograd in one process: {name: (output, grads) per rank}."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    x, cots = draw(3, 4 * n), [draw(3, 4 * n) for _ in range(n)]
    xs = [draw(3, 4 * n) for _ in range(n)]
    w1, b1, w2, b2 = draw(8 * n, 4 * n), draw(8 * n), draw(5, 8 * n), \
        draw(5)
    out = {}

    def grads(loss, leaves):
        return [g.numpy() for g in torch.autograd.grad(loss, leaves)]

    xl = x.clone().requires_grad_()
    g = grads(sum((xl * c).sum() for c in cots), [xl])
    out["copy"] = [(x.numpy(), g) for _ in range(n)]
    xl = [t.clone().requires_grad_() for t in xs]
    y = sum(xl)
    g = grads((y * cots[0]).sum(), xl)
    out["reduce"] = [(y.detach().numpy(), [g[r]]) for r in range(n)]
    for parts in (1, 2):
        pieces = [tensor.local(x, r, n, 1, parts).clone().requires_grad_()
                  for r in range(n)]
        y = tensor.join(torch.cat(pieces, 1), n, 1, parts)
        k = pieces[0].shape[1]
        g = grads((y * cots[0]).sum(), pieces)
        out[f"gather{parts}"] = [(y.detach().numpy(), [g[r]])
                                 for r in range(n)]
        xl = x.clone().requires_grad_()
        ys = [tensor.local(xl, r, n, 1, parts) for r in range(n)]
        g = grads(sum((t * c[:, :k]).sum() for t, c in zip(ys, cots)),
                  [xl])
        out[f"scatter{parts}"] = [(ys[r].detach().numpy(), g)
                                  for r in range(n)]
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    xl, w1l, b1l, w2l, b2l = leaves
    y = torch.tanh(xl @ w1l.T + b1l) @ w2l.T + b2l
    gx, gw1, gb1, gw2, gb2 = grads((y * cots[0][:, :5]).sum(), leaves)
    out["mlp"] = [(y.detach().numpy(), [
        gx, tensor.local(torch.from_numpy(gw1), r, n, 0).numpy(), gb1,
        tensor.local(torch.from_numpy(gw2), r, n, 1).numpy(), gb2])
        for r in range(n)]
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_primitives_match_autograd(ranks2, ranks4, world):
    got = (ranks2 if world == 2 else ranks4)["primitives"]
    for r in range(world):
        assert got[r].pop("gather1 contiguous") and \
            got[r].pop("gather2 contiguous")
    want = _unsplit_primitives(SEED, world)
    for name, per_rank in want.items():
        for r, (y, grads) in enumerate(per_rank):
            gy, ggrads = got[r][name]
            np.testing.assert_allclose(gy, y, rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name} rank {r}")
            assert len(ggrads) == len(grads)
            for a, b in zip(ggrads, grads):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                           err_msg=f"{name} rank {r} grad")


def _close(got, want, rtol):
    """Every output within ``rtol`` of its largest magnitude."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * np.abs(w).max())


def _same_on_ranks(per_rank):
    for other in per_rank[1:]:
        for a, b in zip(other, per_rank[0]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["2 both", "2 moam", "4 both", "3 both"])
def test_forward_matches_one_process(ranks2, ranks3, ranks4, one, case):
    world, name = case.split()
    runs = {"2": ranks2, "3": ranks3, "4": ranks4}[world][name]
    _same_on_ranks(runs)
    _close(runs[0], one[name], 1e-12)


@pytest.mark.parametrize("mode", list(SERVING))
def test_serving_matches_one_process(ranks2, one, mode):
    runs = ranks2["serving " + mode]
    _same_on_ranks(runs)
    rgb, pred = runs[0]
    want_rgb, want_pred = one["serving " + mode]
    _close([rgb], [want_rgb], 1e-12)
    np.testing.assert_array_equal(pred, want_pred)


def test_forward_matches_jax_tp(setup, ranks2):
    """The JAX package's split forward, f32, at the golden tolerances."""
    variables, _, x, _ = setup
    jmodel, _ = tp.jax_variables(0)
    mesh = jax_make_mesh(data=1, model=2)
    params = jax.device_put(variables["params"], jax_param_shardings(
        mesh, variables["params"], tensor_parallel=True))
    stats = jax_put_replicated(mesh, variables["batch_stats"])
    ir, vis = (jax_put_replicated(mesh, jnp.asarray(x[k], jnp.float32))
               for k in ("ir", "vis"))
    _, y, logits = jax.jit(lambda p, s, a, b: jmodel.apply(
        {"params": p, "batch_stats": s}, a, b))(params, stats, ir, vis)
    got_y, got_logits = ranks2["f32"][0]
    np.testing.assert_allclose(got_y, np.asarray(y), rtol=0, atol=3e-5)
    np.testing.assert_allclose(got_logits, np.asarray(logits), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail(ranks2, one, fault):
    with pytest.raises(AssertionError):
        _close(ranks2["fault " + fault][0], one["both"], 1e-6)
