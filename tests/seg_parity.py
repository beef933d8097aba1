"""Shared set-up of the seg-step parity tests (``test_torch_seg_step*.py``):
one mit_b0 ``SegmentationNetwork`` (5 classes) on both sides with the
JAX package's initial weights, the same numpy batch, and each side's
``make_seg_train_step`` run once, with an optimizer that applies nothing
and keeps the gradients (``train_parity``'s) or with the 3-group
poly-warmup AdamW.

The stochastic regularisers are set to 0 on both sides, from the test
only (``no_regularisers``): the JAX package's ``MIT_VARIANTS["mit_b0"]``
and the port's get ``drop_path_rate=0.0``, and each side's
``network.SegFormerHead`` becomes a ``functools.partial`` with
``dropout_rate=0.0``. The two sides draw their masks from different
generators, so the step is compared without them; the draws are tested
apart (``test_torch_regularisers.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import segmif_tpu.models.mit as jax_mit
import segmif_tpu.models.network as jax_network
import segmif_tpu_torch.models.mit as port_mit
import segmif_tpu_torch.models.network as port_network
from segmif_tpu.train.optimizer import adamw_poly_grouped as jax_grouped
from segmif_tpu.train.state import SegTrainState as JaxSegState
from segmif_tpu.train.steps import make_seg_train_step as jax_seg_step
from segmif_tpu_torch.convert import seg_state_dict_from_jax
# the leaves whose exact gradient is zero; their computed gradients are
# rounding noise on both sides (about 2e-7 of the largest gradient in f32)
from segmif_tpu_torch.train.compare import KeepGrads, exact_zero_grad
from segmif_tpu_torch.train.optimizer import adamw_poly_grouped
from segmif_tpu_torch.train.state import SegTrainState
from segmif_tpu_torch.train.steps import make_seg_train_step
from train_parity import _f64, _jax_keep_grads, jax_in_f64

B, H, W, CLASSES = 2, 32, 32, 5
# the optimizer of the AdamW comparison: no warm-up, so that the first
# update moves every leaf (optimizer.learning_rate's order, x 10)
LR, WARMUP, MAX_ITERS = 1e-3, 0, 1000
STAT_KEYS = ("running_mean", "running_var")



def no_regularisers(monkeypatch):
    """Drop-path 0 and dropout 0 on both sides, for this test only."""
    for variants in (jax_mit.MIT_VARIANTS, port_mit.MIT_VARIANTS):
        monkeypatch.setitem(variants, "mit_b0", dataclasses.replace(
            variants["mit_b0"], drop_path_rate=0.0))
    for mod in (jax_network, port_network):
        monkeypatch.setattr(mod, "SegFormerHead", functools.partial(
            mod.SegFormerHead, dropout_rate=0.0))


def jax_variables(seed=0):
    """(model, numpy variables) of the JAX SegmentationNetwork."""
    model = jax_network.SegmentationNetwork("mit_b0", CLASSES)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3))))
    return model, variables


def batch(seed):
    """An image in [0, 1] and labels with about a tenth of the pixels
    ignored (255)."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, CLASSES, (B, H, W)).astype(np.int32)
    label[rng.uniform(size=label.shape) < 0.1] = 255
    return {"image": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
            "label": label}


def _port_names(params, stats):
    """The JAX trees under the port's state-dict names."""
    sd = seg_state_dict_from_jax(params, stats)
    return {k: v for k, v in sd.items() if "num_batches" not in k}


_STEPS = {}


def run_jax(model, variables, data, adamw: bool):
    """(loss, gradients or updated params, batch stats) by the port's
    names, all numpy. The jitted step is kept per (optimizer, dtype), so
    the seeds of one file share one compile."""
    params = {"seg": variables["params"]["seg"]}
    key = (adamw, model.dtype)
    if key not in _STEPS:
        tx = (jax_grouped(params, LR, WARMUP, MAX_ITERS) if adamw
              else _jax_keep_grads())
        _STEPS[key] = (tx, jax.jit(jax_seg_step(model, tx)))
    tx, step = _STEPS[key]
    state = JaxSegState.create(params, variables["batch_stats"], tx)
    new, metrics = step(state, data, jax.random.PRNGKey(0))
    new = jax.tree.map(np.asarray, new)
    leaves = new.params if adamw else new.opt_state
    out = _port_names(leaves, new.batch_stats)
    stats = {k: out.pop(k).numpy() for k in list(out)
             if k.rsplit(".", 1)[-1] in STAT_KEYS}
    return float(metrics["loss"]), {k: v.numpy() for k, v in out.items()}, \
        stats


def port_model(variables, dtype=torch.float32):
    model = port_network.SegmentationNetwork("mit_b0", CLASSES)
    model.load_state_dict(seg_state_dict_from_jax(variables["params"],
                                                  variables["batch_stats"]))
    return model.to(dtype)


def run_port(model, data, adamw: bool, dtype=torch.float32):
    """(loss, gradients or updated params, batch stats), numpy."""
    names = [n for n, _ in model.named_parameters()]
    tx = (adamw_poly_grouped(names, LR, WARMUP, MAX_ITERS) if adamw
          else KeepGrads())
    step = make_seg_train_step(model, tx, compute_dtype=dtype, device="cpu")
    state = SegTrainState.create(model, tx)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in data.items()},
                   0)
    leaves = state.params if adamw else state.opt_state
    return (float(metrics["loss"]),
            {k: v.detach().numpy() for k, v in leaves.items()},
            {k: v.numpy() for k, v in state.batch_stats.items()})


def jax_f64(seed, variables, adamw: bool):
    """The JAX step with f64 compute (``train_parity.jax_in_f64``)."""
    with jax_in_f64():
        model = jax_network.SegmentationNetwork("mit_b0", CLASSES,
                                                dtype=jnp.float64)
        return run_jax(model, _f64(variables), _f64(batch(seed)), adamw)


def assert_leaves_close(got, want, rtol, noise):
    """Every leaf within ``rtol`` of that leaf's largest magnitude; the
    ``exact_zero_grad`` leaves at most ``noise`` of the largest magnitude
    over all leaves, on both sides."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    top = max(np.abs(e).max() for e in want.values())
    for k, e in want.items():
        if exact_zero_grad(k):
            assert max(np.abs(got[k]).max(), np.abs(e).max()) <= \
                noise * top, k
            continue
        tol = rtol * np.abs(e).max() + 1e-12
        np.testing.assert_allclose(got[k], e, rtol=0, atol=tol, err_msg=k)


def assert_stats_close(got, want, rtol):
    """The running buffers within ``rtol`` of each buffer's largest
    magnitude (a channel's running mean may sit near 0)."""
    assert set(got) == set(want)
    for k, e in want.items():
        np.testing.assert_allclose(got[k], e, rtol=0,
                                   atol=rtol * np.abs(e).max(), err_msg=k)
