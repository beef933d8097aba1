"""Shared set-up of the fusion-train-step parity tests
(``test_torch_train_step*.py``): one mit_b0 JointPipeline (5 classes, f32
weights) on both sides, the same numpy batch, and each side's step run
with an optimizer that applies nothing and keeps the gradients it was
given, so a step returns its gradients exactly. The steps compute in f32
(``assert_step_matches_jax``) or in f64 on both sides
(``assert_step_matches_jax_f64``).

JAX: ``optax.GradientTransformation`` whose ``update`` returns zero
updates and the gradients as its new state. Port:
``train.compare.KeepGrads``, with ``optimizer.AdamW``'s contract. The JAX gradient tree crosses
through ``convert.fusion_state_dict_from_jax``, as the weights do.
"""
import contextlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from port_weights import torch_default_init
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu.train.state import FusionTrainState as JaxState
from segmif_tpu.train.steps import make_fusion_train_step as jax_step
from segmif_tpu_torch.convert import (fusion_state_dict_from_jax,
                                      state_dict_from_jax)
from segmif_tpu_torch.models.network import JointPipeline
from segmif_tpu_torch.train.compare import KeepGrads
from segmif_tpu_torch.train.state import FusionTrainState
from segmif_tpu_torch.train.steps import make_fusion_train_step

B, H, W, CLASSES = 2, 32, 32, 5
FUSION_SCALE = 0.4


def jax_variables(seed=0, interaction="both"):
    """JAX variables (numpy), fusion weights redrawn at the reference
    modules' scale (``port_weights``)."""
    model = JaxJointPipeline("mit_b0", num_classes=CLASSES, dtype=jnp.float32,
                             interaction=interaction)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 1)),
        jnp.zeros((1, H, W, 3))))
    variables["params"]["fusion"] = torch_default_init(
        variables["params"]["fusion"], np.random.default_rng(seed))
    return model, variables


def batch(seed, lead=(B,)):
    """Inputs in [0, 1] and labels with about a tenth of the pixels
    ignored (255)."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, CLASSES, lead + (H, W)).astype(np.int32)
    label[rng.uniform(size=label.shape) < 0.1] = 255
    return {"ir": rng.uniform(0, 1, lead + (H, W, 1)).astype(np.float32),
            "vis": rng.uniform(0, 1, lead + (H, W, 3)).astype(np.float32),
            "guide": rng.uniform(0, 1, lead + (H, W, 3)).astype(np.float32),
            "label": label}


def _jax_keep_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def run_jax(model, variables, data, round1, grad_accum):
    """(metrics, gradients as the port's state-dict keys, DWA state)."""
    tx = _jax_keep_grads()
    step = jax.jit(jax_step(model, tx, round1=round1, grad_accum=grad_accum))
    seg_vars = {"params": {"seg": variables["params"]["seg"]},
                "batch_stats": {"seg": variables["batch_stats"]["seg"]}}
    state = JaxState.create(variables["params"]["fusion"], tx)
    new, metrics = step(state, seg_vars, data, jnp.float32(FUSION_SCALE))
    grads = fusion_state_dict_from_jax(jax.tree.map(np.asarray,
                                                    new.opt_state))
    return (jax.tree.map(np.asarray, metrics), grads,
            jax.tree.map(np.asarray, new.dwa))


def port_model(variables, interaction="both"):
    model = JointPipeline("mit_b0", num_classes=CLASSES,
                          interaction=interaction)
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return model


def run_port(model, data, round1, grad_accum, dtype=torch.float32):
    """(metrics, gradients, DWA state, state) of one port step on the CPU
    in ``dtype``."""
    tx = KeepGrads()
    step = make_fusion_train_step(model, tx, round1, grad_accum=grad_accum,
                                  compute_dtype=dtype, device="cpu")
    state = FusionTrainState.create(model.fusion, tx)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in data.items()},
                   FUSION_SCALE)
    return metrics, state.opt_state, state.dwa, state


# The data seed of the f32 comparison. In f32 a relu input that lies
# within rounding of zero can take the other branch in one implementation
# than in the other, and one pixel's flipped relu' moves a DRDB bias or
# weight gradient by that pixel's cotangent: on seeds 1-16 about half the
# draws held such a pixel for at least one of the four step variants, and
# the two sides then differed by up to 2.9e-2 of a leaf's largest
# magnitude. Seed 13 holds none. The f64 comparison
# (``assert_step_matches_jax_f64``), where no relu input lies within
# rounding of zero, holds the step on seeds 1-4.
DATA_SEED = 13


def assert_step_matches_jax(round1, grad_accum):
    """The port's step against JAX's: losses within rtol 1e-4, every
    gradient leaf within 1e-3 of that leaf's largest magnitude (+1e-7),
    the DWA state within 1e-6."""
    model, variables = jax_variables()
    lead = (grad_accum, B) if grad_accum > 1 else (B,)
    data = batch(DATA_SEED, lead)
    want_m, want_g, want_dwa = run_jax(model, variables, data, round1,
                                       grad_accum)
    got_m, got_g, got_dwa, _ = run_port(port_model(variables), data, round1,
                                        grad_accum)
    for k in ("loss", "loss_fusion", "loss_seg"):
        np.testing.assert_allclose(got_m[k].numpy(), want_m[k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got_m["weights"].numpy(), want_m["weights"],
                               atol=1e-6)
    assert set(got_g) == set(want_g), sorted(set(got_g) ^ set(want_g))
    for k, e in want_g.items():
        e = e.numpy()
        tol = 1e-3 * np.abs(e).max() + 1e-7
        np.testing.assert_allclose(got_g[k].numpy(), e, rtol=0, atol=tol,
                                   err_msg=k)
    for name in ("prev", "prev2"):
        np.testing.assert_allclose(getattr(got_dwa, name).numpy(),
                                   getattr(want_dwa, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert int(got_dwa.step) == int(want_dwa.step) == 1
    if round1:
        assert float(got_m["loss_seg"]) == 0.0
    else:
        assert float(got_m["loss_seg"]) > 0.0


class _NumpyF64(types.ModuleType):
    """jax.numpy with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def jax_in_f64():
    """x64 on, and the JAX package's own f32 casts (``jnp.float32``: the
    FFM's grams, contexts and LayerNorms, the logits before the loss)
    lifted to f64 for the duration, so that the JAX step computes in f64
    end to end, as the port's f64 step does. The package's files are not
    touched: each of its modules' ``jnp`` name is pointed at a view of
    jax.numpy whose float32 is float64, and restored after."""
    view = _NumpyF64("jax.numpy, f64")
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("segmif_tpu.") and
            getattr(m, "jnp", None) is jnp]
    for m in mods:
        m.jnp = view
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for m in mods:
            m.jnp = jnp


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(np.float64)
                        if a.dtype == np.float32 else a, tree)


def assert_step_matches_jax_f64(round1, seed, interaction="both"):
    """The port's step against JAX's with both in f64 (the JAX step under
    ``jax_in_f64``, the port's with ``compute_dtype=torch.float64``) on
    data seed ``seed``, for the fusion net's ``interaction``: losses
    within rtol 1e-6, every gradient leaf within 1e-5 of that leaf's
    largest magnitude, the DWA state (an f32 buffer in the port) within
    1e-6. The JAX gradients cross ``convert`` in f32 (6e-8 of each
    element)."""
    model, variables = jax_variables(interaction=interaction)
    data = batch(seed)
    with jax_in_f64():
        m64 = JaxJointPipeline("mit_b0", num_classes=CLASSES,
                               dtype=jnp.float64, interaction=interaction)
        want_m, want_g, want_dwa = run_jax(m64, _f64(variables),
                                           _f64(data), round1, 1)
    got_m, got_g, got_dwa, _ = run_port(port_model(variables, interaction),
                                        _f64(data), round1, 1, torch.float64)
    for k in ("loss", "loss_fusion", "loss_seg"):
        np.testing.assert_allclose(got_m[k].numpy(), want_m[k], rtol=1e-6,
                                   err_msg=k)
    assert set(got_g) == set(want_g), sorted(set(got_g) ^ set(want_g))
    for k, e in want_g.items():
        e = e.numpy()
        assert got_g[k].dtype == torch.float64, k
        tol = 1e-5 * np.abs(e).max() + 1e-12
        np.testing.assert_allclose(got_g[k].numpy(), e, rtol=0, atol=tol,
                                   err_msg=k)
    for name in ("prev", "prev2"):
        np.testing.assert_allclose(getattr(got_dwa, name).numpy(),
                                   getattr(want_dwa, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert int(got_dwa.step) == int(want_dwa.step) == 1
