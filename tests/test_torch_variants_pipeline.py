"""``JointPipeline(interaction=v)`` of the port against the JAX package's
on the CPU, and the entry points on every variant.

 - Every variant but 'both' (held in test_torch_pipeline.py): mit_b0,
   batch 2 at 32x32, weights from a JAX init (fusion weights redrawn at
   the reference modules' scale) through ``convert.state_dict_from_jax``;
   the fused Y held to 3e-5 and the logits to 2e-4 (the golden reference
   tests' values).
 - Every variant: ``serving.make_serving_fn`` gives the pipeline's own
   outputs; ``serving.quantize_for_serving`` quantises the four DRDBs (the
   only int8 modules) and serves finite outputs; one
   ``train.steps.make_fusion_train_step`` step per round kind moves every
   fusion leaf that takes a gradient.
 - One round >= 2 fusion step of 'moam' in f64 on both sides
   (``train_parity.assert_step_matches_jax_f64``): losses within rtol
   1e-6, every gradient leaf within 1e-5 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_weights import torch_default_init
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu_torch import serving
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.models.fusion import INTERACTIONS
from segmif_tpu_torch.models.network import JointPipeline, init_params
from segmif_tpu_torch.train.optimizer import adamw_poly
from segmif_tpu_torch.train.state import FusionTrainState
from segmif_tpu_torch.train.steps import make_fusion_train_step
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import assert_step_matches_jax_f64

B, H, W = 2, 32, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return rng, (rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32),
                 rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32))


@pytest.mark.parametrize("interaction",
                         [v for v in INTERACTIONS if v != "both"])
def test_pipeline_variant_matches_jax(interaction):
    rng, (ir, vis) = _inputs(INTERACTIONS.index(interaction))
    jmodel = JaxJointPipeline("mit_b0", num_classes=9,
                              interaction=interaction)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(ir), jnp.asarray(vis)))
    variables["params"]["fusion"] = torch_default_init(
        variables["params"]["fusion"], rng)
    _, want_y, want_logits = jax.tree.map(np.asarray, jax.jit(
        jmodel.apply)(variables, ir, vis))
    port = JointPipeline("mit_b0", num_classes=9, interaction=interaction)
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]),
                         strict=True)
    with torch.inference_mode():
        _, got_y, got_logits = port.eval()(torch.from_numpy(ir),
                                           torch.from_numpy(vis))
    assert got_logits.shape == (B, H // 4, W // 4, 9)
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=0, atol=3e-5)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("interaction", INTERACTIONS)
def test_entry_points_run_on_variant(interaction):
    _, (ir, vis) = _inputs(20)
    ir, vis = torch.from_numpy(ir), torch.from_numpy(vis)
    model = init_params(JointPipeline("mit_b0", num_classes=9,
                                      interaction=interaction),
                        torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        want_rgb, _, _ = model(ir, vis)
    rgb, pred = serving.make_serving_fn(model, device="cpu")(ir, vis)
    torch.testing.assert_close(rgb, want_rgb, rtol=0, atol=0)
    assert pred.shape == (B, H, W) and pred.dtype == torch.int32

    qmodel = serving.quantize_for_serving(model, (ir, vis), device="cpu")
    assert [d.quant for d in qmodel.fusion.drdbs()] == ["int8"] * 4
    assert model.fusion.DRDB1.quant == "none"
    q_rgb, q_pred = serving.make_serving_fn(qmodel, device="cpu")(ir, vis)
    assert bool(torch.isfinite(q_rgb).all())
    assert 0 <= int(q_pred.min()) and int(q_pred.max()) < 9

    label = torch.randint(0, 9, (B, H, W), generator=torch.Generator()
                          .manual_seed(1))
    batch = {"ir": ir, "vis": vis, "guide": vis, "label": label}
    for round1 in (True, False):
        tx = adamw_poly(1e-3, 0, 100)
        state = FusionTrainState.create(model.fusion, tx)
        before = {k: v.clone() for k, v in state.params.items()}
        step = make_fusion_train_step(model, tx, round1,
                                      compute_dtype=torch.float32,
                                      device="cpu")
        metrics = step(state, batch, 0.4)
        assert bool(torch.isfinite(metrics["loss"]))
        moved = [k for k, v in state.params.items()
                 if not torch.equal(v, before[k])]
        assert len(moved) == len(before), sorted(set(before) - set(moved))


def test_moam_round2_step_matches_jax_f64():
    assert_step_matches_jax_f64(round1=False, seed=1, interaction="moam")
