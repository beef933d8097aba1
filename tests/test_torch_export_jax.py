"""The port's ``.pt2`` serving program against the JAX package's StableHLO
artifact built from the same weights (``segmif_tpu.serving``), on the CPU
at mit_b0 32x32, batch 1, f32: the fused RGB within 3e-5 (the golden
fusion tolerance, ``tests/test_reference_parity.py:74``) and the class map
equal. Fusion weights at the reference modules' scale (``port_weights``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from port_weights import torch_default_init
from segmif_tpu import serving as jax_serving
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu_torch import serving
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.models.network import JointPipeline

B, H, W = 1, 32, 32


def test_port_artifact_matches_jax_artifact(tmp_path):
    rng = np.random.default_rng(2)
    ir = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    jmodel = JaxJointPipeline("mit_b0", num_classes=9)
    np_vars = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.asarray(ir), jnp.asarray(vis)))
    np_vars["params"]["fusion"] = torch_default_init(
        np_vars["params"]["fusion"], rng)
    jpath = tmp_path / "serve.stablehlo"
    jax_serving.save_serving_artifact(jpath, jax_serving.export_serving_artifact(
        jmodel, jax.tree.map(jnp.asarray, np_vars), B, H, W))
    j_rgb, j_pred = (np.asarray(t) for t in jax_serving.load_serving_artifact(
        jpath)(jnp.asarray(ir), jnp.asarray(vis)))

    port = JointPipeline("mit_b0", num_classes=9)
    port.load_state_dict(state_dict_from_jax(np_vars["params"],
                                             np_vars["batch_stats"]))
    path = tmp_path / "serve.pt2"
    serving.save_serving_artifact(path, serving.export_serving_artifact(
        port, B, H, W, device="cpu"))
    rgb, pred = serving.load_serving_artifact(path)(torch.from_numpy(ir),
                                                    torch.from_numpy(vis))
    np.testing.assert_allclose(rgb.numpy(), j_rgb, atol=3e-5)
    np.testing.assert_array_equal(pred.numpy(), j_pred)
