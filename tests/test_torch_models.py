"""The port's models against the JAX package on the CPU (f32).

Weights cross through ``segmif_tpu_torch.convert``; inputs are made with
numpy from a seed. Tolerances are those of the golden reference tests
(tests/test_reference_parity.py): 2e-4 for seg features and logits, 3e-5
for the fusion net.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_weights import torch_default_init
from segmif_tpu.models.fusion import FusionNetwork as JaxFusionNetwork
from segmif_tpu.models.mit import MIT_VARIANTS as JAX_VARIANTS
from segmif_tpu.models.mit import MixVisionTransformer as JaxMiT
from segmif_tpu.models.network import (
    SegmentationNetwork as JaxSegmentationNetwork,
)
from segmif_tpu_torch.convert import (
    fusion_state_dict_from_jax,
    mit_state_dict_from_jax,
    seg_state_dict_from_jax,
)
from segmif_tpu_torch.models.fusion import FusionNetwork
from segmif_tpu_torch.models.mit import MIT_VARIANTS, MixVisionTransformer
from segmif_tpu_torch.models.network import SegmentationNetwork


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_mit_b0_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    jmodel = JaxMiT(JAX_VARIANTS["mit_b0"])
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(img))
    expect = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    port = _load(MixVisionTransformer(MIT_VARIANTS["mit_b0"]),
                 mit_state_dict_from_jax(_np(variables["params"])))
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    assert len(got) == 4
    for g, e in zip(got, expect):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=2e-4)


def test_segmentation_network_b0_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (2, 32, 64, 3)).astype(np.float32)
    jmodel = JaxSegmentationNetwork("mit_b0", 9, 256)
    variables = _np(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(img)))
    # non-trivial BatchNorm statistics, so the running-stat crossing counts
    bn = variables["batch_stats"]["seg"]["decoder"]["bn"]
    bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)
                  ).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    expect = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    port = _load(SegmentationNetwork("mit_b0", 9, 256),
                 seg_state_dict_from_jax(variables["params"],
                                         variables["batch_stats"]))
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    assert got.shape == (2, 8, 16, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=2e-4)


@pytest.mark.parametrize("tap_res", ["native", "full"])
def test_fusion_network_matches_jax(tap_res):
    rng = np.random.default_rng(2)
    h = w = 32
    ir = rng.uniform(0, 1, (2, h, w, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (2, h, w, 1)).astype(np.float32)
    div = (4, 8) if tap_res == "native" else (1, 1)
    tap1 = rng.normal(0, 1, (2, h // div[0], w // div[0], 64)
                      ).astype(np.float32)
    tap2 = rng.normal(0, 1, (2, h // div[1], w // div[1], 128)
                      ).astype(np.float32)
    args = [jnp.asarray(a) for a in (ir, vis, tap1, tap2)]
    jmodel = JaxFusionNetwork()
    params = torch_default_init(
        _np(jmodel.init(jax.random.PRNGKey(2), *args)["params"]), rng)
    expect = jax.jit(jmodel.apply)({"params": params}, *args)
    port = _load(FusionNetwork(), fusion_state_dict_from_jax(params))
    with torch.inference_mode():
        got = port(*(torch.from_numpy(a) for a in (ir, vis, tap1, tap2)))
    assert got.shape == (2, h, w, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=3e-5)
