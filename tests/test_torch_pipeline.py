"""The port's joint pipeline against the JAX JointPipeline on the CPU (f32),
and the weights round trip through the JAX package's own converters.

mit_b0 at 32x32, weights from a JAX init (fusion weights redrawn at the
reference modules' scale) through
``segmif_tpu_torch.convert.state_dict_from_jax``. Tolerances: fused Y 3e-5
and logits 2e-4 (the golden reference tests' values); fused RGB 1e-4 (the
fused Y through the YCrCb inverse, whose largest coefficient is 1.773).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_weights import torch_default_init
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu.train.checkpoint import (
    load_torch_fusion_network,
    load_torch_seg_network,
)
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.models.network import JointPipeline

B, H, W = 2, 32, 32


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    ir = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    jmodel = JaxJointPipeline("mit_b0", num_classes=9)
    variables = jax.tree.map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ir),
                                jnp.asarray(vis)))
    # fusion weights at the reference modules' scale (see port_weights)
    variables["params"]["fusion"] = torch_default_init(
        variables["params"]["fusion"], rng)
    port = JointPipeline("mit_b0", num_classes=9)
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]),
                         strict=True)
    return jmodel, variables, port.eval(), ir, vis


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """One jit for both JAX calls: __call__ (VIS channel 'r') and fuse
    with VIS channel 'y'."""
    jmodel, variables, _, ir, vis = pair

    def both(v, a, b):
        return (jmodel.apply(v, a, b),
                jmodel.apply(v, a, b, vis_channel="y",
                             method=JaxJointPipeline.fuse))

    return jax.tree.map(np.asarray, jax.jit(both)(variables, ir, vis))


def test_call_matches_jax(pair, jax_outputs):
    _, _, port, ir, vis = pair
    (rgb_e, y_e, logits_e), _ = jax_outputs
    with torch.inference_mode():
        rgb, y, logits = port(torch.from_numpy(ir), torch.from_numpy(vis))
    assert logits.shape == (B, H // 4, W // 4, 9)
    np.testing.assert_allclose(y.numpy(), y_e, atol=3e-5)
    np.testing.assert_allclose(rgb.numpy(), rgb_e, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), logits_e, atol=2e-4)


@pytest.mark.parametrize("vis_channel", ["r", "y"])
def test_fuse_matches_jax(pair, jax_outputs, vis_channel):
    _, _, port, ir, vis = pair
    (rgb_r, y_r, _), (rgb_y, y_y) = jax_outputs
    rgb_e, y_e = (rgb_r, y_r) if vis_channel == "r" else (rgb_y, y_y)
    with torch.inference_mode():
        rgb, y = port.fuse(torch.from_numpy(ir), torch.from_numpy(vis),
                           vis_channel=vis_channel)
    np.testing.assert_allclose(y.numpy(), y_e, atol=3e-5)
    np.testing.assert_allclose(rgb.numpy(), rgb_e, atol=1e-4)
    # the two VIS channels really are different inputs
    assert not np.allclose(y_r, y_y)


def _assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


def test_state_dict_round_trips_through_jax_converters(pair, tmp_path):
    """Port state_dict -> .pth -> segmif_tpu.train.checkpoint loaders gives
    back the JAX params exactly: the port's keys are the reference's."""
    _, variables, port, _, _ = pair
    torch.save(port.seg.state_dict(), tmp_path / "seg.pth")
    torch.save(port.fusion.state_dict(), tmp_path / "fusion.pth")
    seg_params, seg_stats = load_torch_seg_network(tmp_path / "seg.pth")
    fusion_params = load_torch_fusion_network(tmp_path / "fusion.pth")
    _assert_tree_equal(seg_params, variables["params"]["seg"])
    _assert_tree_equal(seg_stats, variables["batch_stats"]["seg"])
    _assert_tree_equal(fusion_params, variables["params"]["fusion"])
    assert "denoise_net.encoder.block1.0.attn.q.weight" in \
        port.seg.state_dict()
    assert {"DRDB1.Dcov1.weight", "ffm.cross.channel_proj1.weight",
            "conv3.weight", "conv4.weight", "relu.weight"} <= \
        set(port.fusion.state_dict())
