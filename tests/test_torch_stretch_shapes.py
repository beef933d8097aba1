"""The stretch config's shapes in the port against the JAX package's, on
the meta device (no weights are drawn and nothing is computed): the
counterparts of ``tests/test_entry_shapes.py``'s mit_b4 / mit_b5 checks
(the mit_b5 parameter count, equal to the JAX count and in the published
range; the stage widths; the stretch config's pipeline traced at
1080x1920 through every kernel operator's shape function) and the
converter carrying a JAX mit_b5 pipeline (names and shapes from
``jax.eval_shape``) leaf for leaf.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmif_tpu.models.mit import MIT_VARIANTS as JAX_MIT
from segmif_tpu.models.mit import MixVisionTransformer as JaxMiT
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu_torch.config import load_yaml
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.models.mit import MIT_VARIANTS, MixVisionTransformer
from segmif_tpu_torch.models.network import JointPipeline

CONFIG = "configs/stretch_1080p.yaml"


def _jax_count(variant):
    variables = jax.eval_shape(lambda: JaxMiT(JAX_MIT[variant]).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    return int(sum(np.prod(p.shape) for p in jax.tree.leaves(variables)))


def test_mit_b5_param_count():
    with torch.device("meta"):
        enc = MixVisionTransformer(MIT_VARIANTS["mit_b5"])
    n = sum(p.numel() for p in enc.parameters())
    # published mit_b5 encoder is ~81.4M params
    assert 78e6 < n < 85e6, n
    assert n == _jax_count("mit_b5")


@pytest.mark.parametrize("variant", ["mit_b4", "mit_b5"])
def test_mit_b4_b5_shapes_traced(variant):
    with torch.device("meta"):
        enc = MixVisionTransformer(MIT_VARIANTS[variant])
        feats = enc(torch.zeros((1, 64, 64, 3)))
    assert [f.shape[-1] for f in feats] == [64, 128, 320, 512]
    assert [tuple(f.shape[1:3]) for f in feats] == [(16, 16), (8, 8),
                                                     (4, 4), (2, 2)]
    assert MIT_VARIANTS[variant].depths == JAX_MIT[variant].depths


def test_stretch_config_loads_and_traces():
    """The stretch config's pipeline at 1080x1920 in bf16, every kernel
    operator through its shape function (meta tensors)."""
    cfg = load_yaml(CONFIG)
    assert cfg.backbone == "mit_b5"
    assert cfg.data.num_classes == 15
    assert tuple(cfg.data.resize_range) == (1080, 1920)
    with torch.device("meta"):
        model = JointPipeline(cfg.backbone, cfg.data.num_classes,
                              cfg.embedding_dim).to(torch.bfloat16).eval()
        ir = torch.zeros((1, 1080, 1920, 1), dtype=torch.bfloat16)
        vis = torch.zeros((1, 1080, 1920, 3), dtype=torch.bfloat16)
        with torch.no_grad():
            fused_rgb, fused_y, logits = model(ir, vis)
    assert fused_rgb.shape == (1, 1080, 1920, 3)
    assert fused_y.shape == (1, 1080, 1920, 1)
    assert logits.shape == (1, 270, 480, cfg.data.num_classes)


def test_converter_carries_a_jax_mit_b5_pipeline():
    """Every leaf of a JAX mit_b5 pipeline (15 classes) lands on a port
    state-dict key of the transposed shape, and every port key is
    filled."""
    jmodel = JaxJointPipeline("mit_b5", num_classes=15)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)),
        jnp.zeros((1, 64, 64, 3))))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    with torch.device("meta"):
        port = JointPipeline("mit_b5", num_classes=15)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    # one key per JAX leaf, and the BatchNorm step count the port adds
    tracked = sum(k.endswith("num_batches_tracked") for k in want)
    assert tracked == 1
    assert len(jax.tree.leaves(shapes)) == len(want) - tracked
