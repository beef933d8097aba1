"""bf16 fusion-phase steps against f32 on the CPU, the port beside the JAX
package: mit_b0, 9 classes, batch 1, every layer drawn at the reference
modules' scale (seed 0), seeded inputs, one round >= 2 step each.

The JAX package trains with bf16 compute and f32 params
(segmif_tpu/config.py:119-120). As the image grows, its own bf16 step's
gradient departs from its f32 step's: the FFM's context softmax runs over
grams summed over all of an image's tokens, saturates, and one bf16 step
of its inputs moves its logits by whole units. So a bf16 gradient is
held to a cosine limit only where the reference's own bf16 step meets
it, and elsewhere to the reference's own departure:

 - 64x64: every leaf of the port's bf16 gradient within cosine 0.98 of
   the port's f32 gradient (JAX's own bf16 step within 0.95), all leaves
   as one vector within 0.999, and every leaf's norm within [0.8, 1.25]
   times f32's;
 - 120x160: the JAX bf16 step departs (all leaves as one vector below
   0.99, some leaf below 0.9) and the port's departs no further: its
   whole-gradient cosine and its lowest leaf's are at least JAX's, and
   its norm ratios lie no further from 1 than JAX's farthest.

The f32 steps of the two sides agree (test_torch_train_step*.py); here
their whole-gradient cosine is checked to 0.99999 as a guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_weights import torch_default_init
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import run_jax
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.models.network import JointPipeline
from segmif_tpu_torch.train.compare import (leaf_cosines, norm_ratios,
                                            overall_cosine, step_grads)

CLASSES = 9
FUSION_SCALE = 0.4    # what train_parity.run_jax passes


def _variables(seed=0):
    model = JaxJointPipeline("mit_b0", num_classes=CLASSES,
                             dtype=jnp.float32)
    v = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 1)),
        jnp.zeros((1, 32, 32, 3))))
    return {"params": torch_default_init(v["params"],
                                         np.random.default_rng(seed)),
            "batch_stats": v["batch_stats"]}


def _batch(h, w, seed=1):
    rng = np.random.default_rng(seed)
    return {"ir": rng.uniform(0, 1, (1, h, w, 1)).astype(np.float32),
            "vis": rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32),
            "guide": rng.uniform(0, 1, (1, h, w, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, (1, h, w)).astype(np.int32)}


def _grads(h, w):
    """{'jax'|'port': {'f32'|'bf16': gradients}} of one round >= 2 step."""
    variables, data = _variables(), _batch(h, w)
    out = {"jax": {}, "port": {}}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        model = JaxJointPipeline("mit_b0", num_classes=CLASSES, dtype=dt)
        with jax.default_matmul_precision("default"):
            out["jax"][name] = run_jax(model, variables, data, False, 1)[1]
    model = JointPipeline("mit_b0", num_classes=CLASSES)
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        out["port"][name] = step_grads(model, tdata, False, dt, "cpu",
                                       FUSION_SCALE)[1]
    return out


def _describe(g, side):
    cos = leaf_cosines(g[side]["bf16"], g[side]["f32"])
    ratio = norm_ratios(g[side]["bf16"], g[side]["f32"])
    return {"overall": overall_cosine(g[side]["bf16"], g[side]["f32"]),
            "lowest": min(cos.values()), "cos": cos,
            "ratio": (min(ratio.values()), max(ratio.values()))}


@pytest.mark.parametrize("hw", [(64, 64), (120, 160)])
def test_bf16_step_departs_no_further_than_jax(hw):
    g = _grads(*hw)
    assert overall_cosine(g["port"]["f32"], g["jax"]["f32"]) > 0.99999
    jx, pt = _describe(g, "jax"), _describe(g, "port")
    print(f"{hw}: JAX bf16 vs f32 {jx['overall']:.4f} overall, lowest leaf "
          f"{jx['lowest']:.4f}, norm ratio {jx['ratio'][0]:.3f}-"
          f"{jx['ratio'][1]:.3f}; port {pt['overall']:.4f}, "
          f"{pt['lowest']:.4f}, {pt['ratio'][0]:.3f}-{pt['ratio'][1]:.3f}")
    if hw == (64, 64):
        assert jx["lowest"] >= 0.95, jx["cos"]
        assert pt["lowest"] >= 0.98, pt["cos"]
        assert pt["overall"] >= 0.999
        assert 0.8 <= pt["ratio"][0] and pt["ratio"][1] <= 1.25
    else:
        assert jx["overall"] < 0.99 and jx["lowest"] < 0.9
        assert pt["overall"] >= jx["overall"]
        assert pt["lowest"] >= jx["lowest"]
        far = max(1 / jx["ratio"][0], jx["ratio"][1])
        assert 1 / far <= pt["ratio"][0] and pt["ratio"][1] <= far
