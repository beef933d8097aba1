"""The port's evaluation (``segmif_tpu_torch.eval``) against the JAX
package's on the CPU: the confusion matrix (the ignore label 255 and an
absent class included), ``scores`` and ``compute_results`` equal; and
``segmentation_eval``, ``generate_fused`` and ``fusion_quality_eval``
from the same weights (converted with ``convert.state_dict_from_jax``):
mit_b0 at 32x32, 3 samples in batches of 2 (the last one padded), f32.
The confusion matrices equal, the fused images within 1e-5, SSIM and MSE
within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_weights import torch_default_init
from segmif_tpu.eval import evaluator as jax_eval
from segmif_tpu.eval.metrics import compute_results as jax_compute_results
from segmif_tpu.eval.metrics import confusion_matrix as jax_confusion
from segmif_tpu.eval.metrics import scores as jax_scores
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu.train.steps import make_fuse_fn as jax_make_fuse_fn
from segmif_tpu.train.steps import make_segment_fn as jax_make_segment_fn
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
from segmif_tpu_torch.eval import evaluator
from segmif_tpu_torch.eval.image_io import fused_to_uint8, load_fused_dir
from segmif_tpu_torch.eval.metrics import (compute_results, confusion_matrix,
                                           scores)
from segmif_tpu_torch.models.network import JointPipeline
from segmif_tpu_torch.train.steps import make_fuse_fn, make_segment_fn
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

C = 9


def _labels(seed, shape=(4, 16, 16)):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, C, shape)
    pred = rng.integers(0, C, shape)
    true.flat[::7] = 255
    true[true == 4] = 3          # class 4 absent from the truth
    pred[pred == 6] = 5          # and class 6 from the predictions
    return true, pred


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_and_scores_equal_jax(seed):
    true, pred = _labels(seed)
    got = confusion_matrix(torch.from_numpy(true), torch.from_numpy(pred), C)
    want = np.asarray(jax_confusion(jnp.asarray(true), jnp.asarray(pred), C))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == (true != 255).sum()
    s, t = scores(got.numpy()), jax_scores(want)
    for k in ("Pixel Accuracy", "Mean Accuracy", "Mean IoU"):
        np.testing.assert_array_equal(s[k], t[k], err_msg=k)
    np.testing.assert_array_equal(list(s["Class IoU"].values()),
                                  list(t["Class IoU"].values()))
    for a, b in zip(compute_results(got.numpy()), jax_compute_results(want)):
        np.testing.assert_array_equal(a, b)
    precision, recall, iou = compute_results(got.numpy())
    assert np.isnan(recall[4]) and precision[4] == 0.0   # absent truth
    assert np.isnan(precision[6]) and recall[6] == 0.0   # never predicted


@pytest.fixture(scope="module")
def models():
    jmodel = JaxJointPipeline("mit_b0", num_classes=C)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)),
        jnp.zeros((1, 32, 32, 3))))
    variables["params"]["fusion"] = torch_default_init(
        variables["params"]["fusion"], np.random.default_rng(0))
    port = JointPipeline("mit_b0", num_classes=C)
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return jmodel, variables, port.eval()


def test_generate_fused_and_quality_equal_jax(models, tmp_path):
    jmodel, variables, port = models
    ds = SyntheticFusionDataset(n=3, size=(32, 32))
    jn, jf, jl = jax_eval.generate_fused(jax.jit(jax_make_fuse_fn(jmodel)),
                                         variables, ds, batch_size=2)
    seen = []
    names, fused, labels = evaluator.generate_fused(
        make_fuse_fn(port, torch.float32, "cpu"), ds, batch_size=2,
        device="cpu")
    assert names == jn and fused.dtype == np.float32
    assert fused.shape == jf.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(fused, jf, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, jl)
    # the sink gets each batch (the padded sample dropped) instead
    _, none, _ = evaluator.generate_fused(
        make_fuse_fn(port, torch.float32, "cpu"), ds, batch_size=2,
        device="cpu", sink=lambda s, f, g: seen.append((s, f, g)))
    assert none is None and [s for s, _, _ in seen] == [0, 2]
    np.testing.assert_allclose(np.concatenate([f for _, f, _ in seen]),
                               fused, rtol=0, atol=0)
    guide = np.stack([ds[i][3] for i in range(3)]) / 255.0
    q = evaluator.fusion_quality_eval(fused, guide.astype(np.float32),
                                      device="cpu")
    qj = jax_eval.fusion_quality_eval(jf, guide.astype(np.float32))
    for k in ("ssim", "mse"):
        np.testing.assert_allclose(q[k], qj[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # out_dir: each batch's real images as PNGs, quantised together, as
    # the JAX package writes them; the two sides' fused arrays differ by
    # up to 1e-5, so a value within that of a level boundary may land one
    # level apart (none did here)
    for reference in (True, False):
        mine, ref = tmp_path / f"port{reference}", tmp_path / f"jax{reference}"
        evaluator.generate_fused(make_fuse_fn(port, torch.float32, "cpu"),
                                 ds, batch_size=2, out_dir=mine,
                                 quantize_like_reference=reference,
                                 device="cpu")
        jax_eval.generate_fused(jax.jit(jax_make_fuse_fn(jmodel)), variables,
                                ds, batch_size=2, out_dir=ref,
                                quantize_like_reference=reference)
        got, want = (load_fused_dir(d) * 255 for d in (mine, ref))
        np.testing.assert_array_equal(got, np.concatenate([
            fused_to_uint8(fused[s:s + 2], reference) for s in (0, 2)]))
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() <= 1e-3


def test_segmentation_eval_equals_jax(models, tmp_path):
    jmodel, variables, port = models
    ds = SyntheticFusionDataset(n=3, size=(32, 32))
    want = jax_eval.segmentation_eval(
        jax.jit(jax_make_segment_fn(jmodel)), variables, ds, C,
        batch_size=2)
    log = tmp_path / "val.txt"
    got = evaluator.segmentation_eval(
        make_segment_fn(port.seg, torch.float32, "cpu"), ds, C,
        batch_size=2, log_file=str(log), tag="t", device="cpu")
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    assert got["confusion"].sum() == 3 * 32 * 32
    for k in ("mIoU", "pixel_acc", "mean_acc"):
        assert got[k] == want[k], k
    for k in ("precision", "recall", "iou"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert log.read_text().startswith("== t ==")
