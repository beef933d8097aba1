"""The port's fused-image writer and reader (``eval.image_io``) and its
colormaps and grids (``eval.visual``) against the JAX package's:
``fused_to_uint8`` in both modes (the reference's double truncation with
its batch-global stretch, and the single rounding) bit for bit, the PNG
round trip, ``write_fused_batch`` and ``load_fused_dir``, and every
function of ``visual.py``; and ``generate_fused(out_dir=...)``'s stretch
over the real images of a padded last batch only."""
import numpy as np
import pytest
import torch

import segmif_tpu.eval.image_io as jax_io
import segmif_tpu.eval.visual as jax_visual
from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
from segmif_tpu_torch.eval import evaluator, image_io, visual
from segmif_tpu_torch.models.network import JointPipeline, init_params
from segmif_tpu_torch.train.steps import make_fuse_fn
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


def _fused(seed, shape=(3, 10, 12, 3), lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("reference", [True, False])
@pytest.mark.parametrize("seed,lo,hi", [(0, -0.2, 1.2), (1, 0.3, 0.6),
                                        (2, 0.5, 0.5)])
def test_fused_to_uint8_equals_jax(reference, seed, lo, hi):
    x = _fused(seed, lo=lo, hi=hi)
    got = image_io.fused_to_uint8(x, reference)
    want = jax_io.fused_to_uint8(x, reference)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if hi > lo:   # the stretch reaches both ends over the batch
        assert got.min() == 0 and got.max() == 255


def test_the_two_modes_differ():
    x = _fused(3, lo=0.3, hi=0.6)
    assert not np.array_equal(image_io.fused_to_uint8(x, True),
                              image_io.fused_to_uint8(x, False))


@pytest.mark.parametrize("img", [
    np.arange(60, dtype=np.uint8).reshape(6, 10),
    np.arange(60, dtype=np.uint8).reshape(6, 10, 1),
    (np.arange(180) % 256).astype(np.uint8).reshape(6, 10, 3),
    np.linspace(-20, 300, 180).astype(np.float32).reshape(6, 10, 3)])
def test_save_png_round_trip_equals_jax(tmp_path, img):
    from PIL import Image

    image_io.save_png(tmp_path / "a" / "mine.png", img)
    jax_io.save_png(tmp_path / "b" / "ref.png", img)
    got = np.asarray(Image.open(tmp_path / "a" / "mine.png"))
    want = np.asarray(Image.open(tmp_path / "b" / "ref.png"))
    np.testing.assert_array_equal(got, want)
    expect = np.uint8(np.clip(img, 0, 255)) if img.dtype != np.uint8 else img
    np.testing.assert_array_equal(got, expect.reshape(got.shape))


@pytest.mark.parametrize("reference", [True, False])
def test_write_fused_batch_and_load_fused_dir_equal_jax(tmp_path, reference):
    x = _fused(4)
    names = ["b10.png", "b2.png", "b1.png"]
    image_io.write_fused_batch(tmp_path / "mine", names, x, reference)
    jax_io.write_fused_batch(tmp_path / "ref", names, x, reference)
    got = image_io.load_fused_dir(tmp_path / "mine")
    want = jax_io.load_fused_dir(tmp_path / "ref")
    assert got.dtype == want.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    # sorted name order: b1, b10, b2
    np.testing.assert_array_equal(
        got[1], image_io.fused_to_uint8(x, reference)[0] / np.float32(255))
    assert image_io.load_fused_dir(tmp_path / "none") is None


def test_generate_fused_stretches_only_the_real_images(tmp_path):
    """Three samples in batches of 2: the last batch is padded with a
    repeat, and its file is quantised over its one real image."""
    model = init_params(JointPipeline("mit_b0"),
                        torch.Generator().manual_seed(0))
    ds = SyntheticFusionDataset(n=3, size=(32, 32))
    names, fused, _ = evaluator.generate_fused(
        make_fuse_fn(model, torch.float32, "cpu"), ds, batch_size=2,
        out_dir=tmp_path, quantize_like_reference=True, device="cpu")
    assert names == ds.names and fused.shape == (3, 32, 32, 3)
    got = image_io.load_fused_dir(tmp_path)
    want = np.concatenate([image_io.fused_to_uint8(fused[:2]),
                           image_io.fused_to_uint8(fused[2:])])
    np.testing.assert_array_equal(got, want / np.float32(255))


@pytest.mark.parametrize("n,normalized", [(256, False), (256, True),
                                          (21, False)])
def test_colormap_equals_jax(n, normalized):
    got = visual.colormap(n, normalized)
    want = jax_visual.colormap(n, normalized)
    assert got.dtype == want.dtype and got.shape == (n, 3)
    np.testing.assert_array_equal(got, want)


def test_encode_cmap_equals_jax():
    lab = np.random.default_rng(5).integers(0, 300, (2, 7, 9))
    got = visual.encode_cmap(lab)
    assert got.shape == (2, 7, 9, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_visual.encode_cmap(lab))


@pytest.mark.parametrize("b,nrow,pad,value", [(5, 2, 2, 0), (4, 4, 0, 7),
                                              (1, 3, 1, 255)])
def test_make_grid_equals_jax(b, nrow, pad, value):
    imgs = np.random.default_rng(6).integers(0, 256, (b, 5, 6, 3),
                                             dtype=np.uint8)
    got = visual.make_grid(imgs, nrow, pad, value)
    np.testing.assert_array_equal(got, jax_visual.make_grid(imgs, nrow, pad,
                                                            value))


@pytest.mark.parametrize("with_logits,with_labels", [(True, True),
                                                     (False, False)])
def test_training_image_summary_equals_jax(with_logits, with_labels):
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.1, 1.1, (3, 6, 8, 3)).astype(np.float32)
    logits = rng.normal(size=(3, 6, 8, 9)) if with_logits else None
    labels = rng.integers(0, 9, (3, 6, 8)) if with_labels else None
    got = visual.training_image_summary(x, logits, labels, nrow=2)
    want = jax_visual.training_image_summary(x, logits, labels, nrow=2)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
