"""The port's batched augmentation (``segmif_tpu_torch.data.augment``)
against the JAX package's, with the JAX keys' draws handed to the port's
``apply`` (``aug_draws.jax_draws``):

 - images within 1e-5 on [0, 1], the photometric distortion within 1e-3
   on [0, 255];
 - labels equal, except where a source coordinate lies within f32
   rounding of a half-pixel boundary (round half to even then goes either
   way), which is asserted pixel by pixel;

and the JAX package's own cases (tests/test_data.py): the shapes, a plain
window without augmentation, the HSV round trip, photometric identity at
zero ranges, and the first acceptable crop candidate taken (else the
last).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aug_draws import jax_draws
from segmif_tpu.data.augment import AugConfig as JaxAugConfig
from segmif_tpu.data.augment import augment_batch as jax_augment_batch
from segmif_tpu.data.augment import photometric_distortion as jax_photo
from segmif_tpu_torch.data import augment
from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

CLASSES = 9


def _batch(n=3, size=(48, 64), seed=0):
    """uint8 images and int32 labels, as the trainer's in-memory data."""
    ds = SyntheticFusionDataset(n=n, size=size, seed=seed)
    cols = list(zip(*[ds[i][1:] for i in range(n)]))
    imgs = [np.uint8(np.clip(np.stack(c), 0, 255)) for c in cols[:3]]
    return imgs + [np.stack(cols[3]).astype(np.int32)]


def _port(draws, arrays, cfg):
    return augment.apply(draws, *(torch.from_numpy(a) for a in arrays),
                         cfg, CLASSES)


def _half_pixel(coord, tol=1e-4):
    """Whether a source coordinate lies within f32 rounding of k + 0.5."""
    return np.abs(np.abs(coord - np.floor(coord)) - 0.5) < tol


@pytest.mark.parametrize("seed,crop", [(0, 32), (1, 32), (2, 40)])
def test_augment_matches_jax_with_its_draws(seed, crop):
    cfg = augment.AugConfig(crop_size=crop)
    arrays = _batch(seed=seed)
    key = jax.random.PRNGKey(seed)
    want = jax_augment_batch(key, *(jnp.asarray(a) for a in arrays),
                             JaxAugConfig(crop_size=crop), CLASSES)
    draws = jax_draws(key, 3, cfg)
    got = _port(draws, arrays, cfg)
    for k in ("ir", "vis", "guide"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    lab_g, lab_w = got["label"].numpy(), np.asarray(want["label"])
    differ = lab_g != lab_w
    if differ.any():
        # the port's source coordinates of the picked crop, in f64
        off = augment._pick_crop_offsets(draws, torch.from_numpy(
            arrays[3]).long(), cfg, CLASSES)
        d64 = {k: v.double() for k, v in draws.items() if k != "flip"}
        rows, cols = augment._warp_coords(
            crop, d64["scale"], off[0].double(), off[1].double(),
            draws["flip"], *arrays[3].shape[1:])
        near = (_half_pixel(rows.numpy())[:, :, None]
                | _half_pixel(cols.numpy())[:, None, :])
        assert near[differ].all(), np.argwhere(differ & ~near)[:5]
    assert differ.mean() < 0.01


def test_photometric_matches_jax_with_its_draws():
    cfg = augment.AugConfig()
    img = np.random.default_rng(5).uniform(0, 255, (4, 16, 16, 3)).astype(
        np.float32)
    for s in range(3):
        key = jax.random.PRNGKey(10 + s)
        draws = jax_draws(key, 4, cfg)
        keys = jax.random.split(key, 4)
        want = np.stack([np.asarray(jax_photo(
            jax.random.split(k, 4)[3], jnp.asarray(img[i]), JaxAugConfig()))
            for i, k in enumerate(keys)])
        got = augment.photometric_distortion(torch.from_numpy(img), draws)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_augment_shapes():
    cfg = augment.AugConfig(crop_size=32)
    gen = torch.Generator().manual_seed(0)
    out = augment.augment_batch(gen, *(torch.from_numpy(a)
                                       for a in _batch()), cfg, CLASSES)
    assert out["ir"].shape == (3, 32, 32, 1)
    assert out["vis"].shape == out["guide"].shape == (3, 32, 32, 3)
    assert out["label"].shape == (3, 32, 32)
    assert out["vis"].dtype == torch.float32
    assert 0.0 <= out["vis"].min() and out["vis"].max() <= 1.0 + 1e-6


def test_augment_deterministic_per_seed():
    cfg = augment.AugConfig(crop_size=32)
    arrays = [torch.from_numpy(a) for a in _batch()]

    def run(seed):
        return augment.augment_batch(torch.Generator().manual_seed(seed),
                                     *arrays, cfg, CLASSES)["vis"]

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(7))


def test_augment_identity_when_no_aug():
    """scale 1, no flip, no photometric: the label crop is a window of
    the source."""
    cfg = augment.AugConfig(crop_size=32, scale_min=1.0, scale_max=1.0,
                            flip_prob=0.0, brightness_delta=0.0,
                            contrast_range=(1.0, 1.0),
                            saturation_range=(1.0, 1.0), hue_delta=0.0)
    arrays = _batch(n=2)
    out = augment.augment_batch(torch.Generator().manual_seed(0),
                                *(torch.from_numpy(a) for a in arrays), cfg,
                                CLASSES)
    full = arrays[3]
    for b in range(2):
        crop = out["label"][b].numpy()
        assert any(np.array_equal(full[b, oh:oh + 32, ow:ow + 32], crop)
                   for oh in range(full.shape[1] - 31)
                   for ow in range(full.shape[2] - 31))


def test_photometric_identity_ranges():
    cfg = augment.AugConfig(brightness_delta=0.0, contrast_range=(1.0, 1.0),
                            saturation_range=(1.0, 1.0), hue_delta=0.0)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (2, 16, 16, 3)).astype(np.float32))
    draws = augment.draw(torch.Generator().manual_seed(0), 2, cfg)
    draws["coins"][:] = True
    out = augment.photometric_distortion(img, draws)
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-2)


def test_hsv_roundtrip():
    rgb = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 255, (8, 8, 3)).astype(np.float32))
    back = augment._hsv_to_rgb(*augment._rgb_to_hsv(rgb))
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), atol=1e-2)


def test_first_acceptable_crop_is_taken():
    """Columns 0-15 hold one class (a crop there is rejected: ratio 1 >=
    0.75), columns 16-31 cycle through four. Candidates: rejected,
    accepted, accepted -> the second; all rejected -> the last."""
    cfg = augment.AugConfig(crop_size=8, scale_min=1.0, scale_max=1.0,
                            flip_prob=0.0, crop_tries=3)
    lab = np.zeros((1, 8, 32), np.int64)
    lab[0, :, 16:] = np.arange(16) % 4 + 1
    img = torch.zeros((1, 8, 32, 3))
    draws = augment.draw(torch.Generator().manual_seed(0), 1, cfg)
    draws["scale"][:] = 1.0
    # column offsets u * (32 - 8): 0 (rejected), 16, 24 (both accepted)
    draws["crop_u"][0, :, 0] = 0.0
    draws["crop_u"][0, :, 1] = torch.tensor([0.0, 16 / 24, 1.0])
    out = augment.apply(draws, img, img, img, torch.from_numpy(lab), cfg, 5)
    np.testing.assert_array_equal(out["label"][0].numpy(), lab[0, :, 16:24])
    draws["crop_u"][0, :, 1] = torch.tensor([0.0, 0.1, 0.2])
    out = augment.apply(draws, img, img, img, torch.from_numpy(lab), cfg, 5)
    w = round(0.2 * 24)
    np.testing.assert_array_equal(out["label"][0].numpy(), lab[0, :, w:w + 8])
