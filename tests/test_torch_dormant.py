"""The port's dormant maths against the JAX package on the CPU: code that
no entry point of either package calls, ported for completeness.

Inputs are made with numpy from a seed and go through the JAX function
and the port's. Tolerances, per test: exact where both sides compute the
same f32 operations (index maps, masks, lookups, the augmentation's
index arithmetic); 1e-6 for f32 elementwise maths; 1e-5 relative for f32
reductions and convolutions summed in other orders; gradients compared
in f64 on both sides within 1e-10 of their largest magnitude (the JAX
package under ``train_parity.jax_in_f64``, which also lifts its filter
windows' f32 to f64), since the soft histogram's Gaussian of width 0.01
turns f32 rounding of a residual into whole percents of a gradient
element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmif_tpu.data import legacy_augment as jaug
from segmif_tpu.eval.metrics import colorize_labels as jax_colorize
from segmif_tpu.kernels import attention as jatt
from segmif_tpu.losses import detection as jdet
from segmif_tpu.losses import fusion_losses as jfl
from segmif_tpu.losses import seg_loss as jseg
from segmif_tpu.ops import color as jcolor
from segmif_tpu.ops import entropy as jent
from segmif_tpu.ops import filters as jfilt
from segmif_tpu.ops import image as jimage
from segmif_tpu_torch.data import legacy_augment as aug
from segmif_tpu_torch.eval.metrics import colorize_labels
from segmif_tpu_torch.kernels import attention as att
from segmif_tpu_torch.losses import detection as det
from segmif_tpu_torch.losses import fusion_losses as fl
from segmif_tpu_torch.losses import seg_loss
from segmif_tpu_torch.ops import color, entropy, filters, image
from segmif_tpu_torch.utils import profiler
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import jax_in_f64


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _rel(got, want, rtol):
    """Within rtol of the reference's largest magnitude."""
    want = np.asarray(want)
    _close(got, want, atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------- color ----

def test_minmax_stretch_is_over_the_whole_batch():
    x = np.random.default_rng(0).normal(size=(3, 5, 6, 1)).astype(np.float32)
    x[1] += 4.0     # the images' ranges differ: a per-image stretch differs
    got = color.minmax_stretch(_t(x))
    _close(got, jcolor.minmax_stretch(jnp.asarray(x)))
    assert float(got.min()) == 0.0 and float(got[1].max()) > 0.99
    assert float(got[0].max()) < 0.9


def test_mean_recombine_matches_jax():
    rng = np.random.default_rng(1)
    mask = rng.uniform(0, 1, (2, 8, 10, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (2, 8, 10, 3)).astype(np.float32)
    _close(color.mean_recombine(_t(mask), _t(vis)),
           jcolor.mean_recombine(jnp.asarray(mask), jnp.asarray(vis)))


# ------------------------------------------------------------ attention ----

@pytest.mark.parametrize("n_q,n_k", [(40, 40), (24, 56)])
def test_linear_cross_attention_matches_jax(n_q, n_k):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, n_q, 64)).astype(np.float32)
    k = rng.normal(size=(2, n_k, 64)).astype(np.float32)
    v = rng.normal(size=(2, n_k, 64)).astype(np.float32)
    scale = 8 ** -0.5
    want, want_ctx = jatt.linear_cross_attention_flat(
        *map(jnp.asarray, (q, k, v)), scale, 8, return_ctx=True)
    got, ctx = att.linear_cross_attention(_t(q), _t(k), _t(v), scale, 8,
                                          return_ctx=True)
    _rel(got, want, 1e-5)
    _close(ctx, want_ctx, atol=1e-6)
    assert ctx.shape == (2, 8, 8, 8)
    # the head-split form of the JAX package gives the same maps
    split = [a.reshape(2, -1, 8, 8) for a in (q, k, v)]
    _, ctx_xla = jatt.linear_cross_attention_xla(
        *map(jnp.asarray, split), scale, return_ctx=True)
    _close(ctx, ctx_xla, atol=1e-6)
    bd = att.linear_ctx_blockdiag(_t(k), _t(v), scale, 8)
    _close(bd, jatt.linear_ctx_blockdiag(jnp.asarray(k), jnp.asarray(v),
                                         scale, 8), atol=1e-6)
    np.testing.assert_array_equal(bd.numpy()[:, :8, 8:], 0.0)


# ---------------------------------------------------------------- image ----

@pytest.mark.parametrize("s", [2, 3, 4])
def test_upsample_bilinear_int_matches_jax(s):
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = image.upsample_bilinear_int(_t(x), s)
    assert got.shape == (2, 5 * s, 7 * s, 3)
    _close(got, jimage.upsample_bilinear_int(jnp.asarray(x), s), atol=1e-6)
    # the same maths as the bilinear resize, to float rounding
    _close(got, image.resize_bilinear(_t(x), (5 * s, 7 * s)), atol=1e-5)


@pytest.mark.parametrize("size", [(11, 3), (5, 7), (13, 29), (2, 1),
                                  (480, 640)])
def test_resize_nearest_matches_jax(size):
    rng = np.random.default_rng(4)
    label = rng.integers(0, 9, (2, 30, 41, 1)).astype(np.int32)
    got = image.resize_nearest(_t(label), size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), jimage.resize_nearest(jnp.asarray(label), size))


def test_pad_to_matches_jax():
    x = np.random.default_rng(5).normal(size=(2, 5, 7, 3)).astype(np.float32)
    for h, w in ((8, 6), (5, 9), (3, 3)):
        np.testing.assert_array_equal(
            image.pad_to(_t(x), h, w, 2.5).numpy(),
            jimage.pad_to(jnp.asarray(x), h, w, 2.5))


# -------------------------------------------------------------- filters ----

@pytest.mark.parametrize("size,sigma", [(3, 2.0), (5, 2.0), (7, 2.0),
                                        (5, 0.8)])
def test_gaussian_blur_matches_jax(size, sigma):
    _close(filters.gaussian_kernel_2d_grid(size, sigma),
           jfilt.gaussian_kernel_2d_grid(size, sigma), atol=1e-7)
    x = np.random.default_rng(6).uniform(size=(2, 12, 15, 2)
                                         ).astype(np.float32)
    _close(filters.gaussian_blur(_t(x), size, sigma),
           jfilt.gaussian_blur(jnp.asarray(x), size, sigma), atol=1e-6)


def test_unsharp_pyramid_matches_jax():
    x = np.random.default_rng(7).uniform(size=(2, 12, 15, 1)
                                         ).astype(np.float32)
    got = filters.unsharp_pyramid(_t(x))
    want = jfilt.unsharp_pyramid(jnp.asarray(x))
    assert len(got) == len(want) == 3
    for g, e in zip(got, want):
        _close(g, e, atol=1e-6)


# -------------------------------------------------------------- entropy ----

@pytest.mark.parametrize("shape,ps", [((2, 16, 12, 1), 4), ((1, 18, 13, 1), 4),
                                      ((2, 12, 12, 2), 3)])
def test_patch_entropy_matches_jax(shape, ps):
    x = np.random.default_rng(8).uniform(size=shape).astype(np.float32)
    _rel(entropy.patch_entropy(_t(x), ps),
         jent.patch_entropy(jnp.asarray(x), patch_size=ps), 1e-5)
    x64 = x.astype(np.float64)
    t = _t(x64).requires_grad_()
    entropy.patch_entropy(t, ps).backward()
    with jax_in_f64():
        want = jax.grad(lambda a: jent.patch_entropy(a, patch_size=ps))(
            jnp.asarray(x64))
    _rel(t.grad, want, 1e-10)


# --------------------------------------------------------- fusion losses ----

def _fusion_inputs(seed=9, lead=(2, 16, 20)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, lead + (c,)).astype(np.float32)
            for c in (1, 3, 1, 3)]   # ir, vis, fused_y, mask


LOSSES = {
    "max_grad": (fl.fusion_loss_max_grad, jfl.fusion_loss_max_grad,
                 lambda ir, vis, y, m: (ir, vis, y)),
    "mask_l1": (fl.fusion_loss_mask_l1, jfl.fusion_loss_mask_l1,
                lambda ir, vis, y, m: (ir, vis, y, m)),
    "lap_l1": (fl.laplacian_pyramid_l1, jfl.laplacian_pyramid_l1,
               lambda ir, vis, y, m: (y, m[..., :1])),
    "lap_max_l1": (fl.laplacian_pyramid_max_l1, jfl.laplacian_pyramid_max_l1,
                   lambda ir, vis, y, m: (y, ir, vis)),
    "l1_lap": (fl.fusion_loss_l1_lap, jfl.fusion_loss_l1_lap,
               lambda ir, vis, y, m: (ir, vis, y, m)),
    "mse_lap_ssim": (fl.fusion_loss_mse_lap_ssim, jfl.fusion_loss_mse_lap_ssim,
                     lambda ir, vis, y, m: (ir, vis, y, m)),
    "iqa_entropy": (fl.iqa_entropy_loss, jfl.iqa_entropy_loss,
                    lambda ir, vis, y, m: (y,)),
}
# the argument that carries the gradient (the fused Y) in each signature
GRAD_ARG = {"max_grad": 2, "mask_l1": 2, "lap_l1": 0, "lap_max_l1": 0,
            "l1_lap": 2, "mse_lap_ssim": 2, "iqa_entropy": 0}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_fusion_loss_matches_jax(name):
    port_fn, jax_fn, pick = LOSSES[name]
    args = pick(*_fusion_inputs())
    _rel(port_fn(*map(_t, args)), jax_fn(*map(jnp.asarray, args)), 1e-5)


@pytest.mark.parametrize("name", ["lap_l1", "lap_max_l1", "l1_lap",
                                  "mse_lap_ssim", "iqa_entropy"])
def test_fusion_loss_gradient_matches_jax(name):
    port_fn, jax_fn, pick = LOSSES[name]
    args = [a.astype(np.float64) for a in pick(*_fusion_inputs(10))]
    i = GRAD_ARG[name]
    ts = [_t(a) for a in args]
    ts[i].requires_grad_()
    port_fn(*ts).backward()
    with jax_in_f64():
        def f(y):
            a = [jnp.asarray(v) for v in args]
            a[i] = y
            return jax_fn(*a)
        want = jax.grad(f)(jnp.asarray(args[i]))
    _rel(ts[i].grad, want, 1e-10)


# ------------------------------------------------------------ seg losses ----

def _seg_case(kind):
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 6, 8, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 6, 8)).astype(np.int32)
    if kind == "ignored":
        labels[rng.uniform(size=labels.shape) < 0.3] = 255
    elif kind == "ties":
        # whole rows of identical pixels: many equal losses at the cut
        logits[:, :4] = logits[:, :1]
        labels[:, :4] = labels[:, :1]
    elif kind == "few_valid":
        # fewer valid pixels than min_kept: every valid pixel is kept
        labels[:] = 255
        labels[0, 0, :2] = 1
    elif kind == "all_ignored":
        labels[:] = 255
    return logits, labels


@pytest.mark.parametrize("kind", ["plain", "ignored", "ties", "few_valid",
                                  "all_ignored"])
@pytest.mark.parametrize("thresh,frac", [(0.7, 1 / 16), (0.99, 0.5),
                                         (0.05, 0.25)])
def test_ohem_cross_entropy_matches_jax(kind, thresh, frac):
    logits, labels = _seg_case(kind)
    got = seg_loss.ohem_cross_entropy(_t(logits), _t(labels),
                                      thresh=thresh, min_kept_fraction=frac)
    want = jseg.ohem_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   thresh=thresh, min_kept_fraction=frac)
    _close(got, want, atol=1e-6, rtol=1e-6)
    if kind == "all_ignored":
        assert float(got) == 0.0


def test_ohem_selects_what_jax_selects():
    """The kept set itself: with the losses at the cut tied, the same
    pixels (all of the tie) are averaged on both sides; read through
    each side's gradient, which is nonzero exactly on the kept pixels."""
    logits, labels = _seg_case("ties")
    args = dict(thresh=0.05, min_kept_fraction=0.3)
    t = _t(logits).requires_grad_()
    seg_loss.ohem_cross_entropy(t, _t(labels), **args).backward()
    want = jax.grad(lambda x: jseg.ohem_cross_entropy(
        x, jnp.asarray(labels), **args))(jnp.asarray(logits))
    kept = np.abs(np.asarray(want)).sum(-1) > 0
    np.testing.assert_array_equal(t.grad.abs().sum(-1).numpy() > 0, kept)
    assert 0 < kept.sum() < kept.size
    _close(t.grad, want, atol=1e-7)


@pytest.mark.parametrize("kind", ["plain", "ignored", "all_ignored"])
def test_focal_loss_matches_jax(kind):
    logits, labels = _seg_case(kind)
    _close(seg_loss.focal_loss(_t(logits), _t(labels), gamma=2.0),
           jseg.focal_loss(jnp.asarray(logits), jnp.asarray(labels)),
           atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- detection ----

def _boxes(rng, shape):
    xy = rng.uniform(0, 40, shape + (2,))
    wh = rng.uniform(1, 30, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_losses_match_jax():
    rng = np.random.default_rng(12)
    a, b = _boxes(rng, (3, 7)), _boxes(rng, (3, 7))
    b[0, 0] = a[0, 0]                     # identical boxes
    b[0, 1] = a[0, 1] + 100.0             # disjoint boxes
    for fn, jfn in ((det.box_iou, jdet.box_iou), (det.iou_loss, jdet.iou_loss),
                    (det.giou_loss, jdet.giou_loss)):
        _close(fn(_t(a), _t(b)), jfn(jnp.asarray(a), jnp.asarray(b)),
               atol=1e-6, rtol=1e-6)


def test_sigmoid_and_centerness_losses_match_jax():
    rng = np.random.default_rng(13)
    logits = rng.normal(0, 3, (2, 30, 1)).astype(np.float32)
    targets = (rng.uniform(size=logits.shape) < 0.3).astype(np.float32)
    _close(det.sigmoid_focal_loss(_t(logits), _t(targets)),
           jdet.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets)),
           atol=1e-6, rtol=1e-6)
    cnt = rng.uniform(size=logits.shape).astype(np.float32)
    mask = rng.uniform(size=logits.shape) < 0.4
    for m in (mask, np.zeros_like(mask)):
        _close(det.centerness_bce_loss(_t(logits), _t(cnt), _t(m)),
               jdet.centerness_bce_loss(jnp.asarray(logits), jnp.asarray(cnt),
                                        jnp.asarray(m)), atol=1e-6, rtol=1e-6)


def _gt():
    rng = np.random.default_rng(14)
    boxes = _boxes(rng, (2, 5)) * 2
    boxes[0, 1] = boxes[0, 0]          # an exact area tie: argmin's first
    boxes[1, 3] = [0, 0, 80, 80]       # one large box over many cells
    classes = rng.integers(1, 9, (2, 5)).astype(np.int32)
    return boxes, classes


def test_coords_fmap_matches_jax():
    np.testing.assert_array_equal(det.coords_fmap(5, 7, 8).numpy(),
                                  jdet.coords_fmap(5, 7, 8))


def test_gen_level_targets_match_jax():
    boxes, classes = _gt()
    got = det.gen_level_targets((12, 10), _t(boxes), _t(classes), 8,
                                (-1, 64))
    want = jdet.gen_level_targets((12, 10), jnp.asarray(boxes),
                                  jnp.asarray(classes), 8, (-1, 64))
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert (got[0].numpy() > 0).any() and (got[0].numpy() == 0).any()
    _close(got[1], want[1], atol=1e-6)
    _close(got[2], want[2], atol=1e-5)


def test_gen_targets_match_jax():
    boxes, classes = _gt()
    args = ([(12, 10), (6, 5)], [8, 16], [(-1, 32), (32, 999999)])
    got = det.gen_targets(args[0], _t(boxes), _t(classes), *args[1:])
    want = jdet.gen_targets(args[0], jnp.asarray(boxes), jnp.asarray(classes),
                            *args[1:])
    for g, e in zip(got, want):
        assert g.shape == e.shape
        _close(g, e, atol=1e-5)


# ------------------------------------------------------ legacy augment ----

def _image(seed=15, h=12, w=12):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
            rng.integers(0, 9, (h, w)).astype(np.int32))


def _u4(key):
    return np.array([jax.random.uniform(k) for k in jax.random.split(key, 4)],
                    np.float32)


def _jax_draws(op, key, img):
    """The numbers the JAX package's op draws from ``key``, in the port's
    draws layout."""
    if op in ("flip", "flipud"):
        return {"do": _t(np.asarray(jax.random.bernoulli(key, 0.5)))}
    if op in ("crop", "crop_out"):
        return {"u": _t(_u4(key))}
    k1, k2 = jax.random.split(key)
    do = _t(np.asarray(jax.random.bernoulli(k1, 0.9)))
    if op == "brightness":
        return {"do": do, "delta": _t(np.asarray(jax.random.uniform(
            k2, (), minval=-0.15, maxval=0.15)))}
    if op == "noise":
        return {"do": do, "noise": _t(np.asarray(jax.random.uniform(
            k2, img.shape, minval=-5.0, maxval=5.0)))}
    return {"k": int(jax.random.randint(key, (), 1, 4))}


AUG = {"flip": (aug.flip, jaug.random_flip),
       "flipud": (aug.flipud, jaug.random_flipud),
       "crop": (aug.crop, jaug.random_crop),
       "crop_out": (aug.crop_out, jaug.random_crop_out),
       "brightness": (aug.brightness, jaug.random_brightness),
       "noise": (aug.noise, jaug.random_noise),
       "rot": (aug.rot, jaug.random_rot)}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("op", sorted(AUG))
def test_legacy_augment_matches_jax_draws(op, seed):
    port_fn, jax_fn = AUG[op]
    img, lab = _image(seed)
    key = jax.random.PRNGKey(seed)
    want_img, want_lab = jax_fn(key, jnp.asarray(img), jnp.asarray(lab))
    got_img, got_lab = port_fn(_t(img), _t(lab), **_jax_draws(op, key, img))
    np.testing.assert_array_equal(got_lab.numpy(), want_lab)
    _close(got_img, want_img, atol=1e-4 if op == "noise" else 0.0)


def test_legacy_augment_draws():
    gen = torch.Generator().manual_seed(0)
    img, lab = map(_t, _image())
    for _ in range(20):
        assert aug.draw_flip(gen)["do"].dtype == torch.bool
        u = aug.draw_crop(gen)["u"]
        assert u.shape == (4,) and bool(((u >= 0) & (u < 1)).all())
        b = aug.draw_brightness(gen)
        assert abs(float(b["delta"])) <= 0.15
        n = aug.draw_noise(gen, img.shape)["noise"]
        assert n.shape == img.shape and float(n.abs().max()) <= 5.0
        k = aug.draw_rot(gen)["k"]
        assert k in (1, 2, 3)
        assert aug.rot(img, lab, k)[0].shape == img.shape
    out, out_lab = aug.crop(img, lab, **aug.draw_crop(gen))
    assert out.shape == img.shape and out_lab.shape == lab.shape


# ------------------------------------------------------ metrics, profiler ----

def test_colorize_labels_matches_jax():
    lab = np.random.default_rng(16).integers(-2, 12, (7, 9))
    got = colorize_labels(lab)
    assert got.dtype == np.uint8 and got.shape == (7, 9, 3)
    np.testing.assert_array_equal(got, jax_colorize(lab))


def test_benchmark_fn_and_trace_on_cpu(tmp_path):
    """``trace`` writes a Chrome trace that holds the port's spans."""
    with profiler.trace(str(tmp_path / "tr")) as prof:
        with profiler.span("test/trace"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert '"segmif/test/trace"' in text
    assert len(prof.key_averages()) > 0
