"""The port's training maths against the JAX package on the CPU, f32:
``ops.filters.sobel_magnitude``, ``ops.ssim`` (both reductions, and its
gradient), the two fusion losses, ``cross_entropy`` (partly and wholly
ignored labels), ``dwa_combine`` across its warm-up switch, the
poly-warmup schedule, AdamW against optax, and the seg parameter groups.

Same numpy-seeded inputs on both sides. Tolerances: 1e-5 for the ops and
losses (f32 sums of at most 121 window terms or a few thousand pixels in
another order), 1e-6 for DWA (a few f32 operations), 1e-7 relative for
the schedule (the same f32 operations in the same order), 1e-6 for three
AdamW updates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu.losses import dwa as jdwa
from segmif_tpu.losses import fusion_losses as jfl
from segmif_tpu.losses.seg_loss import cross_entropy as jax_ce
from segmif_tpu.models.network import SegmentationNetwork as JaxSeg
from segmif_tpu.ops.filters import sobel_magnitude as jax_sobel
from segmif_tpu.ops.ssim import ssim as jax_ssim
from segmif_tpu.train import optimizer as jopt
from segmif_tpu_torch.losses import dwa as tdwa
from segmif_tpu_torch.losses import fusion_losses as tfl
from segmif_tpu_torch.losses.seg_loss import cross_entropy
from segmif_tpu_torch.models.network import SegmentationNetwork
from segmif_tpu_torch.ops.filters import sobel_magnitude
from segmif_tpu_torch.ops.ssim import ssim
from segmif_tpu_torch.train import optimizer as topt


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _images(seed, shape=(2, 32, 32, 1)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    # b correlated with a, so SSIM is well inside (0, 1)
    b = np.clip(a + 0.2 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("channels", [1, 3])
def test_sobel_magnitude_matches_jax(channels):
    a, _ = _images(0, (2, 17, 23, channels))
    np.testing.assert_allclose(sobel_magnitude(_t(a)).numpy(),
                               np.asarray(jax_sobel(jnp.asarray(a))),
                               atol=1e-5)


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    a, b = _images(1)
    got = ssim(_t(a), _t(b), size_average=size_average).numpy()
    want = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b),
                               size_average=size_average))
    assert got.shape == want.shape == (() if size_average else (2,))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert 0.2 < float(got.min()) < 0.99


def test_ssim_gradient_matches_jax():
    a, b = _images(2)
    ta = _t(a).requires_grad_(True)
    (g,) = torch.autograd.grad(ssim(ta, _t(b)), ta)
    want = np.asarray(jax.grad(lambda x: jax_ssim(x, jnp.asarray(b)))(
        jnp.asarray(a)))
    np.testing.assert_allclose(g.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", ["fusion_loss_l1_grad",
                                  "fusion_loss_mse_ssim"])
def test_fusion_losses_match_jax(name):
    rng = np.random.default_rng(3)
    ir = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    vis = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    mask, fused = _images(4, (2, 32, 32, 3))
    fused = fused[..., :1]
    got = getattr(tfl, name)(_t(ir), _t(vis), _t(fused), _t(mask)).item()
    want = float(getattr(jfl, name)(jnp.asarray(ir), jnp.asarray(vis),
                                    jnp.asarray(fused), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # identity: the L1 terms vanish and SSIM is 1
    y = _t(mask[..., :1])
    assert getattr(tfl, name)(_t(ir), _t(vis), y, _t(mask)).item() < 1e-6


@pytest.mark.parametrize("ignored", ["some", "all"])
def test_cross_entropy_matches_jax(ignored):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (2, 8, 8)).astype(np.int32)
    if ignored == "some":
        labels[rng.uniform(size=labels.shape) < 0.3] = 255
    else:
        labels[:] = 255
    got = cross_entropy(_t(logits), _t(labels)).item()
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    if ignored == "all":
        assert got == 0.0      # F.cross_entropy would give NaN here
    else:
        ref = torch.nn.functional.cross_entropy(
            _t(logits).permute(0, 3, 1, 2), _t(labels).long(),
            ignore_index=255).item()
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_dwa_combine_matches_jax_across_warmup():
    """12 consecutive steps (static weights up to step 10, DWA from 11)."""
    rng = np.random.default_rng(6)
    losses = rng.uniform(0.5, 3.0, (12, 2)).astype(np.float32)
    js, ts = jdwa.dwa_init(), tdwa.dwa_init()
    switched = False
    for l1, l2 in losses:
        jt, js, jw = jdwa.dwa_combine(js, jnp.float32(l1), jnp.float32(l2),
                                      0.4, 0.8)
        tt, ts, tw = tdwa.dwa_combine(ts, torch.tensor(l1), torch.tensor(l2),
                                      0.4, 0.8)
        np.testing.assert_allclose(tt.item(), float(jt), atol=1e-6)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
        for name in ("prev", "prev2"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=1e-6)
        assert int(ts.step) == int(js.step)
        switched |= bool((tw != 1.0).any())
    assert switched and int(ts.step) == 12


# power 1 (the configs' value) is the same f32 operations in the same
# order: within 1e-7 relative. Another power goes through pow, whose f32
# results differ between XLA and torch by up to a few units in the last
# place (2.8e-7 measured at t = 1005, where the base is 1e-3).
@pytest.mark.parametrize("start_step,power,rtol", [(0, 1.0, 1e-7),
                                                   (7, 1.0, 1e-7),
                                                   (7, 0.9, 1e-6)])
def test_poly_warmup_schedule_matches_jax(start_step, power, rtol):
    args = (3e-4, 100, 1000, 1e-6, power, start_step)
    jsched = jopt.poly_warmup_schedule(*args)
    tsched = topt.poly_warmup_schedule(*args)
    for t in (0, 50, 100, 500, 1005):
        got = tsched(torch.tensor(t, dtype=torch.int32)).item()
        want = float(jsched(jnp.int32(t)))
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=str(t))
    # frozen past max_iter, at the last poly value
    assert tsched(torch.tensor(1005)).item() == \
        tsched(torch.tensor(999 - start_step)).item()


def test_adamw_poly_matches_optax():
    """Three updates on the same gradients from a resumed schedule
    (start_step inside the warm-up), weight decay on every parameter."""
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    args = dict(base_lr=1e-2, warmup_iter=5, max_iter=50,
                weight_decay=0.05, start_step=3)
    jtx = jopt.adamw_poly(**args)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jtx.init(jp)
    ttx = topt.adamw_poly(**args)
    tp = {k: _t(v).clone() for k, v in params.items()}
    tst = ttx.init(tp)
    for g in grads:
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        jp = optax.apply_updates(jp, upd)
        tst = ttx.update({k: _t(v) for k, v in g.items()}, tst, tp)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)
    assert int(tst.count) == 3


def test_seg_param_groups_match_jax():
    """The port's labels by state-dict name give the groups of
    ``seg_param_labels`` on the JAX tree: per group, the same number of
    tensors and of elements (mit_b0, shapes only on the JAX side)."""
    shapes = jax.eval_shape(JaxSeg("mit_b0", num_classes=5).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    jl = jopt.seg_param_labels(shapes)
    want = {}
    for lab, s in zip(jax.tree.leaves(jl), jax.tree.leaves(shapes)):
        n, e = want.get(lab, (0, 0))
        want[lab] = (n + 1, e + int(np.prod(s.shape)))
    named = dict(SegmentationNetwork("mit_b0", 5).named_parameters())
    tl = topt.seg_param_labels(named)
    got = {}
    for name, lab in tl.items():
        n, e = got.get(lab, (0, 0))
        got[lab] = (n + 1, e + named[name].numel())
    assert got == want
    assert set(got) == {"encoder", "encoder_norm", "decoder"}
    tx = topt.adamw_poly_grouped(named, 1e-3, 10, 100)
    assert tx.weight_decays["encoder_norm"] == 0.0
    assert tx.group("denoise_net.decoder.linear_pred.weight") == "decoder"
