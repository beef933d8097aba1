"""The port's stochastic regularisers and train-mode BatchNorm against the
JAX package's, apart from the step (which ``test_torch_seg_step*.py``
compares with them at 0):

 - ``drop_path`` and ``dropout`` with the JAX function's masks handed to
   them equal the JAX functions' outputs;
 - the masks come from the caller's generator: the same seed draws the
   same masks, another seed others, and the kept share over 10^4 draws is
   within 3 sigma of 1 - rate;
 - the drop-path schedule of every block equals the rates the JAX MiT
   gives its blocks;
 - train-mode BatchNorm equals flax's BatchNorm(momentum 0.9): output and
   running statistics (the biased variance), the statistics in f32 for
   bf16 activations;
 - without ``train=True`` the network is deterministic whatever its
   rates, and serving gives the same outputs with the module in train or
   eval mode.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmif_tpu.models.mit import Block as JaxBlock
from segmif_tpu.models.mit import MIT_VARIANTS as JAX_VARIANTS
from segmif_tpu.models.mit import MixVisionTransformer as JaxMiT
from segmif_tpu.models.mit import drop_path as jax_drop_path
from segmif_tpu_torch.models import mit as port_mit
from segmif_tpu_torch.models.network import (JointPipeline,
                                             SegmentationNetwork, init_params)
from segmif_tpu_torch.models.segformer_head import (BN_MOMENTUM,
                                                    batch_norm_train,
                                                    dropout, dropout_mask)
from segmif_tpu_torch.serving import make_serving_fn
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

RATE = 0.3


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_drop_path_with_jax_mask_equals_jax():
    x = _x((6, 16, 8))
    key = jax.random.PRNGKey(3)
    want = jax_drop_path(jnp.asarray(x), RATE, False, key)
    mask = jax.random.bernoulli(key, 1.0 - RATE, (6, 1, 1)).astype(
        jnp.float32)
    assert 0 < float(mask.sum()) < 6
    got = port_mit.drop_path(torch.from_numpy(x), RATE,
                             torch.from_numpy(np.array(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_dropout_with_jax_mask_equals_jax():
    x = _x((2, 8, 8, 16))
    key = jax.random.PRNGKey(4)
    layer = fnn.Dropout(RATE)

    def run(v):
        return layer.apply({}, v, deterministic=False, rngs={"dropout": key})

    want = run(jnp.asarray(x))
    mask = np.asarray(run(jnp.ones_like(x))) != 0
    assert 0.5 < mask.mean() < 0.9
    got = dropout(torch.from_numpy(x), RATE, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["drop_path", "dropout"])
def test_masks_come_from_the_generator(kind):
    draw = (port_mit.drop_path_mask if kind == "drop_path"
            else dropout_mask)
    x = torch.zeros((10000, 1, 1))

    def masks(seed):
        g = torch.Generator().manual_seed(seed)
        return draw(x, RATE, g).bool(), draw(x, RATE, g).bool()

    a1, a2 = masks(5)
    b1, b2 = masks(5)
    c1, _ = masks(6)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, a2) and not torch.equal(a1, c1)
    keep, n = 1.0 - RATE, x.numel()
    sigma = np.sqrt(keep * (1 - keep) / n)
    for m in (a1, a2, c1):
        assert abs(m.float().mean().item() - keep) <= 3 * sigma


@pytest.mark.parametrize("backbone", ["mit_b0", "mit_b3"])
def test_drop_path_schedule_equals_jax(backbone):
    rates = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, JaxBlock) and \
                context.method_name == "__call__":
            rates.append(context.module.drop_path_rate)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        jax.eval_shape(JaxMiT(JAX_VARIANTS[backbone]).init,
                       jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    cfg = port_mit.MIT_VARIANTS[backbone]
    assert len(rates) == sum(cfg.depths)
    np.testing.assert_allclose(port_mit.drop_path_rates(cfg), rates,
                               rtol=1e-12)
    if backbone == "mit_b0":
        enc = port_mit.MixVisionTransformer(cfg)
        got = [b.drop_path_rate for i in range(4)
               for b in getattr(enc, f"block{i + 1}")]
        np.testing.assert_allclose(got, rates, rtol=1e-12)
        assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_batch_norm_equals_flax(dtype):
    x = (_x((2, 6, 5, 16), 7) * 2.0 + 0.5)
    scale = np.random.default_rng(8).uniform(0.5, 1.5, 16).astype(np.float32)
    bias = np.random.default_rng(9).uniform(-0.2, 0.2, 16).astype(np.float32)
    bn_j = fnn.BatchNorm(use_running_average=False, momentum=BN_MOMENTUM,
                         epsilon=1e-5)
    variables = bn_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.full((16,), 0.1),
                                 "var": jnp.full((16,), 2.0)}}
    xt = torch.from_numpy(x).to(dtype)
    # the JAX side on the same (bf16-rounded) values, in f32
    want, upd = bn_j.apply(variables, jnp.asarray(xt.float().numpy()),
                           mutable=["batch_stats"])
    bn = torch.nn.BatchNorm2d(16, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.fill_(0.1)
        bn.running_var.fill_(2.0)
    got = batch_norm_train(xt.permute(0, 3, 1, 2), bn).permute(0, 2, 3, 1)
    assert got.dtype == dtype and bn.running_var.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want),
                               rtol=tol, atol=tol)
    stats = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)


def test_eval_mode_is_deterministic_and_train_mode_draws(monkeypatch):
    cfg = port_mit.MIT_VARIANTS["mit_b0"]
    monkeypatch.setitem(port_mit.MIT_VARIANTS, "mit_b0",
                        dataclasses.replace(cfg, drop_path_rate=0.5))
    noisy = init_params(SegmentationNetwork("mit_b0", 5),
                        torch.Generator().manual_seed(0))
    monkeypatch.setitem(port_mit.MIT_VARIANTS, "mit_b0",
                        dataclasses.replace(cfg, drop_path_rate=0.0))
    clean = SegmentationNetwork("mit_b0", 5)
    clean.denoise_net.decoder.dropout_rate = 0.0
    clean.load_state_dict(noisy.state_dict())
    img = torch.rand((2, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(1))
    with torch.no_grad():
        assert torch.equal(noisy(img), clean(img))
        with pytest.raises(ValueError, match="generator"):
            noisy(img, train=True)
        draws = [noisy(img, train=True,
                       gen=torch.Generator().manual_seed(s))
                 for s in (2, 2, 3)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


def test_serving_same_in_train_and_eval_mode():
    model = init_params(JointPipeline("mit_b0", 5),
                        torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    ir, vis = torch.rand((1, 32, 32, 1), generator=g), \
        torch.rand((1, 32, 32, 3), generator=g)
    outs = []
    for mode in (True, False):
        model.train(mode)
        serve = make_serving_fn(model, device="cpu")
        model.train(mode)    # make_serving_fn puts it in eval mode
        outs.append(serve(ir, vis))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
