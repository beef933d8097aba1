"""One round of the JAX package's ``InteractiveTrainer.run()`` against the
port's, both in f64 (the JAX driver under ``train_parity.jax_in_f64``,
the port's with ``compute_dtype="float64"``): fusion 2 iterations, the
regeneration of the fused images, seg 2 iterations with an eval after
each; mit_b0, 4 training and 2 validation samples at 32x32, crops of 32.

 - The same initial weights: the JAX trainer's, converted with
   ``convert.state_dict_from_jax`` into the port trainer's model.
 - The same augmentation: the port's ``augment.draw`` is patched, for
   this test only, to return the draws of the JAX driver's keys, iteration
   by iteration (``fold_in(PRNGKey(seed * 7 + round), n)`` in the fusion
   phase, ``seed * 13 + round`` in the seg phase; ``aug_draws``).
 - Drop-path and dropout at 0 on both sides (``seg_parity``).
 - The fusion weights redrawn at the reference modules' scale
   (``port_weights``), with nonzero biases. With the JAX package's zero
   biases, the entry convs give exactly 0 on the crops' zero padding, and
   there the two PReLUs take different subgradients: the port's is
   torch's (the reference's nn.PReLU: alpha at 0), the JAX package's
   ``where(x >= 0, ...)`` takes 1 (``test_prelu_subgradient_at_zero``).
 - The JAX trainer's weights and batch statistics rounded to f32 (what
   ``convert`` carries; under x64 some of its initialisers draw f64) and
   held in f64 after its init, so that its optimizer state and updates
   are f64 too (flax keeps f32 parameters under x64, and AdamW's bias
   correction in f32 moves an update by 1e-5 of itself); and its
   ``model.init`` jitted (eager f64 init dispatches thousands of ops one
   by one).

 - Plain SGD on the poly-warmup schedule in place of AdamW, on both
   sides (``_sgd``), and the leaves compared by their change over the
   run. The JAX package's f64 step is not f64 throughout: its loss reads
   about 7e-10 off the same loss evaluated eagerly on its own fused Y,
   which the port's matches to 1e-16, and its gradients differ from the
   port's by about 1e-6 of a leaf's largest magnitude. AdamW divides each
   gradient element by its magnitude plus 1e-8, so an element whose
   gradient lies within a few 1e-8 of zero moves by a different part of
   its whole step on each side. SGD's change is linear in the gradient.
   AdamW itself is held to optax in test_torch_losses.py, and each step's
   use of it in test_torch_train_step*.py and test_torch_seg_step.py.

The uint8 fused arrays differ by a level where a value lies within
rounding of a level boundary, and a seg gradient near Adam's eps (1e-8;
the seg lr is in its warm-up, so its first updates are of that order)
moves with them. So after the port's regeneration, whose output is held
on its own, the port's seg phase is handed the JAX regeneration's arrays
(a test-side wrap of the port trainer's ``regenerate_fused``), and the
two seg phases start from the same images.

Held: the change of every fusion and seg leaf over the run within 1e-5
of the largest change of that leaf (the seg leaves whose exact gradient
is zero, ``seg_parity.exact_zero_grad``, within 1e-6 of the largest seg
change), the BatchNorm buffers within 1e-5 of their largest magnitude,
the history's mIoUs equal, the val SSIMs within 1e-6, and the uint8
fused arrays equal but for +-1 levels on at most 0.1% of the pixels (the
regenerated image is truncated to uint8, so a value within rounding of a
level boundary lands on either side).
"""
import jax
import numpy as np
import torch

import jax.numpy as jnp
import optax
import torch.nn.functional as F

import seg_parity
import segmif_tpu.train.interactive as jax_interactive
from aug_draws import jax_draws
from port_weights import torch_default_init
from segmif_tpu import config as jax_config
from segmif_tpu.models.fusion import _prelu as jax_prelu
from segmif_tpu.train.optimizer import poly_warmup_schedule as jax_schedule
from segmif_tpu_torch.train import interactive
from segmif_tpu_torch.train.optimizer import AdamWState, poly_warmup_schedule
from segmif_tpu.data.datasets import SyntheticFusionDataset
from segmif_tpu.train.interactive import InteractiveTrainer as JaxTrainer
from segmif_tpu_torch import config
from segmif_tpu_torch.convert import state_dict_from_jax
from segmif_tpu_torch.data import augment
from segmif_tpu_torch.train.interactive import InteractiveTrainer
from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from train_parity import jax_in_f64

SEED, ITERS = 0, 2


def _cfg(mod, ckpt, dtype, streaming=False, rounds=1):
    return mod.TrainConfig(
        backbone="mit_b0", rounds=rounds, log_iters=1, seed=SEED,
        checkpoint_dir=str(ckpt), compute_dtype=dtype, streaming=streaming,
        data=mod.DataConfig(num_classes=9, crop_size=32),
        fusion=mod.FusionPhaseConfig(iters_round1=ITERS, iters_later=ITERS,
                                     batch_size=2,
                                     crop_size=32, checkpoint_every=100,
                                     dwa_warmup_steps=1),
        seg=mod.SegPhaseConfig(iters=ITERS, batch_size=2, eval_every=1),
        mesh_data=1)


def _data():
    return (SyntheticFusionDataset(n=4, size=(32, 32)),
            SyntheticFusionDataset(n=2, size=(32, 32), seed=1))


class _PortSGD:
    """p -= lr(count) g, with AdamW's state layout (no moments)."""

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, params):
        dev = next(iter(params.values())).device
        return AdamWState({}, {}, torch.zeros((), dtype=torch.int32,
                                              device=dev))

    @torch.no_grad()
    def update(self, grads, state, params):
        lr = self.schedule(state.count)
        for n, p in params.items():
            p.sub_(lr * grads[n])
        return state._replace(count=state.count + 1)


def _sgd(monkeypatch):
    """Both drivers' optimizers -> SGD on the same schedule (the seg
    phase's at the base lr for every group)."""
    def sched_args(base_lr, warmup, max_iter, wd=0.01, betas=None,
                   ratio=1e-6, power=1.0, start=0, *_):
        return base_lr, warmup, max_iter, ratio, power, start

    monkeypatch.setattr(jax_interactive, "adamw_poly", lambda *a: optax.sgd(
        jax_schedule(*sched_args(*a))))
    monkeypatch.setattr(jax_interactive, "adamw_poly_grouped",
                        lambda params, *a: optax.sgd(
                            jax_schedule(*sched_args(*a))))
    monkeypatch.setattr(interactive, "adamw_poly", lambda *a: _PortSGD(
        poly_warmup_schedule(*sched_args(*a))))
    monkeypatch.setattr(interactive, "adamw_poly_grouped",
                        lambda names, *a: _PortSGD(
                            poly_warmup_schedule(*sched_args(*a))))


def _jit_init(monkeypatch):
    real = jax_interactive.JointPipeline

    def pipeline(*args, **kwargs):
        model = real(*args, **kwargs)
        object.__setattr__(model, "init", jax.jit(model.init))
        return model

    monkeypatch.setattr(jax_interactive, "JointPipeline", pipeline)


def test_prelu_subgradient_at_zero():
    """Where the two PReLUs part: the gradient at exactly 0."""
    x = torch.zeros(4, requires_grad=True)
    alpha = torch.tensor([0.25])
    F.prelu(x, alpha).sum().backward()
    want = jax.grad(lambda v: jax_prelu(v, jnp.asarray([0.25])).sum())(
        jnp.zeros(4))
    np.testing.assert_array_equal(x.grad.numpy(), 0.25)
    np.testing.assert_array_equal(np.asarray(want), 1.0)


def test_one_round_matches_jax_f64(tmp_path, monkeypatch):
    run_round(tmp_path, monkeypatch, _data(), _data())


def run_round(tmp_path, monkeypatch, jax_data, port_data, streaming=False,
              rounds=1):
    """``rounds`` f64 rounds of each trainer (see the module docstring),
    the JAX trainer on ``jax_data``, the port's on ``port_data`` ((train,
    val) pairs of the same samples); with ``streaming``, both keep the
    splits on disk (``train/streaming.py``). Returns the two trainers
    (JAX, port) after their runs."""
    seg_parity.no_regularisers(monkeypatch)
    _jit_init(monkeypatch)
    _sgd(monkeypatch)
    keys = [jax.random.fold_in(jax.random.PRNGKey(base), n)
            for r in range(1, rounds + 1)
            for base in (SEED * 7 + r, SEED * 13 + r) for n in range(ITERS)]
    calls = []

    def jax_draw(gen, batch, cfg, dtype=torch.float32):
        calls.append(dtype)
        with jax_in_f64():
            return jax_draws(keys[len(calls) - 1], batch, cfg)

    with jax_in_f64():
        ref = JaxTrainer(_cfg(jax_config, tmp_path / "jax", "float32",
                              streaming, rounds), *jax_data)
        ref.params = dict(ref.params, fusion=torch_default_init(
            jax.tree.map(np.asarray, ref.params["fusion"]),
            np.random.default_rng(SEED)))
        ref.params, ref.batch_stats = (jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64), t)
            for t in (ref.params, ref.batch_stats))
        params0 = jax.tree.map(np.asarray, ref.params)
        init = state_dict_from_jax(params0, jax.tree.map(np.asarray,
                                                         ref.batch_stats))
        jax_fused = {}     # round -> split -> the JAX regeneration's arrays
        jax_regen = ref.regenerate_fused

        def record(round_idx):
            jax_regen(round_idx)
            jax_fused[round_idx] = {split: np.array(getattr(ref, split).fused)
                                    for split in ("train_data", "val_data")}

        ref.regenerate_fused = record
        ref.run()
    # the changes over the run, taken in f64 before they cross convert
    params = jax.tree.map(lambda a, b: np.asarray(a) - b, ref.params,
                          params0)
    stats = jax.tree.map(np.asarray, ref.batch_stats)

    monkeypatch.setattr(augment, "draw", jax_draw)
    mine = InteractiveTrainer(_cfg(config, tmp_path / "port", "float64",
                                   streaming, rounds), *port_data,
                              device="cpu")
    mine.model.load_state_dict(init)   # the JAX trainer's initial weights
    regenerated = {}
    real_regen = mine.regenerate_fused

    def regen(round_idx):
        real_regen(round_idx)
        for split in ("train_data", "val_data"):
            data, want = getattr(mine, split), jax_fused[round_idx][split]
            regenerated[split] = np.array(data.fused)
            if streaming:   # the memmap the seg phase reads
                data.fused[:] = want
            else:
                data.fused = want.copy()

    mine.regenerate_fused = regen
    mine.run()
    assert calls == [torch.float64] * (2 * ITERS * rounds)

    want = state_dict_from_jax(params, stats)
    got = mine.model.state_dict()
    assert set(want) == set(got)
    change = {k: (got[k].numpy() - init[k].numpy(), w.numpy())
              for k, w in want.items() if "num_batches" not in k}
    top = max(np.abs(w).max() for k, (_, w) in change.items()
              if k.startswith("seg."))
    for k, (g, w) in change.items():
        assert got[k].dtype == torch.float64, k
        if k.rsplit(".", 1)[-1] in seg_parity.STAT_KEYS:
            g, w = got[k].numpy(), want[k].numpy()
        elif seg_parity.exact_zero_grad(k):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top, k
            continue
        # a leaf that takes no gradient (stage 1's queries at 32x32, whose
        # one key row makes the softmax 1) stays where it was on both
        tol = 1e-5 * np.abs(w).max() + 1e-12 * top
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=k)
    assert [h["mIoU"] for h in mine.history] == \
        [h["mIoU"] for h in ref.history]
    assert len(mine.history) == ITERS * rounds
    np.testing.assert_allclose([s for _, s in mine.ssim_history],
                               [s for _, s in ref.ssim_history], rtol=1e-6)
    for split in ("train_data", "val_data"):
        assert regenerated[split].dtype == np.uint8
        a = regenerated[split].astype(np.int16)
        b = getattr(ref, split).fused.astype(np.int16)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1, split
        assert (a != b).mean() <= 1e-3, split
        if not streaming:
            np.testing.assert_array_equal(getattr(mine, split).guide,
                                          getattr(ref, split).guide)
    return ref, mine
