"""The port's interactive driver on its own, on the CPU (the assertions of
tests/test_interactive.py, ported): mit_b0, synthetic 32x32 data.

 - two rounds: the static guide unchanged, the fused images regenerated,
   the seg phase reading them, the mIoUs in [0, 1];
 - in round 2 the fusion step reads the seg weights that round 1's seg
   phase left (a step cached across rounds, planted, fails this);
 - ``progress.json`` resume skips the completed phases;
 - the role checkpoints load into the JAX package's converters
   (``load_torch_{seg,fusion}_network``) and give the port's outputs, and
   back into a fresh port model;
 - a pretrained MiT checkpoint loads into the encoder, ``head.*`` dropped;
 - ``cli.train.main`` runs with ``--synthetic`` and ``--device cpu``;
 - each option that is not ported raises, naming its ROADMAP item
   (``streaming`` and ``dump_fused_images`` run: test_torch_streaming.py).
The mid-phase resumes are in test_torch_interactive_resume.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmif_tpu.models.fusion import FusionNetwork as JaxFusionNetwork
from segmif_tpu.models.network import (
    SegmentationNetwork as JaxSegmentationNetwork,
)
from segmif_tpu.train.checkpoint import (load_torch_fusion_network,
                                         load_torch_seg_network)
from segmif_tpu_torch.cli import train as cli_train
from segmif_tpu_torch.config import (DataConfig, FusionPhaseConfig,
                                     SegPhaseConfig, TrainConfig)
from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
from segmif_tpu_torch.train import interactive
from segmif_tpu_torch.train.interactive import InteractiveTrainer
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


def tiny_cfg(ckpt, rounds=1, **kw):
    return TrainConfig(
        backbone="mit_b0", rounds=rounds, log_iters=1,
        checkpoint_dir=str(ckpt), compute_dtype="float32",
        data=DataConfig(num_classes=9, crop_size=32),
        fusion=FusionPhaseConfig(iters_round1=2, iters_later=2, batch_size=2,
                                 crop_size=32, checkpoint_every=100,
                                 dwa_warmup_steps=1),
        seg=SegPhaseConfig(iters=2, batch_size=2, eval_every=100),
        mesh_data=1, **kw)


def data():
    return (SyntheticFusionDataset(n=4, size=(32, 32)),
            SyntheticFusionDataset(n=2, size=(32, 32), seed=1))


def trainer(ckpt, **kw):
    return InteractiveTrainer(tiny_cfg(ckpt, **kw), *data(), device="cpu")


def _watch_fusion_steps(monkeypatch, t, cache=False):
    """Wrap the driver's make_fusion_train_step: at every step call, record
    whether the step's frozen seg copy holds the trainer's current seg
    weights. With ``cache``, hand out the first step built (the fault of
    a step kept across rounds)."""
    real = interactive.make_fusion_train_step
    seen, built = [], []

    def make(*args, **kwargs):
        if not (cache and built):
            built.append(real(*args, **kwargs))
        step = built[-1]

        def watched(state, batch, scale):
            live = t.model.seg.state_dict()
            frozen = step.seg.state_dict()
            seen.append(all(torch.equal(frozen[k],
                                        live[k].to(frozen[k].dtype))
                            for k in live))
            return step(state, batch, scale)

        return watched

    monkeypatch.setattr(interactive, "make_fusion_train_step", make)
    return seen


def test_two_rounds(tmp_path, monkeypatch):
    t = trainer(tmp_path, rounds=2)
    seen = _watch_fusion_steps(monkeypatch, t)
    guide = t.train_data.guide.copy()
    result = t.run()
    assert seen == [True] * 4
    assert len(t.history) == 2
    assert all(0.0 <= h["mIoU"] <= 1.0 for h in t.history)
    assert result["best_mIoU"] == max(h["mIoU"] for h in t.history)
    # the static guide (the fusion target) survives both rounds
    np.testing.assert_array_equal(t.train_data.guide, guide)
    assert t.train_data.fused.dtype == np.uint8
    assert not np.array_equal(t.train_data.fused, guide)
    np.testing.assert_array_equal(t.train_data.seg_view()[0][3],
                                  t.train_data.fused[0])
    assert len(t.ssim_history) == 2 and len(t.fusion_loss_history) == 4
    assert t.read_progress()["next_round"] == 3
    assert (tmp_path / "val_seg.txt").read_text().count("== round") == 2


def test_a_fusion_step_kept_across_rounds_is_caught(tmp_path, monkeypatch):
    t = trainer(tmp_path, rounds=2)
    seen = _watch_fusion_steps(monkeypatch, t, cache=True)
    t.run()
    assert seen[:2] == [True, True] and seen[2:] == [False, False]


def test_run_resumes_from_progress(tmp_path):
    t = trainer(tmp_path)
    calls = []
    t.train_fusion_phase = lambda r: calls.append(("fusion", r))
    t.train_seg_phase = lambda r: calls.append(("seg", r))
    t.regenerate_fused = lambda r: calls.append(("regen", r))
    t._mark_progress(1, "seg")
    t.save_checkpoint("fusion")
    t.save_checkpoint("seg")
    t.run()
    assert calls == [("regen", 1), ("seg", 1)]
    prog = t.read_progress()
    assert prog["next_round"] == 2 and prog["next_phase"] == "fusion"


def test_role_checkpoints_load_into_the_jax_converters(tmp_path):
    t = trainer(tmp_path)
    bn = t.model.seg.denoise_net.decoder.linear_fuse.bn
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():   # statistics that are not the initial ones
        bn.running_mean.copy_(0.1 * torch.randn(bn.running_mean.shape,
                                                generator=g))
        bn.running_var.copy_(torch.rand(bn.running_var.shape, generator=g)
                             + 0.5)
    t.save_checkpoint("seg")
    t.save_checkpoint("fusion")
    img = torch.rand((2, 32, 32, 3), generator=g)
    ir, y = torch.rand((2, 32, 32, 1), generator=g), \
        torch.rand((2, 32, 32, 1), generator=g)
    with torch.no_grad():
        logits = t.model.seg(img)
        tap1, tap2 = t.model.seg.encode_taps_raw(img)
        fused = t.model.fusion(ir, y, tap1, tap2)
    params, stats = load_torch_seg_network(tmp_path / "seg_params.pth")
    want = JaxSegmentationNetwork("mit_b0", 9).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(img.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4)
    fparams = load_torch_fusion_network(tmp_path / "fusion_params.pth")
    want = JaxFusionNetwork().apply(
        {"params": fparams}, *(jnp.asarray(a.numpy())
                               for a in (ir, y, tap1, tap2)))
    # 3e-5 of the largest magnitude: the trainer's own init (the JAX
    # package's initialisers) puts the fused Y at several units
    np.testing.assert_allclose(fused.numpy(), np.asarray(want),
                               atol=3e-5 * np.abs(np.asarray(want)).max())
    # and back into a fresh port trainer
    fresh = trainer(tmp_path)
    fresh.load_checkpoints()
    for role in ("seg", "fusion"):
        a = getattr(fresh.model, role).state_dict()
        b = getattr(t.model, role).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in b), role


def test_pretrained_encoder_is_loaded(tmp_path):
    src = trainer(tmp_path / "a")
    enc = src.model.seg.denoise_net.encoder
    sd = {k: v + 0.5 for k, v in enc.state_dict().items()}
    sd["head.weight"] = torch.zeros(3)
    (tmp_path / "pre").mkdir()
    torch.save(sd, tmp_path / "pre" / "mit_b0.pth")
    t = trainer(tmp_path / "b", pretrained_dir=str(tmp_path / "pre"))
    got = t.model.seg.denoise_net.encoder.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in got)
    del sd["block1.0.attn.q.weight"]
    torch.save(sd, tmp_path / "pre" / "mit_b0.pth")
    with pytest.raises(KeyError, match="block1.0.attn.q.weight"):
        trainer(tmp_path / "c", pretrained_dir=str(tmp_path / "pre"))


def test_cli_train_runs_on_the_cpu(tmp_path):
    args = ["--synthetic", "4", "--synthetic_size", "32", "32",
            "--crop_size", "32", "--backbone", "mit_b0", "--rounds", "1",
            "--fusion_iters", "1", "--seg_iters", "1",
            "--checkpoint_dir", str(tmp_path)]
    result = cli_train.main(args + ["--device", "cpu"])
    assert 0.0 <= result["best_mIoU"] <= 1.0
    assert len(result["history"]) == 1
    assert "training complete" in (tmp_path / "train.log").read_text()
    assert (tmp_path / "seg_params.pth").exists()
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_train.main(args)
    # without --synthetic it reads the folders of --data_root / --val_root
    with pytest.raises(FileNotFoundError, match="no_such_dir"):
        cli_train.main(["--checkpoint_dir", str(tmp_path), "--device",
                        "cpu", "--data_root", str(tmp_path / "no_such_dir")])


@pytest.mark.parametrize("change,match", [
    ({"mesh_data": 2}, "launch 2 ranks"),
    ({"mesh_model": 2}, "launch 2 ranks"),
    ({"remat": True}, "Do not port"),
    ({"remat_seg": True}, "Do not port"),
    ({"fusion.train_chunk": 2}, "Do not port"),
    ({"compute_dtype": "float16"}, "compute_dtype"),
])
def test_unported_options_raise(tmp_path, change, match):
    cfg = tiny_cfg(tmp_path)
    for key, value in change.items():
        if key.startswith("fusion."):
            cfg.fusion = dataclasses.replace(cfg.fusion,
                                             **{key[7:]: value})
        else:
            setattr(cfg, key, value)
    with pytest.raises(ValueError, match=match):
        InteractiveTrainer(cfg, *data(), device="cpu")
