"""Mid-phase resume of the port's interactive driver on the CPU (mit_b0,
synthetic 32x32 data): a phase interrupted right after a mid-phase
checkpoint and resumed by a new trainer over the same checkpoint dir ends
where the uninterrupted phase ends, bit for bit: the parameters, the
BatchNorm buffers, the best-mIoU gate and the data order.

Under ``fusion.grad_accum = 2`` an iteration takes two batches, so the
resumed phase restarts its Prefetcher at batch ``2 * start_iter``: a
deliberate departure from the JAX driver (segmif_tpu/train/
interactive.py passes ``start_batch=start_iter``, which replays batches).
"""
import pytest
import torch

from segmif_tpu_torch.train import interactive
from test_torch_interactive import tiny_cfg, data
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


def _trainer(ckpt, accum=1):
    cfg = tiny_cfg(ckpt)
    cfg.fusion.iters_round1 = 5
    cfg.fusion.checkpoint_every = 2
    cfg.fusion.grad_accum = accum
    cfg.seg.iters = 5
    cfg.seg.eval_every = 2
    return interactive.InteractiveTrainer(cfg, *data(), device="cpu")


def _crash_after_first_save(t):
    real = t._save_phase

    def crash(role, round_idx, state):
        real(role, round_idx, state)
        raise RuntimeError("simulated crash")

    t._save_phase = crash


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_fusion_phase_resume_matches_uninterrupted(tmp_path, monkeypatch,
                                                   accum):
    starts = []
    real_pf = interactive.Prefetcher

    def recording(*args, **kwargs):
        starts.append(kwargs.get("start_batch", 0))
        return real_pf(*args, **kwargs)

    monkeypatch.setattr(interactive, "Prefetcher", recording)
    a = _trainer(tmp_path / "a", accum)
    a.train_fusion_phase(1)
    want = _state(a.model.fusion)

    b = _trainer(tmp_path / "b", accum)
    _crash_after_first_save(b)
    with pytest.raises(RuntimeError, match="simulated crash"):
        b.train_fusion_phase(1)
    assert (tmp_path / "b" / "fusion_phase_r1.pth").exists()
    c = _trainer(tmp_path / "b", accum)
    c.train_fusion_phase(1)
    got = _state(c.model.fusion)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not (tmp_path / "b" / "fusion_phase_r1.pth").exists()
    # the resumed Prefetcher started at iteration 2's first batch
    assert starts == [0, 0, 2 * accum]


def test_seg_phase_resume_matches_uninterrupted(tmp_path):
    a = _trainer(tmp_path / "a")
    a.train_seg_phase(1)
    want = _state(a.model.seg)

    b = _trainer(tmp_path / "b")
    _crash_after_first_save(b)
    with pytest.raises(RuntimeError, match="simulated crash"):
        b.train_seg_phase(1)
    c = _trainer(tmp_path / "b")
    c.train_seg_phase(1)
    got = _state(c.model.seg)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert c.best_miou == a.best_miou and c.best_miou >= 0.0
    assert [h["mIoU"] for h in c.history] == [h["mIoU"]
                                             for h in a.history[1:]]
    assert not (tmp_path / "b" / "seg_phase_r1.pth").exists()
