"""What the ranks of the parallel tests run (``test_torch_parallel*.py``,
``test_torch_spatial*.py``): each function takes the rank's ``Comm``
first, as ``segmif_tpu_torch.parallel.dist.launch`` calls it, or None for
one process on the whole batch. Torch and the port only: the ranks never
import JAX. Results are numpy.

``run_cases``: steps of the fusion phase and the seg phase, each from a
state dict and a global numpy batch, one case after another; a case may
plant a fault of data parallelism (``FAULTS``) for that case only.
``spatial_cases``: ``spatial_fuse_batched`` and ``make_spatial_fuse_fn``
at a given halo, with the grams summed or not. ``trainer_runs``: one
round of ``InteractiveTrainer.run()``, and the same round stopped after
a mid-phase checkpoint and resumed.
"""
import contextlib

import numpy as np
import torch

from segmif_tpu_torch.losses.seg_loss import cross_entropy
from segmif_tpu_torch.models import segformer_head
from segmif_tpu_torch.models.fusion import FusionNetwork
from segmif_tpu_torch.models.network import (JointPipeline,
                                             SegmentationNetwork)
from segmif_tpu_torch.parallel import spatial
from segmif_tpu_torch.parallel.mesh import Mesh, batch_shard, make_mesh
from segmif_tpu_torch.train import steps
from segmif_tpu_torch.train.compare import RecordGrads, without_regularisers
from segmif_tpu_torch.train.optimizer import adamw_poly, adamw_poly_grouped
from segmif_tpu_torch.train.state import FusionTrainState, SegTrainState

CLASSES = 5
LR = 1e-3


def _ce_per_rank(logits, label, ignore_index, shard):
    """Fault: each rank's CE averaged over its own valid pixels."""
    loss = cross_entropy(logits, label, ignore_index)
    return loss if shard is None else loss * shard.share


_real_batch_stats = segformer_head.batch_stats


def _bn_local(x, shard=None):
    """Fault: BatchNorm on each rank's own statistics."""
    return _real_batch_stats(x)


def _grams_local(comm, grams):
    """Fault: each rank's FFM contexts from its own tokens only."""
    return grams


FAULTS = {"ce_per_rank": (steps, "ce_share", _ce_per_rank),
          "bn_local": (segformer_head, "batch_stats", _bn_local),
          "grams_local": (spatial, "all_reduce_grams", _grams_local)}


@contextlib.contextmanager
def planted(names):
    saved = []
    try:
        for name in names:
            mod, attr, fake = FAULTS[name]
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fake)
        yield
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)


def _numpy(tree):
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def run_case(comm, case):
    """One step. case: {'kind': 'fusion' | 'seg', 'sd': state dict
    (numpy), 'data': the global batch (numpy), 'dtype', 'round1' (fusion),
    'regularisers' (seg), 'faults'}. Returns the global metrics, the
    gradients, the updated weights, the DWA state (fusion) and the
    BatchNorm buffers (seg)."""
    dtype = getattr(torch, case["dtype"])
    seg = case["kind"] == "seg"
    model = SegmentationNetwork("mit_b0", CLASSES) if seg else \
        JointPipeline("mit_b0", num_classes=CLASSES)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["sd"].items()})
    if seg and not case.get("regularisers", True):
        model = without_regularisers(model)
    data = {k: torch.from_numpy(v) for k, v in case["data"].items()}
    b = len(case["data"]["label"])
    shard = None if comm is None else batch_shard(make_mesh(comm=comm), b)
    local = data if shard is None else shard.take(data)
    kw = {} if shard is None else {"shard": shard}
    with planted(case.get("faults", ())):
        if seg:
            names = [k for k, _ in model.named_parameters()]
            tx = RecordGrads(adamw_poly_grouped(names, LR, 0, 1000))
            step = steps.make_seg_train_step(model, tx, compute_dtype=dtype,
                                             device="cpu")
            state = SegTrainState.create(model, tx)
            metrics = step(state, {"image": local["guide"],
                                   "label": local["label"]}, 0, **kw)
        else:
            tx = RecordGrads(adamw_poly(LR, 0, 1000))
            step = steps.make_fusion_train_step(
                model, tx, case["round1"], compute_dtype=dtype,
                device="cpu")
            state = FusionTrainState.create(model.fusion, tx)
            metrics = step(state, local, 0.4, **kw)
    out = {"metrics": _numpy(metrics), "grads": _numpy(tx.grads),
           "params": _numpy(state.params)}
    if seg:
        out["stats"] = _numpy(state.batch_stats)
    else:
        out["dwa"] = {k: getattr(state.dwa, k).numpy()
                      for k in ("prev", "prev2", "step")}
    return out


def run_cases(comm, cases):
    return [run_case(comm, c) for c in cases]


def spatial_case(comm, case):
    """The row-sharded fuse. case: {'sd', 'inputs' (numpy), 'halo',
    'faults', 'pipeline'}. With 'pipeline' (and 'backbone', 'classes'):
    ``make_spatial_fuse_fn``'s (fused_rgb, fused_y) of a JointPipeline
    from the state dict, on inputs 'ir', 'vis', 'guide'; else
    ``spatial_fuse_batched``'s fused Y of a FusionNetwork from the state
    dict, on inputs 'ir', 'vis' (the Y given), 'tap1', 'tap2'."""
    pipeline = case.get("pipeline", False)
    model = JointPipeline(case["backbone"], num_classes=case["classes"]) \
        if pipeline else FusionNetwork()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["sd"].items()})
    model.eval()
    mesh = Mesh(1) if comm is None else make_mesh(comm=comm)
    x = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}
    with planted(case.get("faults", ())):
        if pipeline:
            fuse = spatial.make_spatial_fuse_fn(mesh, model, torch.float32,
                                                "cpu")
            return tuple(t.numpy() for t in fuse(x["ir"], x["vis"],
                                                 x["guide"]))
        with torch.inference_mode():
            y = spatial.spatial_fuse_batched(
                mesh, model, x["ir"], x["vis"], x["tap1"], x["tap2"],
                halo=case.get("halo", spatial.HALO))
        return y.numpy()


def spatial_cases(comm, cases):
    return [spatial_case(comm, c) for c in cases]


def state_dict_numpy(model):
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def assert_close_leaves(got, want, rtol, what=""):
    """Every leaf within ``rtol`` of that leaf's largest magnitude."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, e in want.items():
        tol = rtol * np.abs(e).max() + 1e-300
        np.testing.assert_allclose(got[k], e, rtol=0, atol=tol,
                                   err_msg=f"{what} {k}")




def tiny_trainer_cfg(ckpt, dtype="float64"):
    """``test_torch_interactive.tiny_cfg`` in ``dtype`` (that module
    imports JAX, which the ranks do not), with a mid-phase checkpoint
    after every fusion iteration; ``mesh_data`` -1: every rank."""
    from segmif_tpu_torch.config import (DataConfig, FusionPhaseConfig,
                                         SegPhaseConfig, TrainConfig)

    return TrainConfig(
        backbone="mit_b0", rounds=1, log_iters=1, checkpoint_dir=str(ckpt),
        compute_dtype=dtype, data=DataConfig(num_classes=9, crop_size=32),
        fusion=FusionPhaseConfig(iters_round1=2, iters_later=2, batch_size=2,
                                 crop_size=32, checkpoint_every=1,
                                 dwa_warmup_steps=1),
        seg=SegPhaseConfig(iters=2, batch_size=2, eval_every=100),
        mesh_data=-1)


def _trainer(ckpt):
    from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
    from segmif_tpu_torch.train.interactive import InteractiveTrainer

    return InteractiveTrainer(
        tiny_trainer_cfg(ckpt), SyntheticFusionDataset(n=4, size=(32, 32)),
        SyntheticFusionDataset(n=2, size=(32, 32), seed=1), device="cpu")


def _trainer_out(t, result, writes):
    return {"result": result, "writes": writes,
            "fusion": state_dict_numpy(t.model.fusion),
            "seg": state_dict_numpy(t.model.seg),
            "fusion_loss": t.fusion_loss_history,
            "seg_loss": t.seg_loss_history, "ssim": t.ssim_history}


def trainer_runs(comm, ckpt_a, ckpt_b):
    """One round of ``InteractiveTrainer.run()`` in f64 in ``ckpt_a``; and
    in ``ckpt_b`` the same run stopped on every rank right after the
    fusion phase's first mid-phase checkpoint, then resumed by a new
    trainer. Returns (the run, the resumed run), each with the number of
    files this rank wrote (role and phase checkpoints, progress)."""
    from segmif_tpu_torch.train import checkpoint as ckpt

    writes = {"role": 0, "phase": 0}
    real_role, real_phase = ckpt.save_role, ckpt.save_phase

    def role(*a, **k):
        writes["role"] += 1
        return real_role(*a, **k)

    def phase(*a, **k):
        writes["phase"] += 1
        return real_phase(*a, **k)

    ckpt.save_role, ckpt.save_phase = role, phase
    try:
        a = _trainer(ckpt_a)
        run = _trainer_out(a, a.run(), dict(writes))
        b = _trainer(ckpt_b)
        real_save = b._save_phase

        def crash(role_name, round_idx, state):
            real_save(role_name, round_idx, state)
            if comm is not None:
                comm.barrier()   # rank 0's file is whole on every rank
            raise KeyboardInterrupt("simulated crash")

        b._save_phase = crash
        try:
            b.run()
        except KeyboardInterrupt:
            pass
        c = _trainer(ckpt_b)
        resumed = _trainer_out(c, c.run(), dict(writes))
    finally:
        ckpt.save_role, ckpt.save_phase = real_role, real_phase
    return run, resumed
