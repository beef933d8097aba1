"""What the ranks of the parallel tests run (``test_torch_parallel*.py``,
``test_torch_spatial*.py``): each function takes the rank's ``Comm``
first, as ``segmif_tpu_torch.parallel.dist.launch`` calls it, or None for
one process on the whole batch. Torch and the port only: the ranks never
import JAX. Results are numpy.

``run_cases``: steps of the fusion phase and the seg phase, each from a
state dict and a global numpy batch, one case after another, on a data x
model mesh (``model`` > 1: the model split by ``parallel.tensor``; the
gradients and weights gathered whole); a case may plant a fault of data
or tensor parallelism (``FAULTS``) for that case only. ``tp_forward_cases``
/ ``tp_serving_cases``: the split forward and ``make_serving_fn(mesh=)``.
``spatial_cases``: ``spatial_fuse_batched`` and ``make_spatial_fuse_fn``
at a given halo, with the grams summed or not. ``trainer_runs``: one
round of ``InteractiveTrainer.run()``, and the same round stopped after
a mid-phase checkpoint and resumed (on several hosts with a shared
checkpoint dir or one a host). ``host_run``: on ranks that emulate hosts
(``dist.launch(ranks_per_host=)``), ``run_case``'s steps on each host's
``Prefetcher`` batch of a case's global batch, and the multi-host
refusals.
"""
import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from segmif_tpu_torch.data import pipeline
from segmif_tpu_torch.losses.seg_loss import cross_entropy
from segmif_tpu_torch.models import segformer_head
from segmif_tpu_torch.models.fusion import FusionNetwork
from segmif_tpu_torch.models.network import (JointPipeline,
                                             SegmentationNetwork)
from segmif_tpu_torch.parallel import dist, dryrun, spatial, tensor
from segmif_tpu_torch.parallel import mesh as mesh_mod
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


class _GatherReduceScatter(torch.autograd.Function):
    """Fault: an all-gather whose backward reduce-scatters (sums the
    gradient over the group before slicing it)."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.args = (comm, dim)
        return tensor.join(comm.all_gather(x, dim), comm.world, dim)

    @staticmethod
    def backward(ctx, g):
        comm, dim = ctx.args
        return comm.reduce_scatter(g.contiguous(), dim), None, None


def _full_weight_reduce_scatter(lin):
    """Fault: the FFM's gathered weights summed over the group in the
    backward."""
    split = tensor._split(lin)
    if split is None:
        return lin.weight
    comm, dim, _ = split
    return _GatherReduceScatter.apply(lin.weight, comm, dim)


def _row_linear_bias_every_rank(x, lin, comm):
    """Fault: a row-parallel linear's bias added on every rank before the
    sum."""
    return tensor.reduce(F.linear(x, lin.weight, lin.bias), comm)


_real_sum = steps._sum_over_ranks


def _sum_over_world(shard, grads, losses):
    """Fault: the gradients and losses summed over every rank (the
    default group), not over the data group."""
    every = dist.Comm(shard.comm.device)
    return _real_sum(dataclasses.replace(shard, comm=every), grads, losses)


def _name_rule(key):
    """Fault: the split rule keyed by the port's own names, not the JAX
    path (the decode head's ``linear_c{i}.proj`` reads as ``proj``, the
    FFM's ``kv3`` as no split name)."""
    *mods, leaf = key.split(".")
    return mods + ["kernel" if leaf == "weight" else leaf]


def _same_stride():
    """Fault: every host reads host 0's stride of the names."""
    return 0, dist.host_layout()[1]


FAULTS = {"ce_per_rank": (steps, "ce_share", _ce_per_rank),
          "bn_local": (segformer_head, "batch_stats", _bn_local),
          "grams_local": (spatial, "all_reduce_grams", _grams_local),
          "gather_reduce_scatter": (tensor, "full_weight",
                                    _full_weight_reduce_scatter),
          "bias_every_rank": (tensor, "row_linear",
                              _row_linear_bias_every_rank),
          "kv_contiguous": (tensor, "kv_parts", lambda name: 1),
          "world_sum": (steps, "_sum_over_ranks", _sum_over_world),
          "name_rule": (mesh_mod, "jax_path", _name_rule),
          "same_stride": (pipeline, "host_layout", _same_stride)}


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
    'regularisers' (seg), 'model' (ranks a model group, 1 by default),
    'faults', 'total' (the global batch's rows when 'data' is this rank's
    host's batch)}. Returns the global metrics, the gradients, the updated
    weights (both whole), the DWA state (fusion) and the BatchNorm buffers
    (seg)."""
    dtype = getattr(torch, case["dtype"])
    seg = case["kind"] == "seg"
    model = SegmentationNetwork("mit_b0", CLASSES) if seg else \
        JointPipeline("mit_b0", num_classes=CLASSES)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["sd"].items()})
    if seg and not case.get("regularisers", True):
        model = without_regularisers(model)
    data = {k: torch.from_numpy(v) for k, v in case["data"].items()}
    b = case.get("total", len(case["data"]["label"]))
    mesh = None if comm is None else make_mesh(model=case.get("model", 1),
                                               comm=comm)
    shard = None if mesh is None or mesh.data == 1 else \
        batch_shard(mesh, b)
    local = data if shard is None else shard.take(data)
    kw = {} if shard is None else {"shard": shard}
    with planted(case.get("faults", ())):
        if mesh is not None:
            tensor.tensor_parallel(model, mesh)
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
    out = {"metrics": _numpy(metrics),
           "grads": _numpy(tensor.gather_tree(tx.grads, state.splits)),
           "params": _numpy(tensor.gather_tree(state.params,
                                               state.splits))}
    if seg:
        out["stats"] = _numpy(state.batch_stats)
    else:
        out["dwa"] = {k: getattr(state.dwa, k).numpy()
                      for k in ("prev", "prev2", "step")}
    return out


def run_cases(comm, cases):
    return [run_case(comm, c) for c in cases]


def _joint(case):
    model = JointPipeline(case.get("backbone", "mit_b0"),
                          num_classes=case["classes"],
                          interaction=case.get("interaction", "both"))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["sd"].items()})
    return model.to(getattr(torch, case["dtype"])).eval()


def _tp_mesh(comm, case):
    return None if comm is None else make_mesh(model=case["model"],
                                               comm=comm)


def tp_forward_case(comm, case):
    """The forward of a JointPipeline from case['sd'] in case['dtype'],
    split over ``case['model']`` ranks (whole with ``comm`` None), on
    inputs 'ir', 'vis': (fused Y, logits), numpy."""
    model = _joint(case)
    x = {k: torch.from_numpy(v).to(getattr(torch, case["dtype"]))
         for k, v in case["inputs"].items()}
    with planted(case.get("faults", ())):
        mesh = _tp_mesh(comm, case)
        if mesh is not None:
            tensor.tensor_parallel(model, mesh)
        with torch.inference_mode():
            _, y, logits = model(x["ir"], x["vis"])
    return y.numpy(), logits.numpy()


def tp_forward_cases(comm, cases):
    return [tp_forward_case(comm, c) for c in cases]


def tp_serving_case(comm, case):
    """``make_serving_fn`` of a JointPipeline from case['sd'] in
    case['dtype'] on inputs 'ir', 'vis' (and 'guide' for the static
    guide, 'cal_ir' / 'cal_vis' for int8), with ``mesh`` over
    ``case['model']`` ranks (none with ``comm`` None): (fused RGB, pred),
    numpy."""
    from segmif_tpu_torch.serving import make_serving_fn

    dt = getattr(torch, case["dtype"])
    model = _joint(case)
    x = {k: torch.from_numpy(v).to(dt) for k, v in case["inputs"].items()}
    kw = {}
    if "guide" in x:
        kw["guide_rgb"] = x["guide"]
    if "cal_ir" in x:
        kw["int8_calibration"] = (x["cal_ir"], x["cal_vis"])
    serve = make_serving_fn(model, device="cpu", mesh=_tp_mesh(comm, case),
                            **kw)
    rgb, pred = serve(x["ir"], x["vis"])
    return rgb.numpy(), pred.numpy()


def tp_serving_cases(comm, cases):
    return [tp_serving_case(comm, c) for c in cases]


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




def tiny_trainer_cfg(ckpt, dtype="float64", model=1, batch=2):
    """``test_torch_interactive.tiny_cfg`` in ``dtype`` (that module
    imports JAX, which the ranks do not), with a mid-phase checkpoint
    after every fusion iteration, both phases at global batch ``batch``;
    ``mesh_data`` -1: every rank over ``model`` (``mesh_model``)."""
    from segmif_tpu_torch.config import (DataConfig, FusionPhaseConfig,
                                         SegPhaseConfig, TrainConfig)

    return TrainConfig(
        backbone="mit_b0", rounds=1, log_iters=1, checkpoint_dir=str(ckpt),
        compute_dtype=dtype, data=DataConfig(num_classes=9, crop_size=32),
        fusion=FusionPhaseConfig(iters_round1=2, iters_later=2,
                                 batch_size=batch, crop_size=32,
                                 checkpoint_every=1, dwa_warmup_steps=1),
        seg=SegPhaseConfig(iters=2, batch_size=batch, eval_every=100),
        mesh_data=-1, mesh_model=model)


def _trainer(ckpt, model=1, batch=2):
    from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
    from segmif_tpu_torch.train.interactive import InteractiveTrainer

    return InteractiveTrainer(
        tiny_trainer_cfg(ckpt, model=model, batch=batch),
        SyntheticFusionDataset(n=4, size=(32, 32)),
        SyntheticFusionDataset(n=2, size=(32, 32), seed=1), device="cpu")


def _trainer_out(t, result, writes):
    from segmif_tpu_torch.parallel.tensor import gather_state_dict

    return {"result": result, "writes": writes,
            "fusion": {k: v.detach().numpy().copy() for k, v in
                       gather_state_dict(t.model.fusion).items()},
            "seg": {k: v.detach().numpy().copy() for k, v in
                    gather_state_dict(t.model.seg).items()},
            "fusion_loss": t.fusion_loss_history,
            "seg_loss": t.seg_loss_history, "ssim": t.ssim_history}


def trainer_runs(comm, ckpt_a, ckpt_b, model=1, batch=2, per_host=False):
    """One round of ``InteractiveTrainer.run()`` in f64 in ``ckpt_a``; and
    in ``ckpt_b`` the same run stopped on every rank right after the
    fusion phase's first mid-phase checkpoint, then resumed by a new
    trainer; ``model`` ranks a model group, global batches of ``batch``;
    ``per_host``: each host its own ``host<h>`` dir under both; ``ckpt_a``
    None: the resumed run only. Returns (the run or None, the resumed
    run), each with the number of files this rank wrote (role and phase
    checkpoints, progress) and the weights gathered whole, the resumed
    run with its trainer's writer rule."""
    from pathlib import Path

    from segmif_tpu_torch.train import checkpoint as ckpt

    if per_host:
        h = dist.host_layout()[0]
        ckpt_a, ckpt_b = (d and str(Path(d) / f"host{h}")
                          for d in (ckpt_a, ckpt_b))
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
        run = None
        if ckpt_a is not None:
            a = _trainer(ckpt_a, model, batch)
            run = _trainer_out(a, a.run(), dict(writes))
        b = _trainer(ckpt_b, model, batch)
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
        c = _trainer(ckpt_b, model, batch)
        resumed = _trainer_out(c, c.run(), dict(writes))
        resumed["writer"] = (c.writer, c.writer_rule)
    finally:
        ckpt.save_role, ckpt.save_phase = real_role, real_phase
    return run, resumed


def tp_primitives(comm, seed):
    """The four primitives and a Megatron MLP on this rank, in f64, from
    draws that every rank makes alike (``seed``): the outputs and the
    gradients that autograd gives through them. An output that differs
    between the ranks (copy's, scatter's) takes rank r's cotangent
    ``cots[r]``, and the unsplit function is the sum of the ranks'
    losses; an output every rank holds alike (reduce's, gather's, the
    MLP's) takes ``cots[0]`` on every rank, one loss. Returns numpy by
    name."""
    n, r = comm.world, comm.rank
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    x, cots = draw(3, 4 * n), [draw(3, 4 * n) for _ in range(n)]
    xs = [draw(3, 4 * n) for _ in range(n)]
    w1, b1, w2, b2 = draw(8 * n, 4 * n), draw(8 * n), draw(5, 8 * n), \
        draw(5)
    out = {}

    def grad_of(fn, leaf, cot):
        leaf = leaf.clone().requires_grad_()
        y = fn(leaf)
        y.backward(cot[:, :y.shape[-1]])
        return y.detach().numpy(), [leaf.grad.numpy()]

    out["copy"] = grad_of(lambda t: tensor.copy(t, comm), x, cots[r])
    out["reduce"] = grad_of(lambda t: tensor.reduce(t, comm), xs[r],
                            cots[0])
    for parts in (1, 2):
        piece = tensor.local(x, r, n, 1, parts)
        out[f"gather{parts}"] = grad_of(
            lambda t: tensor.gather(t, comm, 1, parts), piece, cots[0])
        # the kernels read gathered activations with a unit last stride
        out[f"gather{parts} contiguous"] = tensor.gather(
            draw(2, 3, 4 * parts)[..., :4 * parts], comm, 2, parts
        ).is_contiguous()
        out[f"scatter{parts}"] = grad_of(
            lambda t: tensor.scatter(t, comm, 1, parts), x, cots[r])
    fc1, fc2 = torch.nn.Linear(4 * n, 8 * n), torch.nn.Linear(8 * n, 5)
    with torch.no_grad():
        fc1.weight.data = tensor.local(w1, r, n, 0).clone()
        fc1.bias.data, fc2.bias.data = b1.clone(), b2.clone()
        fc2.weight.data = tensor.local(w2, r, n, 1).clone()
    fc1.double()
    fc2.double()
    fc1.tp_split = (comm, 0, 1)
    fc2.tp_split = (comm, 1, 1)
    xg = x.clone().requires_grad_()
    y = tensor.row_linear(torch.tanh(tensor.col_linear(xg, fc1, comm)), fc2,
                          comm)
    y.backward(cots[0][:, :5])   # the same cotangent on every rank
    out["mlp"] = (y.detach().numpy(), [xg.grad.numpy()] + [
        t.grad.numpy() for t in (fc1.weight, fc1.bias, fc2.weight,
                                 fc2.bias)])
    return out


TP_KINDS = {"forward": tp_forward_case, "serving": tp_serving_case,
            "primitives": tp_primitives}


def tp_run(comm, todo):
    """Each (kind, case) of ``todo`` in turn (``TP_KINDS``); their
    results in order."""
    return [TP_KINDS[kind](comm, case) for kind, case in todo]


def streaming_run(comm, train_root, val_root, ckpt):
    """One f64 round of ``InteractiveTrainer.run()`` with ``streaming``
    (Python readers) on the folders ``train_root`` / ``val_root``, every
    rank a data index: the trainer's output and the fused memmaps' bytes
    as this rank reads them."""
    from segmif_tpu_torch.data.datasets import FusionFolderDataset
    from segmif_tpu_torch.train.interactive import InteractiveTrainer

    cfg = tiny_trainer_cfg(ckpt)
    cfg.streaming, cfg.native_loader = True, False
    t = InteractiveTrainer(cfg, FusionFolderDataset(train_root),
                           FusionFolderDataset(val_root), device="cpu")
    out = _trainer_out(t, t.run(), {})
    out["fused"] = [np.asarray(d.fused).copy()
                    for d in (t.train_data, t.val_data)]
    return out


class ArrayDataset:
    """A batch of numpy rows as a dataset of (name, ir, vis, guide,
    label), row i named by its index."""

    def __init__(self, data):
        self.data = data

    def __len__(self):
        return len(self.data["label"])

    def __getitem__(self, i):
        d = self.data
        return (f"{i:04d}", d["ir"][i], d["vis"][i], d["guide"][i],
                d["label"][i])


def host_batch(data, seed):
    """This host's first batch of a global batch ``data`` read through the
    ``Prefetcher`` (its stride of the rows, B/P of them, in the (seed,
    epoch 0) order), and the host's row indices."""
    hosts = pipeline.host_layout()[1]
    pf = pipeline.Prefetcher(ArrayDataset(data), len(data["label"]) // hosts,
                             seed=seed, use_native=False)
    try:
        return next(iter(pf)), pf.indices.tolist()
    finally:
        pf.close()


def host_run(comm, cases, seed, dirs):
    """On ranks that emulate hosts: the layout, each case of ``cases``
    (``run_case``'s, a case's 'data' the global batch) on this host's
    ``Prefetcher`` batch of it (a case's faults planted on the read too),
    the host's rows, the messages of the refusals (a model group across
    hosts; batches of 6 and 5, whose host share of 3 or 2.5 rows the
    host's data ranks do not divide), ``writer_runs`` in ``dirs[:3]``,
    ``cli.train`` with a checkpoint dir a host under ``dirs[3]`` and the
    dry run's line."""
    out = {"layout": dist.host_layout(), "cases": [], "rows": []}
    for case in cases:
        with planted(case.get("faults", ())):
            data, rows = host_batch(case["data"], seed)
        out["rows"].append(rows)
        out["cases"].append(run_case(comm, dict(
            case, data=data, total=len(case["data"]["label"]))))
    mesh = make_mesh(comm=comm)
    out["mesh"] = (mesh.host, mesh.hosts, mesh.local_rank)
    out["refusals"] = []
    for refused in (lambda: make_mesh(model=comm.world, comm=comm),
                    lambda: batch_shard(mesh, 6),
                    lambda: batch_shard(mesh, 5)):
        try:
            refused()
            out["refusals"].append(None)
        except ValueError as e:
            out["refusals"].append(str(e))
    out["writers"] = writer_runs(comm, *dirs[:3])
    out["cli"] = cli_run(comm, dirs[3])
    out["dryrun"] = dryrun.dryrun(comm)
    return out


def cli_run(comm, root):
    """``cli.train`` (one f32 round of mit_b0 at 32x32, the default
    batches of 2 and 4) on this rank, with ``--mesh_model 2``: a model
    group a host, one data index each; each host in ``root/host<h>``.
    Returns the CLI's result."""
    from pathlib import Path

    from segmif_tpu_torch.cli import train as cli_train

    ckpt = Path(root) / f"host{dist.host_layout()[0]}"
    return cli_train._rank(comm, [
        "--synthetic", "8", "--synthetic_size", "32", "32", "--crop_size",
        "32", "--backbone", "mit_b0", "--rounds", "1", "--fusion_iters", "1",
        "--seg_iters", "1", "--checkpoint_dir", str(ckpt), "--device", "cpu",
        "--mesh_data", "-1", "--mesh_model", "2"])


def writer_runs(comm, shared_a, shared_b, own):
    """``trainer_runs`` at global batches of 4, with every host in one
    checkpoint dir (``shared_*``), and its stopped and resumed run alone
    with a dir a host (``own/host<h>``): ((run, resumed) shared, (None,
    resumed) one dir a host)."""
    return (trainer_runs(comm, shared_a, shared_b, batch=4),
            trainer_runs(comm, None, own, batch=4, per_host=True))
