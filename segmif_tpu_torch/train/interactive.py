"""The interactive fusion <-> segmentation training driver (counterpart of
``segmif_tpu/train/interactive.py``).

``cfg.rounds`` rounds (7 in the reference), each a fusion phase and then a
segmentation phase, on ONE ``JointPipeline`` whose f32 master weights live
on the device:

 - the fusion phase trains ``model.fusion`` against the dataset's STATIC
   guide images (the reference's Mask2/), through a frozen copy of the
   seg network; its step is built anew each round, after the last seg
   phase, so that the frozen copy holds the current seg weights;
 - between the phases the train and val sets are fused again with the
   new fusion weights and handed over in memory as uint8 (``fused``, the
   reference's Mask/); the guide is never replaced;
 - the seg phase trains ``model.seg`` (drop-path, dropout, BatchNorm
   batch statistics) on the regenerated fused images, and evaluates the
   mIoU (mean IoU) on the val set every ``seg.eval_every`` iterations and
   at its end; the seg checkpoint is written only when the mIoU improves.

The rules of the JAX driver are kept: the fusion lr is divided by the
round index and ``fusion_scale = 0.4 / round``; each phase's
``Prefetcher`` is seeded ``seed + round`` (fusion) and ``seed + 100 +
round`` (seg); the augmentation of iteration n draws from a generator
seeded from (``seed * 7 + round``, n) in the fusion phase and (``seed *
13 + round``, n) in the seg phase, and the seg step's own draws from
(``seed * 13 + round``, step), with a third word that keeps the two
apart; ``progress.json`` records the next (round, phase), and a
mid-phase checkpoint holds the whole train state, so a resumed run
replays the uninterrupted one.

One deliberate departure: under ``fusion.grad_accum`` = A > 1 an
iteration consumes A batches, so a resumed fusion phase restarts its
``Prefetcher`` at batch ``start_iter * A`` (the JAX driver restarts at
``start_iter`` and replays batches).

With ``streaming`` the splits stay on disk (``train.streaming``): the
fusion phase's ``Prefetcher`` reads the folders per batch (through the
native C++ loader unless ``native_loader`` is off, and then in the C++
runtime's shuffle order), and the regenerated fused images go to a uint8
memmap under the checkpoint dir, batch by batch, with the val SSIM
averaged over the batches weighted by their sizes. With
``dump_fused_images`` each regeneration also writes its fused images as
PNGs to ``fused_{train,val}_r<round>/`` in the checkpoint dir.

Data parallelism (``mesh_data`` N > 1, or -1 under N launched ranks;
``parallel.mesh``): every rank reads the same global batch order (the
``Prefetcher``'s (seed, epoch) permutation), draws the global batch's
augmentation and keeps its rows (``parallel.mesh.BatchShard``), and the
steps sum the gradients and losses over the ranks, so N ranks train as
one process on the whole batch. The weights are broadcast from rank 0
once, at the start. The regeneration and the mIoU evaluation run the
whole set on every rank (each rank's fused set and mIoU are then the
same: the same weights through the same deterministic passes), and one
rank writes the files: checkpoints, ``progress.json``, the streaming
memmap, fused PNGs, the eval log. Every rank reads them on resume.
``fusion.grad_accum`` > 1 is refused under data parallelism. With
``streaming`` every rank regenerates the fused images and the writer
alone fills the memmap, under a temporary name that it renames into place;
every rank waits for it (a barrier before and after) and the others open
it afresh.

Several hosts (torchrun nodes; ``parallel.dist.host_layout``): the
config's batch sizes stay the global batches B, each host's
``Prefetcher`` reads B/P rows from its stride of the names
(``data.pipeline``), and the global batch is the hosts' batches
concatenated (``parallel.mesh``), so N ranks on P hosts train as one
process on that batch. The writers: at start-up rank 0 drops a token file
named by a random number into ``checkpoint_dir``, and every rank looks
for it there. If every rank sees it the hosts share the directory and
rank 0 alone writes, as on one host; else each host's first rank writes
its host's whole copy, and that host's ranks read it back on resume.

Tensor parallelism (``mesh_model`` M > 1 on D x M ranks,
``parallel.tensor``): after the broadcast the model is split over each
model group; the steps sum over the data group only, the regeneration and
the evaluation run split on every rank, and the checkpoints hold what one
process holds (every rank gathers, the writer writes; a load cuts the pieces
for any M). Without launched ranks ``mesh_data`` or ``mesh_model`` above 1
raises ("launch N ranks").

Options the port does not run raise ``ValueError`` naming their ROADMAP
item (``remat``, ``fusion.train_chunk`` > 1).
"""
from __future__ import annotations

import datetime
import json
import os
import secrets
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .._device import place, resolve, upload
from ..config import TrainConfig
from ..data import augment
from ..data.pipeline import Prefetcher
from ..eval.evaluator import (fusion_quality_eval, generate_fused,
                              segmentation_eval)
from ..kernels import _build
from ..models.network import JointPipeline, init_params
from ..parallel.mesh import batch_shard, make_mesh, put_replicated
from ..parallel.tensor import gather_state_dict, tensor_parallel
from ..utils.logging import eta, setup_logger
from . import checkpoint as ckpt
from .optimizer import adamw_poly, adamw_poly_grouped
from .state import FusionTrainState, SegTrainState
from .steps import (fold_seed, make_fuse_fn, make_fusion_train_step,
                    make_seg_train_step, make_segment_fn)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float64": torch.float64}
ROLE_FILES = {"fusion": "fusion_params.pth", "seg": "seg_params.pth"}


class InMemoryFusionDataset:
    """5-tuple dataset over in-memory uint8 arrays: the fused-image handoff
    between the phases.

    ``guide`` is the STATIC fusion target and tap source (the reference's
    Mask2/, never replaced); ``fused`` holds the latest regenerated fused
    images (the reference's Mask/), which the seg phase and the mIoU eval
    read through ``seg_view()``."""

    def __init__(self, names, ir, vis, guide, label):
        self.names = names
        self.ir = ir          # [N, H, W, 3] uint8
        self.vis = vis
        self.guide = guide    # static guide images (fusion target)
        self.fused = guide    # regenerated fused images (seg-phase input)
        self.label = label    # [N, H, W] int32

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i):
        # uint8: the cast to float happens on the device
        return (self.names[i], self.ir[i], self.vis[i], self.guide[i],
                self.label[i])

    def seg_view(self) -> "_SegPhaseView":
        return _SegPhaseView(self)


class _SegPhaseView:
    """The same 5-tuple layout with the regenerated FUSED image in slot 3,
    as the reference's train_seg and val_segformer read Mask/."""

    def __init__(self, base: InMemoryFusionDataset):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        b = self.base
        return (b.names[i], b.ir[i], b.vis[i], b.fused[i], b.label[i])


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.uint8(np.clip(x * 255.0, 0, 255))


def _stack_dataset(dataset, num_threads: int = 8) -> InMemoryFusionDataset:
    def load(i):
        n, ir, vis, guide, label = dataset[i]
        return (n, np.uint8(np.clip(ir, 0, 255)),
                np.uint8(np.clip(vis, 0, 255)),
                np.uint8(np.clip(guide, 0, 255)), label.astype(np.int32))

    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        samples = list(ex.map(load, range(len(dataset))))
    names, irs, viss, guides, labels = zip(*samples)
    return InMemoryFusionDataset(list(names), np.stack(irs), np.stack(viss),
                                 np.stack(guides), np.stack(labels))


def refuse_unported(cfg: TrainConfig) -> None:
    """ValueError for each option of the JAX driver the port does not run
    yet, naming its ROADMAP item."""
    refusals = (
        (cfg.fusion.train_chunk > 1, "fusion.train_chunk > 1: the lax.scan "
         "chunking of train steps is on ROADMAP queue 1's 'Do not port' "
         "list; the port runs one step per iteration"),
        (cfg.remat or cfg.remat_seg, "remat: on ROADMAP queue 1's 'Do not "
         "port' list (the DRDB's autograd Function already saves only its "
         "inputs)"),
        (cfg.compute_dtype not in DTYPES, f"compute_dtype "
         f"{cfg.compute_dtype!r}: one of {sorted(DTYPES)}"),
        (cfg.param_dtype != "float32", f"param_dtype {cfg.param_dtype!r}: "
         "the master weights are float32"),
    )
    for refused, why in refusals:
        if refused:
            raise ValueError(why)


def refuse_under_dp(cfg: TrainConfig, ranks: int) -> None:
    """ValueError for the options data parallelism does not take."""
    if ranks > 1 and cfg.fusion.grad_accum > 1:
        # the JAX driver's rule: DP already multiplies the effective batch
        raise ValueError("fusion.grad_accum > 1 requires mesh_data == 1 "
                         "(use data parallelism OR accumulation)")


class InteractiveTrainer:
    """Drives ``cfg.rounds`` rounds of fusion-phase + seg-phase training on
    the card, unless ``device="cpu"`` (``device=None`` means ``cuda`` and
    raises when there is none). Under data or tensor parallelism each rank
    builds one, on its own device, after joining the process group
    (``parallel.dist``)."""

    def __init__(self, cfg: TrainConfig, train_dataset, val_dataset,
                 logger=None, device=None):
        refuse_unported(cfg)
        self.cfg = cfg
        self.dev = resolve(device)
        self.mesh = make_mesh(cfg.mesh_data, cfg.mesh_model, device=self.dev)
        refuse_under_dp(cfg, self.mesh.data)
        if self.mesh.hosts > 1:   # each host must read whole rows
            for b in (cfg.fusion.batch_size, cfg.seg.batch_size):
                batch_shard(self.mesh, b)
        self.log = logger or setup_logger()
        self.writer, self.writer_rule = self._writer_rule()
        self.dtype = DTYPES[cfg.compute_dtype]
        self.acc = _build.acc_dtype(self.dtype)   # master weights, inputs
        self.model = JointPipeline(cfg.backbone, cfg.data.num_classes,
                                   cfg.embedding_dim)
        init_params(self.model, torch.Generator().manual_seed(cfg.seed))
        pretrained = Path(cfg.pretrained_dir) / f"{cfg.backbone}.pth"
        if pretrained.exists():
            self.log.info("loading pretrained encoder %s", pretrained)
            ckpt.load_pretrained_encoder(self.model.seg.denoise_net.encoder,
                                         pretrained)
        place(self.model, self.dev).to(self.acc)
        put_replicated(self.mesh, self.model)
        tensor_parallel(self.model, self.mesh)
        if cfg.streaming:
            from .streaming import StreamingFusionData

            self.train_data = StreamingFusionData(
                train_dataset, cfg.checkpoint_dir, "train")
            self.val_data = StreamingFusionData(
                val_dataset, cfg.checkpoint_dir, "val")
        else:
            self.train_data = _stack_dataset(train_dataset)
            self.val_data = _stack_dataset(val_dataset)
        self.best_miou = -1.0
        self.history = []
        # sampled at the log points, which read the device anyway:
        # (round, iter, loss) / per-round val SSIM against the static guide
        self.fusion_loss_history = []
        self.seg_loss_history = []
        self.ssim_history = []

    def _writer_rule(self):
        """(whether this rank writes the files, the rule in words): rank 0
        on one host or where every host sees the same ``checkpoint_dir``
        (a token file that rank 0 drops there, named by a random number
        that every rank is given); else each host's first rank."""
        mesh = self.mesh
        base = Path(self.cfg.checkpoint_dir)
        base.mkdir(parents=True, exist_ok=True)
        if mesh.hosts == 1:
            return mesh.rank == 0, "one host: rank 0 writes the files"
        comm = mesh.everyone
        word = comm.broadcast_(torch.tensor([secrets.randbits(62)],
                                            device=comm.device))
        token = base / f".shared_{int(word.item()):x}"
        if mesh.rank == 0:
            token.touch()
        comm.barrier()
        seen = comm.all_reduce_sum_(torch.tensor(
            [float(token.exists())], device=comm.device))
        if mesh.rank == 0:
            token.unlink()
        seen = int(seen.item())
        if seen == comm.world:
            return mesh.rank == 0, (f"{mesh.hosts} hosts share "
                                    "checkpoint_dir: rank 0 writes the files")
        return mesh.local_rank == 0, (
            f"{mesh.hosts} hosts, checkpoint_dir not shared ({seen} of "
            f"{comm.world} ranks see rank 0's token): each host's first "
            "rank writes its host's copy")

    # ------------------------------------------------------------ phases ----

    def _shard(self, batch_size: int):
        """This rank's ``BatchShard`` of a batch; None on one rank."""
        return batch_shard(self.mesh, batch_size) if self.mesh.data > 1 \
            else None

    def _augment(self, gen, raw, aug, seed, shard=None):
        """One raw batch (uint8, or float32 integers in [0, 255] from a
        streamed folder) on the device, augmented with draws from ``gen``
        seeded ``seed``. Under ``shard``: the draws of the whole batch,
        and this rank's rows of it."""
        gen.manual_seed(seed)
        total = len(raw["label"]) if shard is None else shard.total
        draws = augment.draw(gen, total, aug, self.acc)
        if shard is not None:
            draws, raw = shard.own(draws), shard.take(raw)
        b = {k: upload(raw[k], self.dev)
             for k in ("ir", "vis", "guide", "label")}
        return augment.apply(draws, b["ir"], b["vis"], b["guide"],
                             b["label"], aug, self.cfg.data.num_classes)

    def _aug_config(self, crop_size: int) -> augment.AugConfig:
        d = self.cfg.data
        return augment.AugConfig(crop_size=crop_size,
                                 scale_min=d.rescale_range[0],
                                 scale_max=d.rescale_range[1],
                                 ignore_index=d.ignore_index)

    def train_fusion_phase(self, round_idx: int):
        cfg = self.cfg
        fp = cfg.fusion
        iters = fp.iters_round1 if round_idx == 1 else fp.iters_later
        tx = adamw_poly(fp.learning_rate / round_idx, fp.warmup_iter,
                        fp.max_iters, fp.weight_decay, fp.betas,
                        fp.warmup_ratio, fp.power)
        accum = max(1, fp.grad_accum)
        # built here, every round: its frozen seg copy is taken now, after
        # the last seg phase
        step_fn = make_fusion_train_step(
            self.model, tx, round1=(round_idx == 1),
            ignore_index=cfg.data.ignore_index, seg_scale=fp.seg_scale,
            dwa_temperature=fp.dwa_temperature,
            dwa_warmup_steps=fp.dwa_warmup_steps, grad_accum=accum,
            compute_dtype=self.dtype, device=self.dev)
        state = FusionTrainState.create(self.model.fusion, tx)
        start_iter = self._restore_phase("fusion", round_idx, state)
        fusion_scale = fp.fusion_scale_base / round_idx
        aug = self._aug_config(fp.crop_size)
        # an iteration takes `accum` batches: resume at start_iter * accum
        pf = Prefetcher(self.train_data, fp.batch_size // self.mesh.hosts,
                        seed=cfg.seed + round_idx,
                        use_native=cfg.native_loader,
                        start_batch=start_iter * accum)
        it = iter(pf)
        base = cfg.seed * 7 + round_idx
        gen = torch.Generator(device=self.dev)
        shard = self._shard(fp.batch_size)
        dp = {} if shard is None else {"shard": shard}
        t0 = datetime.datetime.now()
        metrics = {}
        try:
            for n_iter in range(start_iter, iters):
                micro = [self._augment(gen, next(it), aug,
                                       fold_seed(base, n_iter, 1 + j), shard)
                         for j in range(accum)]
                batch = micro[0] if accum == 1 else {
                    k: torch.stack([m[k] for m in micro]) for k in micro[0]}
                metrics = step_fn(state, batch, fusion_scale, **dp)
                if (n_iter + 1) % cfg.log_iters == 0:
                    el, rem = eta(t0, n_iter + 1, iters)
                    loss = float(metrics["loss"])
                    self.fusion_loss_history.append(
                        (round_idx, n_iter + 1, loss))
                    self.log.info(
                        "[round %d fusion] iter %d/%d loss %.4f elapsed %s "
                        "eta %s", round_idx, n_iter + 1, iters, loss, el,
                        rem)
                if (n_iter + 1) % fp.checkpoint_every == 0:
                    self.save_checkpoint("fusion")
                    self._save_phase("fusion", round_idx, state)
        finally:
            pf.close()
        self.save_checkpoint("fusion")
        self._clear_phase("fusion", round_idx)
        return {k: float(v) for k, v in metrics.items() if v.ndim == 0}

    def regenerate_fused(self, round_idx: int):
        """Fuse the train and val sets with the current fusion weights,
        taps and fusion target from the STATIC guide; only ``fused`` is
        replaced."""
        cfg = self.cfg
        fuse_fn = make_fuse_fn(self.model, self.dtype, self.dev)
        ssim_val = None
        for data, tag in ((self.train_data, "train"),
                          (self.val_data, "val")):
            out = (Path(cfg.checkpoint_dir) / f"fused_{tag}_r{round_idx}"
                   if cfg.dump_fused_images and self.writer else None)
            val = data is self.val_data
            if cfg.streaming:
                ssim = self._regenerate_streaming(fuse_fn, data, out, val)
            else:
                _, fused, _ = generate_fused(
                    fuse_fn, data, batch_size=4, out_dir=out,
                    device=self.dev, dtype=self.acc)
                data.fused = _to_uint8(fused)
                ssim = fusion_quality_eval(
                    fused, data.guide.astype(np.float32) / 255.0,
                    device=self.dev)["ssim"] if val else None
            if val:
                ssim_val = ssim
        self.ssim_history.append((round_idx, ssim_val))
        self.log.info(
            "[round %d] regenerated %d train + %d val fused images "
            "(val SSIM vs static guide: %.4f)", round_idx,
            len(self.train_data), len(self.val_data), ssim_val)

    def _barrier(self):
        comm = self.mesh.everyone
        if comm is not None:
            comm.barrier()

    def _regenerate_streaming(self, fuse_fn, data, out_dir, want_ssim):
        """Each fused batch straight into the split's uint8 memmap (the
        writer fills a new one and renames it into place; the others open
        it once it is whole); the val SSIM against
        the static guide averaged over the batches, weighted by their
        sizes (the images share one size, so this is the SSIM of the whole
        set up to summation order)."""
        _, ir0, *_ = data[0]
        hw = (ir0.shape[0], ir0.shape[1])
        self._barrier()   # no rank still reads the memmap
        fused_mm = data.begin_fused(*hw) if self.writer else None
        stats = {"ssim_sum": 0.0, "n": 0}

        def sink(start, fused_np, guide_np):
            if fused_mm is not None:
                fused_mm[start:start + len(fused_np)] = _to_uint8(fused_np)
            if want_ssim:
                q = fusion_quality_eval(fused_np, guide_np, device=self.dev)
                stats["ssim_sum"] += q["ssim"] * len(fused_np)
                stats["n"] += len(fused_np)

        generate_fused(fuse_fn, data, batch_size=4, out_dir=out_dir,
                       sink=sink, device=self.dev, dtype=self.acc)
        if fused_mm is not None:
            data.commit_fused()
        self._barrier()
        if fused_mm is None:
            data.ensure_fused(*hw, write=False)
        return stats["ssim_sum"] / stats["n"] if stats["n"] else None

    def train_seg_phase(self, round_idx: int):
        cfg = self.cfg
        sp = cfg.seg
        opt = cfg.optimizer
        seg = self.model.seg
        start_step = (round_idx - 1) * sp.iters if sp.resume_schedule else 0
        tx = adamw_poly_grouped(
            [n for n, _ in seg.named_parameters()], opt.learning_rate,
            opt.warmup_iter, opt.max_iters, opt.weight_decay, opt.betas,
            opt.warmup_ratio, opt.power, start_step, opt.decoder_lr_mult)
        step_fn = make_seg_train_step(seg, tx, cfg.data.ignore_index,
                                      self.dtype, self.dev)
        state = SegTrainState.create(seg, tx)
        start_iter = self._restore_phase("seg", round_idx, state)
        aug = self._aug_config(cfg.data.crop_size)
        pf = Prefetcher(self.train_data.seg_view(),
                        sp.batch_size // self.mesh.hosts,
                        seed=cfg.seed + 100 + round_idx,
                        start_batch=start_iter)
        it = iter(pf)
        base = cfg.seed * 13 + round_idx
        gen = torch.Generator(device=self.dev)
        shard = self._shard(sp.batch_size)
        dp = {} if shard is None else {"shard": shard}
        t0 = datetime.datetime.now()
        try:
            for n_iter in range(start_iter, sp.iters):
                batch = self._augment(gen, next(it), aug,
                                      fold_seed(base, n_iter, 1), shard)
                # the "guide" slot of seg_view() is the fused image
                metrics = step_fn(state, {"image": batch["guide"],
                                          "label": batch["label"]}, base,
                                  **dp)
                if (n_iter + 1) % cfg.log_iters == 0:
                    el, rem = eta(t0, n_iter + 1, sp.iters)
                    loss = float(metrics["loss"])
                    self.seg_loss_history.append(
                        (round_idx, n_iter + 1, loss))
                    self.log.info(
                        "[round %d seg] iter %d/%d loss %.4f elapsed %s "
                        "eta %s", round_idx, n_iter + 1, sp.iters, loss, el,
                        rem)
                if (n_iter + 1) % sp.eval_every == 0 or \
                        n_iter + 1 == sp.iters:
                    miou = self.evaluate(round_idx)["mIoU"]
                    if miou > self.best_miou:
                        self.best_miou = miou
                        self.save_checkpoint("seg")
                        self.log.info("[round %d seg] new best mIoU %.4f",
                                      round_idx, miou)
                    self._save_phase("seg", round_idx, state)
        finally:
            pf.close()
        self._clear_phase("seg", round_idx)

    # -------------------------------------------------------------- eval ----

    def evaluate(self, round_idx: int = 0):
        base = Path(self.cfg.checkpoint_dir)
        base.mkdir(parents=True, exist_ok=True)
        segment_fn = make_segment_fn(self.model.seg, self.dtype, self.dev)
        res = segmentation_eval(
            segment_fn, self.val_data.seg_view(), self.cfg.data.num_classes,
            batch_size=4,
            log_file=str(base / "val_seg.txt") if self.writer else None,
            tag=f"round{round_idx}", device=self.dev, dtype=self.acc)
        self.history.append({"round": round_idx, "mIoU": res["mIoU"]})
        self.log.info("[round %d] mIoU %.4f pixel_acc %.4f", round_idx,
                      res["mIoU"], res["pixel_acc"])
        return res

    # -------------------------------------------------------- checkpoints ----

    def _phase_path(self, role: str, round_idx: int) -> Path:
        return Path(self.cfg.checkpoint_dir) / f"{role}_phase_r{round_idx}.pth"

    def _save_phase(self, role: str, round_idx: int, state):
        """Mid-phase checkpoint of the whole train state and the best-mIoU
        gate (every rank gathers a split state; the writer writes)."""
        tree = ckpt.state_tree(state) if self.writer or state.splits \
            else None
        if self.writer:
            ckpt.save_phase(self._phase_path(role, round_idx), state,
                            self.best_miou, tree)

    def _restore_phase(self, role: str, round_idx: int, state) -> int:
        """Restore ``state`` from this (role, round)'s mid-phase checkpoint
        if there is one; returns the iteration to resume from (0 if
        none)."""
        path = self._phase_path(role, round_idx)
        if not path.exists():
            return 0
        self.best_miou = max(self.best_miou, ckpt.load_phase(path, state))
        start_iter = int(state.step.item())
        self.log.info("[round %d %s] resuming mid-phase at iter %d",
                      round_idx, role, start_iter)
        return start_iter

    def _clear_phase(self, role: str, round_idx: int):
        if self.writer:
            self._phase_path(role, round_idx).unlink(missing_ok=True)

    def _progress_path(self) -> Path:
        return Path(self.cfg.checkpoint_dir) / "progress.json"

    def _mark_progress(self, next_round: int, next_phase: str):
        if not self.writer:
            return
        path = self._progress_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        tmp.write_text(json.dumps(
            {"next_round": next_round, "next_phase": next_phase,
             "best_miou": self.best_miou}))
        os.replace(tmp, path)

    def read_progress(self):
        path = self._progress_path()
        if not path.exists():
            return None
        return json.loads(path.read_text())

    def save_checkpoint(self, role: str):
        """The role checkpoint of ``model.fusion`` or ``model.seg`` (every
        rank gathers a split module; the writer writes)."""
        module = getattr(self.model, role)
        sd = gather_state_dict(module)
        if self.writer:
            ckpt.save_role(Path(self.cfg.checkpoint_dir) /
                           ROLE_FILES[role], module, sd)

    def load_checkpoints(self):
        base = Path(self.cfg.checkpoint_dir)
        for role, name in ROLE_FILES.items():
            if (base / name).exists():
                ckpt.load_role(base / name, getattr(self.model, role))

    # --------------------------------------------------------------- run ----

    def run(self, start_round: int = 1, resume: bool = True):
        """The full interactive schedule (the reference's __main__).

        resume=True picks up from the checkpoint dir's progress.json:
        completed phases are skipped, and an interrupted phase continues
        from its mid-phase checkpoint. start_round > 1 overrides progress
        and loads the role checkpoints (the reference's warm start)."""
        start_phase = "fusion"
        prog = self.read_progress() if resume and start_round == 1 else None
        if prog is not None:
            start_round = prog["next_round"]
            start_phase = prog["next_phase"]
            self.best_miou = max(self.best_miou,
                                 float(prog.get("best_miou", -1.0)))
        if prog is not None or start_round > 1:
            self.load_checkpoints()
        if start_round > 1 and prog is None:
            self.regenerate_fused(start_round - 1)
        for round_idx in range(start_round, self.cfg.rounds + 1):
            if not (round_idx == start_round and start_phase == "seg"):
                self.log.info("==== round %d/%d: fusion phase ====",
                              round_idx, self.cfg.rounds)
                self.train_fusion_phase(round_idx)
                self._mark_progress(round_idx, "seg")
            # the in-memory fused arrays are not saved, so a seg-phase
            # resume regenerates them from the saved fusion weights
            self.regenerate_fused(round_idx)
            self.log.info("==== round %d/%d: segmentation phase ====",
                          round_idx, self.cfg.rounds)
            self.train_seg_phase(round_idx)
            self._mark_progress(round_idx + 1, "fusion")
        return {"best_mIoU": self.best_miou, "history": self.history}
