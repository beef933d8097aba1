"""Structured configuration tree (a copy of ``segmif_tpu/config.py``, which
the port may not import).

One dataclass tree holds every hyperparameter the reference hardcodes:
round count, per-round iteration budgets, DWA temperature and scales,
checkpoint paths. YAML files with the reference's section layout
(exp/dataset/train/optimizer/scheduler) load through ``load_yaml``, which
imports PyYAML only when it is called.

Differences from the JAX package's tree: ``compute_dtype`` also takes
"float64" (the parity tests' dtype); ``native_loader`` chooses the
streaming fusion phase's reader (the JAX package falls back from the
native loader silently, the port does not); and the fields of options the
port does not run (``remat``, ``remat_seg``, ``fusion.train_chunk`` > 1,
a mesh of more than one device) stay for the YAML layout's sake;
``InteractiveTrainer`` refuses them.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    root_dir: str = "./data/train_all"
    val_root_dir: str = "./data/test_all"
    name_list_dir: str = "./"
    num_classes: int = 9
    crop_size: int = 480
    resize_range: Tuple[int, int] = (480, 640)
    rescale_range: Tuple[float, float] = (0.5, 2.0)
    ignore_index: int = 255
    ir_dir: str = "Infrared"
    vis_dir: str = "Visible"
    mask_dir: str = "Mask"       # fused-image dir consumed by the seg phase
    guide_dir: str = "Mask2"     # guide-image dir consumed by the fusion phase
    label_dir: str = "Label"
    eval_size: Tuple[int, int] = (480, 640)


@dataclasses.dataclass
class OptimizerConfig:
    learning_rate: float = 8e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    warmup_iter: int = 3000
    warmup_ratio: float = 1e-6
    power: float = 1.0
    max_iters: int = 160000
    decoder_lr_mult: float = 10.0


@dataclasses.dataclass
class FusionPhaseConfig:
    """train_fusion hyperparameters (the reference's train.py:266-413)."""
    learning_rate: float = 1e-4        # divided by round index per reference.
                                       # NOTE: the reference passes lr=3e-4 as
                                       # the OPTIMIZER default but the param
                                       # GROUP sets cfg.optimizer.learning_rate
                                       # (=1e-4 in voc_fusion.yaml), and torch
                                       # per-group lr wins (train.py:316-326)
    iters_round1: int = 6000
    iters_later: int = 4000
    batch_size: int = 2
    crop_size: int = 320
    dwa_temperature: float = 1000.0
    dwa_warmup_steps: int = 10
    fusion_scale_base: float = 0.4     # scaled by 1/round
    seg_scale: float = 0.8
    train_chunk: int = 1               # iters per device dispatch in the JAX
                                       # package (one lax.scan); the port
                                       # runs the per-iteration loop and
                                       # refuses > 1
    ssim_weight: float = 1.1
    grad_accum: int = 1                # micro-batches per optimizer step:
                                       # >1 means each iter runs grad_accum
                                       # fwd/bwd passes of batch_size and
                                       # applies ONE update on the MEAN
                                       # gradient: effective batch
                                       # batch_size*grad_accum past the
                                       # device's activation memory
    checkpoint_every: int = 500
    warmup_iter: int = 0               # reference's warmup is effectively off
    warmup_ratio: float = 1e-4
    max_iters: int = 20000
    # the reference's train_fusion reads these from the FUSION yaml
    # (train.py:322,327-332), not the seg one
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    power: float = 1.0


@dataclasses.dataclass
class SegPhaseConfig:
    """train_seg hyperparameters (the reference's train.py:115-245)."""
    iters: int = 10000
    batch_size: int = 4
    eval_every: int = 1000
    resume_schedule: bool = True       # iter_curr = (round-1)*iters


@dataclasses.dataclass
class TrainConfig:
    backbone: str = "mit_b3"
    embedding_dim: int = 256
    rounds: int = 7
    log_iters: int = 50
    seed: int = 0
    checkpoint_dir: str = "./checkpoint"
    pretrained_dir: str = "./pretrained"
    dump_fused_images: bool = False    # optional PNG dump for inspection
    streaming: bool = False  # disk-backed splits (train/streaming.py)
    native_loader: bool = True  # streaming fusion phase: read through the
                                # native C++ loader (raises if it did not
                                # build); False: Python reader threads
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"    # "bfloat16" | "float32" | "float64"
    remat: bool = False   # the JAX package's rematerialisation switches;
    remat_seg: bool = False  # the port's DRDB Function already saves only
                             # its inputs, and the port refuses both
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    fusion: FusionPhaseConfig = dataclasses.field(default_factory=FusionPhaseConfig)
    seg: SegPhaseConfig = dataclasses.field(default_factory=SegPhaseConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh_data: int = -1                # -1 = every rank over mesh_model
    mesh_model: int = 1                # ranks of a model group (TP)


def _update(dc, d: dict):
    for k, v in d.items():
        if not hasattr(dc, k):
            continue
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            setattr(dc, k, tuple(v))
        else:
            setattr(dc, k, v)


def _warn_unknown(raw: dict, consumed: set, path: str, logger) -> None:
    """Log every YAML leaf whose dotted path was not consumed (the reference
    silently drops unknown OmegaConf fields)."""
    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}." if isinstance(v, dict) else f"{prefix}{k}")
        else:
            if prefix not in consumed:
                logger.warning("config %s: ignored unknown key %r", path, prefix)
    walk(raw, "")


def load_yaml(path: str | Path,
              fusion_path: Optional[str | Path] = None) -> TrainConfig:
    """Load a reference-layout YAML (and optionally the fusion-task YAML)
    into a TrainConfig. Unknown keys are logged, not silently dropped."""
    import logging

    import yaml

    logger = logging.getLogger("segmif_tpu_torch")
    cfg = TrainConfig()
    consumed: set = set()
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if "exp" in raw and "backbone" in raw["exp"]:
        cfg.backbone = raw["exp"]["backbone"]
        consumed.add("exp.backbone")
    if "dataset" in raw:
        for k in raw["dataset"]:
            if hasattr(cfg.data, k):
                consumed.add(f"dataset.{k}")
        _update(cfg.data, raw["dataset"])
    if "optimizer" in raw:
        o = raw["optimizer"]
        if "learning_rate" in o:
            cfg.optimizer.learning_rate = float(o["learning_rate"])
        if "betas" in o:
            cfg.optimizer.betas = tuple(o["betas"])
        if "weight_decay" in o:
            cfg.optimizer.weight_decay = float(o["weight_decay"])
        consumed |= {f"optimizer.{k}" for k in
                     ("learning_rate", "betas", "weight_decay") if k in o}
    if "scheduler" in raw:
        s = raw["scheduler"]
        cfg.optimizer.warmup_iter = int(s.get("warmup_iter", cfg.optimizer.warmup_iter))
        cfg.optimizer.warmup_ratio = float(s.get("warmup_ratio", cfg.optimizer.warmup_ratio))
        cfg.optimizer.power = float(s.get("power", cfg.optimizer.power))
        consumed |= {f"scheduler.{k}" for k in
                     ("warmup_iter", "warmup_ratio", "power") if k in s}
    if "train" in raw:
        t = raw["train"]
        cfg.optimizer.max_iters = int(t.get("max_iters", cfg.optimizer.max_iters))
        cfg.seg.batch_size = int(t.get("samples_per_gpu", cfg.seg.batch_size))
        cfg.log_iters = int(t.get("log_iters", cfg.log_iters))
        consumed |= {f"train.{k}" for k in
                     ("max_iters", "samples_per_gpu", "log_iters") if k in t}
    _warn_unknown(raw, consumed, str(path), logger)
    if fusion_path is not None:
        with open(fusion_path) as f:
            fraw = yaml.safe_load(f) or {}
        fconsumed: set = set()
        fo = fraw.get("optimizer", {})
        if "learning_rate" in fo:
            # the EFFECTIVE reference fusion LR: the torch param group pins
            # cfg.optimizer.learning_rate/iter_, overriding the hardcoded
            # 3e-4 optimizer default (the reference's train.py:316-326)
            cfg.fusion.learning_rate = float(fo["learning_rate"])
            fconsumed.add("optimizer.learning_rate")
        if "weight_decay" in fo:
            cfg.fusion.weight_decay = float(fo["weight_decay"])
            fconsumed.add("optimizer.weight_decay")
        if "betas" in fo:
            cfg.fusion.betas = tuple(fo["betas"])
            fconsumed.add("optimizer.betas")
        if "power" in fraw.get("scheduler", {}):
            cfg.fusion.power = float(fraw["scheduler"]["power"])
            fconsumed.add("scheduler.power")
        if "train" in fraw:
            cfg.fusion.batch_size = int(fraw["train"].get("samples_per_gpu", 4)) // 2
            cfg.fusion.max_iters = int(fraw["train"].get("max_iters", cfg.fusion.max_iters))
            fconsumed |= {f"train.{k}" for k in
                          ("samples_per_gpu", "max_iters") if k in fraw["train"]}
        if "dataset" in fraw:
            cfg.fusion.crop_size = int(fraw["dataset"].get("crop_size", cfg.fusion.crop_size))
            if "crop_size" in fraw["dataset"]:
                fconsumed.add("dataset.crop_size")
        sch = fraw.get("scheduler", {})
        cfg.fusion.warmup_ratio = float(sch.get("warmup_ratio", cfg.fusion.warmup_ratio))
        if "warmup_ratio" in sch:
            fconsumed.add("scheduler.warmup_ratio")
        _warn_unknown(fraw, fconsumed, str(fusion_path), logger)
    return cfg
