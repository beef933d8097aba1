"""The port's accuracy artifact (counterpart of the JAX package's
``accuracy.py``): "does it still learn, and how far do bf16 and int8
drift from f32".

    python -m segmif_tpu_torch.accuracy [--out ACCURACY_torch.json]
        [--seeds 1 2 3 4] [--skip_overfit] [--skip_drift] [--drift_int8]
        [--device cuda|cpu]

Sections (each skippable):

 - overfit: the pinned synthetic-overfit config of
   ``tests/test_learning.py`` (mit_b0, 4 synthetic samples at 64x64, f32,
   2 rounds of 600 / 60 fusion iterations at lr 4e-4 and 200 seg
   iterations each, evaluated on the training samples) through the port's
   ``InteractiveTrainer``, once per seed (``TrainConfig.seed``: the
   weights, the batch order and the augmentation). Per seed the fields of
   the JAX harness: the round-1 fusion loss's head (the mean of its first
   two logged values), min and tail (the mean of its last two) and
   head / min, the best mIoU beside the class-prior mIoU, each round's
   mIoU, and the round-2 regenerated images' SSIM against the guide;
   then min / median / max of each field over the seeds.
 - drift: bf16 (and with ``--drift_int8`` calibrated int8) serving against
   f32 on the same weights, mit_b1 at 480x640, batch 2: fused-Y SSIM,
   largest fused-Y difference and seg argmax agreement (the JAX harness's
   fields), the logits' largest difference in f32 standard deviations,
   and ``drift.within_limits``'s verdict. The weights are drawn at the
   reference modules' scale (``drift.init_reference_scale``, seed 0), in
   place of the JAX harness's reference-architecture weights, which need
   the reference repository. Random weights, not a trained model.

The run is on the card unless ``--device cpu`` is given; without a card
and without it, it raises. On the card it runs in PyTorch's deterministic
mode (``utils.determinism``), so the same seed gives the same fields
from one run to the next (the CPU's are repeatable as they are). The LAST stdout line is the JSON artifact; it
names the device (and on the card the ``nvidia-smi`` name and power
limit) and the seconds of each section.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import drift
from ._device import resolve
from .config import (DataConfig, FusionPhaseConfig, SegPhaseConfig,
                     TrainConfig)
from .data.datasets import SyntheticFusionDataset
from .models.network import JointPipeline
from .serving import quantize_for_serving
from .train.interactive import InteractiveTrainer
from .utils import determinism

OVERFIT_SIZE = 64
DRIFT_BACKBONE = "mit_b1"
DRIFT_SHAPE = (2, 480, 640)       # batch, height, width
# field -> decimals, as the JAX harness rounds them
OVERFIT_FIELDS = {"fusion_r1_head": 4, "fusion_r1_min": 4,
                  "fusion_r1_tail": 4, "fusion_r1_min_ratio": 2,
                  "best_mIoU": 4, "class_prior_mIoU": 4, "mIoU_round1": 4,
                  "mIoU_round2": 4, "ssim_vs_guide_round2": 4}


def overfit_config(seed: int, checkpoint_dir: str) -> TrainConfig:
    """``tests/test_learning.py``'s pinned config at ``seed``."""
    return TrainConfig(
        backbone="mit_b0", rounds=2, log_iters=10, seed=seed,
        checkpoint_dir=checkpoint_dir, compute_dtype="float32",
        data=DataConfig(num_classes=9, crop_size=OVERFIT_SIZE,
                        rescale_range=(1.0, 1.0)),
        fusion=FusionPhaseConfig(iters_round1=600, iters_later=60,
                                 batch_size=4, crop_size=OVERFIT_SIZE,
                                 checkpoint_every=10_000,
                                 learning_rate=4e-4, dwa_warmup_steps=5),
        seg=SegPhaseConfig(iters=200, batch_size=4, eval_every=200),
        mesh_data=1)


def overfit_data():
    """(train, val): the same 4 synthetic samples twice (an overfit is
    evaluated on its training samples)."""
    size = (OVERFIT_SIZE, OVERFIT_SIZE)
    return (SyntheticFusionDataset(n=4, size=size),
            SyntheticFusionDataset(n=4, size=size))


def class_prior_miou(labels: np.ndarray, num_classes: int = 9) -> float:
    """The mIoU of always predicting the most frequent class: its IoU is
    its frequency, the others' 0."""
    counts = np.bincount(labels.ravel(), minlength=num_classes)
    return float(counts.max() / labels.size / num_classes)


def overfit_fields(trainer, train_ds) -> Dict[str, float]:
    """The overfit fields of a trainer that has run (unrounded)."""
    r1 = [loss for rnd, _, loss in trainer.fusion_loss_history if rnd == 1]
    labels = np.stack([train_ds[i][4] for i in range(len(train_ds))])
    per_round = {h["round"]: h["mIoU"] for h in trainer.history}
    ssim = dict(trainer.ssim_history)
    head, low = float(np.mean(r1[:2])), float(np.min(r1))
    return {"fusion_r1_head": head, "fusion_r1_min": low,
            "fusion_r1_tail": float(np.mean(r1[-2:])),
            "fusion_r1_min_ratio": head / low,
            "best_mIoU": float(trainer.best_miou),
            "class_prior_mIoU": class_prior_miou(labels),
            "mIoU_round1": float(per_round.get(1, 0.0)),
            "mIoU_round2": float(per_round.get(2, 0.0)),
            "ssim_vs_guide_round2": float(ssim.get(2, 0.0))}


def rounded(fields: Dict[str, float]) -> Dict[str, float]:
    return {k: round(v, OVERFIT_FIELDS[k]) for k, v in fields.items()}


def overfit_run(seed: int, device):
    """One overfit run at ``seed``: (the trainer after it, the training
    samples)."""
    train_ds, val_ds = overfit_data()
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = InteractiveTrainer(overfit_config(seed, ckpt), train_ds,
                                     val_ds, device=device)
        trainer.run()
    return trainer, train_ds


def seed_spread(per_seed: Dict[int, Dict[str, float]]) -> Dict:
    """min / median / max (and the values, in seed order) of each field
    over the seeds."""
    seeds = list(per_seed)
    out: Dict = {"seeds": seeds}
    for k, dec in OVERFIT_FIELDS.items():
        vals = [per_seed[s][k] for s in seeds]
        out[k] = {"min": round(min(vals), dec),
                  "median": round(statistics.median(vals), dec),
                  "max": round(max(vals), dec),
                  "values": [round(v, dec) for v in vals]}
    return out


def _pair(ref, got) -> Dict:
    d = drift.drift(ref, got)
    return {"fused_y_ssim": round(d["fused_y_ssim"], 5),
            "fused_y_maxdiff": round(d["fused_y_max_abs"], 5),
            "argmax_agree": round(d["argmax_agreement"], 5),
            "logits_max_abs_per_std": round(d["logits_max_abs_per_std"], 5),
            "within_limits": drift.within_limits(d)}


def run_drift(with_int8: bool, device) -> Dict:
    """bf16 (and int8) against f32 on one set of weights and inputs."""
    dev = resolve(device)
    model = drift.init_reference_scale(
        JointPipeline(DRIFT_BACKBONE, num_classes=9),
        torch.Generator().manual_seed(0)).eval()
    b, h, w = DRIFT_SHAPE
    rng = np.random.default_rng(3)
    ir = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32))
    vis = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32))
    f32 = drift.pipeline_outputs(model, ir, vis, torch.float32, dev)
    bf16 = drift.pipeline_outputs(model, ir, vis, torch.bfloat16, dev)
    out = {"bf16_vs_f32": _pair(f32, bf16)}
    if with_int8:
        qmodel = quantize_for_serving(model.to(torch.bfloat16), (ir, vis),
                                      device=dev)
        int8 = drift.pipeline_outputs(qmodel, ir, vis, torch.bfloat16, dev)
        out["int8_vs_f32"] = _pair(f32, int8)
        out["int8_vs_bf16"] = _pair(bf16, int8)
    return out


def describe_device(dev: torch.device) -> Dict:
    """The device the artifact was made on."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu"}
    smi = subprocess.run(["nvidia-smi", "-i", str(dev.index or 0),
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi.stdout.strip() if smi.returncode == 0
            else f"nvidia-smi failed: {smi.stderr.strip()}"}


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", default="", help="also write the line here")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    p.add_argument("--skip_overfit", action="store_true")
    p.add_argument("--skip_drift", action="store_true")
    p.add_argument("--drift_int8", action="store_true",
                   help="add int8 serving's drift against f32 and bf16")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda":    # the overfit and the f32 reference are f32
        determinism.enable()  # before the first cuBLAS call
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = describe_device(dev)
    result: Dict = {"platform": device["platform"], "device": device,
                    "deterministic": dev.type == "cuda"}
    if not args.skip_overfit:
        per_seed, seconds = {}, {}
        for seed in args.seeds:
            t0 = time.perf_counter()
            per_seed[seed] = overfit_fields(*overfit_run(seed, dev))
            seconds[seed] = round(time.perf_counter() - t0, 1)
            print(json.dumps({"overfit_seed": seed, "seconds": seconds[seed],
                              **rounded(per_seed[seed])}), flush=True)
        result["overfit"] = rounded(per_seed[args.seeds[0]])
        result["overfit_per_seed"] = {str(s): rounded(f)
                                      for s, f in per_seed.items()}
        result["overfit_seed_spread"] = seed_spread(per_seed)
        result["overfit_seconds"] = {str(s): t for s, t in seconds.items()}
    if not args.skip_drift:
        t0 = time.perf_counter()
        result["drift"] = run_drift(args.drift_int8, dev)
        result["drift_platform"] = device["platform"]
        result["drift_seconds"] = round(time.perf_counter() - t0, 1)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
