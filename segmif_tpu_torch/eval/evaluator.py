"""Evaluation drivers (counterpart of ``segmif_tpu/eval/evaluator.py``):

 - ``segmentation_eval``: segment a dataset, accumulate the confusion
   matrix on the device (no host read per batch), derive per-class
   precision / IoU and the mIoU (mean IoU) on the host at the end;
 - ``generate_fused``: fuse every (ir, vis) pair with the taps of its
   guide, handed over in memory (or batch by batch to a ``sink``), and
   optionally written as PNGs (``out_dir``, ``eval.image_io``);
 - ``fusion_quality_eval``: SSIM and MSE of the fused Y against the
   guide's Y.

Images cross to the device as uint8 and are cast there. Each function
runs on the card unless given ``device="cpu"``; ``dtype`` is the float
type of the images handed to the model (f32; f64 for an f64 model).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .._device import resolve, upload
from ..data.pipeline import iterate_eval
from ..ops.color import rgb_to_ycrcb
from ..ops.ssim import ssim
from .image_io import write_fused_batch
from .metrics import compute_results, confusion_matrix, scores


def segmentation_eval(segment_fn: Callable, dataset, num_classes: int,
                      batch_size: int = 4, log_file: Optional[str] = None,
                      tag: str = "", device=None,
                      dtype: torch.dtype = torch.float32) -> Dict:
    """dataset yields (name, image_rgb255 [H,W,3], label) triples or
    (name, ir, vis, guide, label) 5-tuples, whose GUIDE slot (the fused
    image) is segmented. segment_fn: ``(rgb01 [B,H,W,3]) -> [B,H,W]``
    class ids (``train.steps.make_segment_fn``)."""
    dev = resolve(device)
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=dev)
    for _, count, arrays in iterate_eval(dataset, batch_size):
        imgs, labels = arrays if len(arrays) == 2 else (arrays[2], arrays[3])
        pred = segment_fn(upload(imgs, dev).to(dtype) / 255.0)
        labels = upload(labels, dev)
        conf += confusion_matrix(labels[:count], pred[:count], num_classes)
    conf = conf.cpu().numpy()
    s = scores(conf)
    precision, recall, iou = compute_results(conf)
    result = {
        "mIoU": float(s["Mean IoU"]),
        "pixel_acc": float(s["Pixel Accuracy"]),
        "mean_acc": float(s["Mean Accuracy"]),
        "precision": precision,
        "recall": recall,
        "iou": iou,
        "confusion": conf,
    }
    if log_file:
        _append_eval_log(log_file, tag, result)
    return result


def _append_eval_log(path: str, tag: str, result: Dict) -> None:
    """Append a per-class precision/IoU table (the reference's running txt
    logs)."""
    with open(path, "a") as f:
        f.write(f"== {tag} ==\n")
        for c, (p, i) in enumerate(zip(result["precision"], result["iou"])):
            f.write(f"class {c}: precision {p:.4f} iou {i:.4f}\n")
        f.write(f"mIoU {result['mIoU']:.4f} acc {result['pixel_acc']:.4f}\n")


def generate_fused(fuse_fn: Callable, dataset, batch_size: int = 4,
                   out_dir: Optional[str | Path] = None,
                   quantize_like_reference: bool = False,
                   sink: Optional[Callable] = None, device=None,
                   dtype: torch.dtype = torch.float32):
    """Fuse a whole dataset of (name, ir, vis, guide, label) 5-tuples.
    fuse_fn: ``(ir [B,H,W,1], vis, guide) -> (fused_rgb, fused_y)`` in
    [0,1] (``train.steps.make_fuse_fn``).

    Returns (names, fused_rgb01 [N,H,W,3] float32 numpy, labels [N,H,W]
    int32). With ``out_dir``, each batch's real images (not the repeats
    that pad the last batch) are also written as ``<out_dir>/<name>``,
    quantised together (``image_io.write_fused_batch``). With ``sink``,
    ``sink(start, fused_np, guide_np)`` (both [b,H,W,3] float32 in [0,1],
    ``start`` the dataset index of the batch's first sample) is called
    per batch instead of accumulating, and the returned fused array is
    None."""
    dev = resolve(device)
    all_names, all_fused, all_labels = [], [], []
    start = 0
    for names, count, (ir, vis, guide, label) in iterate_eval(dataset,
                                                              batch_size):
        ir_y, vis01, guide01 = (upload(a, dev).to(dtype) / 255.0
                                for a in (ir[..., 0:1], vis, guide))
        fused_rgb, _ = fuse_fn(ir_y, vis01, guide01)
        fused_np = fused_rgb[:count].float().cpu().numpy()
        if out_dir is not None:
            write_fused_batch(out_dir, names, fused_np,
                              quantize_like_reference)
        all_names.extend(names)
        if sink is not None:
            sink(start, fused_np, guide01[:count].float().cpu().numpy())
        else:
            all_fused.append(fused_np)
        if label is not None:
            all_labels.append(np.asarray(label[:count], np.int32))
        start += count
    fused = (np.concatenate(all_fused) if all_fused
             else None if sink is not None else np.zeros((0,)))
    labels = np.concatenate(all_labels) if all_labels else None
    return all_names, fused, labels


def fusion_quality_eval(fused_rgb01: np.ndarray, guide_rgb01: np.ndarray,
                        device=None) -> Dict:
    """SSIM and MSE of the fused Y channel against the guide's Y channel
    (the Fusionloss_grad3 fidelity terms), in the inputs' float type."""
    dev = resolve(device)
    fy = rgb_to_ycrcb(upload(fused_rgb01, dev))[..., 0:1]
    gy = rgb_to_ycrcb(upload(guide_rgb01, dev))[..., 0:1]
    return {"ssim": float(ssim(fy, gy)),
            "mse": float(torch.mean((fy - gy) ** 2))}
