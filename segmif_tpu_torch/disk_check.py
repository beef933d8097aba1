"""Checks of the disk-to-disk path: PNG folders through the decoders, the
trainer, ``cli.test_fusion`` and ``cli.test_segmentation``, back to PNG
files and an mIoU table. Shared by ``chip_smoke.py`` (phase 10, on the
card at mit_b3 480x640) and the tests (on the CPU at small sizes, and on
the card in ``tests/test_torch_cuda.py``).

 - ``write_folder``: a split of ``SyntheticFusionDataset`` written as
   uint8 PNGs in the Infrared / Visible / Mask2 / Label layout, named
   ``frame<i>.png`` (so that from ten samples on, natural order and
   ``sorted`` part), IR as gray; the labels gray, or with
   ``rgb_labels`` as RGB with the class id in R (the channel
   ``_load_label`` reads) and palette colours in G and B.
 - ``folder_problems``: a ``FusionFolderDataset`` over such a folder
   gives the written names in natural order and the written bytes.
 - ``decoder_checks``: every decoder the machine has (PIL; the native
   per-file decoder and ``NativeLoader`` when their library built) returns
   the written bytes, and its decode rate on ``threads`` threads.
 - ``trainer_check``: ``cli.train.main`` on two folders with
   ``--streaming --dump_fused_images``; the val memmap rows are
   ``_to_uint8`` of the fused arrays the trainer regenerated, the dumped
   PNGs are ``fused_to_uint8`` of the same arrays batch by batch, and a
   fresh ``generate_fused`` from the written fusion checkpoint gives
   them again.
 - ``fusion_cli_check``: ``cli.test_fusion.main``'s PNGs are
   ``fused_to_uint8`` of ``generate_fused`` run in memory on the same
   arrays, batch by batch, and its writer was handed only the real images
   of each batch.
 - ``segmentation_cli_check``: ``cli.test_segmentation.main``'s result is
   ``segmentation_eval`` run in memory on the decoded arrays.
 - ``planted_faults``: a label read from the wrong channel, ``sorted`` in
   place of the natural order, and a last batch's padding handed to the
   stretch; each must make the unchanged checks report a problem.

Every check returns a list of problems (empty: it holds) beside what it
measured; the caller decides what a problem means.
"""
from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .data import datasets
from .data.datasets import FusionFolderDataset, SyntheticFusionDataset
from .eval import evaluator
from .eval.evaluator import generate_fused, segmentation_eval
from .eval.image_io import fused_to_uint8, save_png
from .eval.visual import encode_cmap
from .cli.test_fusion import build_model, make_static_guide_fuse_fn
from .train.steps import make_fuse_fn, make_segment_fn

DIRS = ("Infrared", "Visible", "Mask2", "Label")


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name = value`` for the block."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _png(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def write_folder(root, n: int, size, seed: int, num_classes: int = 9,
                 rgb_labels: bool = False) -> Dict:
    """Write ``n`` samples of ``SyntheticFusionDataset(n, size,
    num_classes, seed)`` under ``root``; returns what was written: the
    names and the uint8 arrays of each directory (``label`` the class
    ids, ``label_file`` the label image as written)."""
    root = Path(root)
    ds = SyntheticFusionDataset(n, tuple(size), num_classes, seed)
    names = [f"frame{i}.png" for i in range(n)]
    out = {k: [] for k in ("ir", "vis", "guide", "label", "label_file")}
    for i, name in enumerate(names):
        _, ir, vis, guide, label = ds[i]
        lab = label.astype(np.uint8)
        arrays = {"ir": ir[..., 0].astype(np.uint8),
                  "vis": vis.astype(np.uint8),
                  "guide": guide.astype(np.uint8), "label": label,
                  "label_file": np.concatenate(
                      [lab[..., None], encode_cmap(label)[..., 1:]], -1)
                  if rgb_labels else lab}
        for d, k in zip(DIRS, ("ir", "vis", "guide", "label_file")):
            save_png(root / d / name, arrays[k])
        for k, a in arrays.items():
            out[k].append(a)
    written = {k: np.stack(v) for k, v in out.items()}
    written["names"] = names
    written["root"] = root
    return written


def folder_problems(ds, written: Dict) -> List[str]:
    """A ``FusionFolderDataset`` against what ``write_folder`` wrote: the
    names in order, and each sample's arrays (float32 images, IR stacked
    to 3 channels; int32 labels) equal to the written bytes."""
    if list(ds.names) != written["names"]:
        return [f"names {list(ds.names)[:12]} != written "
                f"{written['names'][:12]}"]
    problems = []
    for i, name in enumerate(written["names"]):
        _, ir, vis, guide, label = ds[i]
        want = {"ir": np.repeat(written["ir"][i][..., None], 3, -1),
                "vis": written["vis"][i], "guide": written["guide"][i]}
        for k, got in (("ir", ir), ("vis", vis), ("guide", guide)):
            if got.dtype != np.float32 or not np.array_equal(got, want[k]):
                problems.append(f"{name} {k}")
        if label.dtype != np.int32 or not np.array_equal(
                label, written["label"][i]):
            problems.append(f"{name} label")
    return problems


def _files(written: Dict):
    """(path, written uint8 array) of every file of a folder."""
    root = written["root"]
    for i, name in enumerate(written["names"]):
        for d, k in zip(DIRS, ("ir", "vis", "guide", "label_file")):
            yield root / d / name, written[k][i]


def _rate(fn, items, threads: int, repeats: int) -> float:
    """Items per second of ``fn`` mapped over ``items`` on ``threads``
    threads, ``repeats`` times (after one pass that is not timed)."""
    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(fn, items))
        t0 = time.perf_counter()
        for _ in range(repeats):
            list(ex.map(fn, items))
        return repeats * len(items) / (time.perf_counter() - t0)


def decoder_checks(folders: List[Dict], threads: int = 4,
                   repeats: int = 2) -> Dict:
    """Each decoder the machine has against the written bytes, and its
    rate in images/s on ``threads`` threads. Returns ``{"problems",
    "rates": {decoder: images/s or None}, "native_error"}``."""
    from .data import native

    files = [f for w in folders for f in _files(w)]
    problems, rates = [], {}
    for path, want in files:
        if not np.array_equal(_png(path), want):
            problems.append(f"PIL {path}")
    rates["PIL"] = _rate(_png, [p for p, _ in files], threads, repeats)
    err = native.build_error()
    if err is not None:
        rates["native decode_image"] = rates["native NativeLoader"] = None
        return {"problems": problems, "rates": rates, "native_error": err}

    def channels(a):
        return 1 if a.ndim == 2 else a.shape[-1]

    for path, want in files:
        got = native.decode_image(path, channels=channels(want))
        if not np.array_equal(got, want.reshape(got.shape)):
            problems.append(f"native decode_image {path}")
    rates["native decode_image"] = _rate(
        lambda f: native.decode_image(f[0], channels=channels(f[1])), files,
        threads, repeats)
    samples, seconds = 0, 0.0
    for w in folders:
        n = len(w["names"])
        by_ir = {w["ir"][i].tobytes(): i for i in range(n)}
        loader = native.NativeLoader(
            FusionFolderDataset(w["root"]).sample_paths(), 4,
            w["ir"].shape[1:3], num_threads=threads, seed=1, resize=False)
        batches = iter(loader)
        seen = set()
        # the batches of the first epoch, and as many as the threads and
        # the queue may have finished ahead of them (the threads deliver
        # in the order they finish), checked
        for b in range(-(-n // 4) + 2 * threads):
            for s in next(batches).astype(np.uint8):   # [4, H, W, 3]
                i = by_ir.get(s[0, ..., 0].tobytes())
                seen.add(i)
                if i is None or not (
                        all(np.array_equal(s[0, ..., c], w["ir"][i])
                            for c in range(3))
                        and np.array_equal(s[1], w["vis"][i])
                        and np.array_equal(s[2], w["guide"][i])
                        and np.array_equal(s[3, ..., 0],
                                           w["label"][i].astype(np.uint8))):
                    problems.append(f"NativeLoader {w['root']} batch {b}")
        if seen != set(range(n)):
            problems.append(f"NativeLoader {w['root']}: saw samples "
                            f"{sorted(seen, key=str)} of {n}")
        t0 = time.perf_counter()
        for _ in range(repeats * -(-n // 4)):
            next(batches)
            samples += 4
        seconds += time.perf_counter() - t0
        loader.close()
    rates["native NativeLoader"] = 4 * samples / seconds
    return {"problems": problems, "rates": rates, "native_error": None}


def _dtypes(dtype_name: str, device):
    from ._device import resolve
    from .kernels import _build

    dtype = getattr(torch, dtype_name)
    return resolve(device), dtype, _build.acc_dtype(dtype)


def _diff(got: np.ndarray, want: np.ndarray) -> Dict:
    """uint8 arrays: the share of elements that differ and the largest
    difference."""
    if got.shape != want.shape:
        return {"share": 1.0, "max": None, "shape": (got.shape, want.shape)}
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return {"share": float((d > 0).mean()), "max": int(d.max())}


def _batched_uint8(fused: np.ndarray, batch: int, reference: bool):
    return np.concatenate([fused_to_uint8(fused[s:s + batch], reference)
                           for s in range(0, len(fused), batch)])


def trainer_check(train: Dict, val: Dict, ckpt_dir, backbone: str,
                  dtype_name: str, device, args: List[str]) -> Dict:
    """``cli.train.main`` with ``--streaming --dump_fused_images`` for one
    round on the two folders, plus ``args``; see the module docstring.
    ``fresh``: the share of the val bytes where a fresh regeneration
    differs from the trainer's, and the largest difference; the fresh
    model is initialised as the trainer's (seed 0, the config's default)
    and takes the fusion weights the trainer wrote."""
    from .cli import train as cli_train
    from .models.network import JointPipeline, init_params
    from .train import checkpoint as ckpt
    from .train import interactive

    ckpt_dir = Path(ckpt_dir)
    captured: Dict[str, list] = {}
    real_gen = interactive.generate_fused

    def capturing(fuse_fn, data, **kw):
        sink, tag = kw["sink"], data.cache_path.stem

        def keep(start, fused, guide):
            captured.setdefault(tag, []).append((start, fused.copy()))
            sink(start, fused, guide)

        return real_gen(fuse_fn, data, **{**kw, "sink": keep})

    argv = ["--data_root", str(train["root"]), "--val_root",
            str(val["root"]), "--streaming", "--dump_fused_images",
            "--rounds", "1", "--backbone", backbone, "--compute_dtype",
            dtype_name, "--checkpoint_dir", str(ckpt_dir), "--device",
            str(device)] + list(args)
    with patched(interactive, "generate_fused", capturing):
        result = cli_train.main(argv)
    fused = np.concatenate([f for _, f in sorted(captured["fused_val"],
                                                 key=lambda t: t[0])])
    n, h, w = val["ir"].shape
    problems = []
    mm = np.array(np.memmap(ckpt_dir / "fused_val.u8", np.uint8, "r",
                            shape=(n, h, w, 3)))
    if not np.array_equal(mm, interactive._to_uint8(fused)):
        problems.append("the val memmap is not _to_uint8 of the "
                        "regenerated arrays")
    dumped = np.stack([_png(ckpt_dir / "fused_val_r1" / nm)
                       for nm in val["names"]])
    if not np.array_equal(dumped, _batched_uint8(fused, 4, False)):
        problems.append("the dumped val PNGs are not fused_to_uint8 of the "
                        "regenerated arrays")
    dev, dtype, acc = _dtypes(dtype_name, device)
    model = init_params(JointPipeline(backbone),
                        torch.Generator().manual_seed(0))
    ckpt.load_role(ckpt_dir / "fusion_params.pth", model.fusion)
    _, again, _ = generate_fused(make_fuse_fn(model, dtype, dev),
                                 FusionFolderDataset(val["root"]), 4,
                                 device=dev, dtype=acc)
    fresh = _diff(interactive._to_uint8(again), mm)
    return {"problems": problems, "result": result, "fresh": fresh}


def fusion_cli_check(val: Dict, out_dir, ckpt_dir, backbone: str,
                     batch: int, dtype_name: str, device,
                     static_guide: Optional[str] = None,
                     reference_quantization: bool = False) -> Dict:
    """``cli.test_fusion.main`` over ``val``'s folder against
    ``generate_fused`` in memory (the same model, arrays and batches).
    Host seconds of the CLI's ``generate_fused`` call: ``seconds`` in all
    (read, upload, fuse, fetch, quantise, encode, write), of which
    ``read_wait`` waiting for the prefetch threads' next batch and
    ``write`` in the writer (quantise, encode, write)."""
    from .cli import test_fusion

    out_dir = Path(out_dir)
    handed: List[tuple] = []
    real_write = evaluator.write_fused_batch
    real_gen = evaluator.generate_fused
    real_iter = evaluator.iterate_eval
    wall, waits, writes = [], [], []

    def write(out, names, fused, reference):
        handed.append((len(names), len(fused)))
        t0 = time.perf_counter()
        real_write(out, names, fused, reference)
        writes.append(time.perf_counter() - t0)

    def waited(*a, **kw):
        batches = real_iter(*a, **kw)
        while True:
            t0 = time.perf_counter()
            item = next(batches, None)
            waits.append(time.perf_counter() - t0)
            if item is None:
                return
            yield item

    def timed(*a, **kw):
        t0 = time.perf_counter()
        r = real_gen(*a, **kw)
        wall.append(time.perf_counter() - t0)
        return r

    argv = ["--data_root", str(val["root"]), "--out_dir", str(out_dir),
            "--checkpoint_dir", str(ckpt_dir), "--backbone", backbone,
            "-B", str(batch), "--compute_dtype", dtype_name, "--device",
            str(device)]
    if static_guide:
        argv += ["--static_guide", str(static_guide)]
    if reference_quantization:
        argv += ["--reference_quantization"]
    with patched(evaluator, "write_fused_batch", write), \
            patched(evaluator, "generate_fused", timed), \
            patched(evaluator, "iterate_eval", waited):
        names = test_fusion.main(argv)
    n = len(val["names"])
    problems = []
    if names != val["names"]:
        problems.append(f"names {names[:12]}")
    want_handed = [(min(batch, n - s),) * 2 for s in range(0, n, batch)]
    if handed != want_handed:
        problems.append(f"the writer was handed (names, images) {handed}, "
                        f"not each batch's real images {want_handed}")
    pngs = np.stack([_png(out_dir / nm) for nm in val["names"]])
    dev, dtype, acc = _dtypes(dtype_name, device)
    model = build_model(backbone, 9, str(ckpt_dir))
    if static_guide:
        guide = datasets._load_image(Path(static_guide), gray_to_rgb=True)
        fuse = make_static_guide_fuse_fn(
            model, torch.from_numpy(guide)[None] / 255.0, dtype, dev)
    else:
        fuse = make_fuse_fn(model, dtype, dev)
    _, fused, _ = generate_fused(fuse, FusionFolderDataset(val["root"]),
                                 batch, device=dev, dtype=acc)
    diff = _diff(pngs, _batched_uint8(fused, batch, reference_quantization))
    if diff["share"] != 0.0:
        problems.append(f"PNGs differ from fused_to_uint8 of the in-memory "
                        f"run: {diff}")
    return {"problems": problems, "pngs": pngs, "seconds": wall[0],
            "read_wait": sum(waits), "write": sum(writes)}


def segmentation_cli_check(fused_dir, val: Dict, ckpt_dir, backbone: str,
                           batch: int, dtype_name: str, device,
                           log_file) -> Dict:
    """``cli.test_segmentation.main`` on ``fused_dir`` against
    ``segmentation_eval`` on the decoded PNGs in memory."""
    from .cli import test_segmentation

    argv = ["--fused_dir", str(fused_dir), "--label_dir",
            str(val["root"] / "Label"), "--checkpoint_dir", str(ckpt_dir),
            "--backbone", backbone, "-B", str(batch), "--compute_dtype",
            dtype_name, "--device", str(device), "--log_file",
            str(log_file)]
    got = test_segmentation.main(argv)
    mem = [(nm, _png(Path(fused_dir) / nm).astype(np.float32),
            val["label"][i]) for i, nm in enumerate(val["names"])]
    dev, dtype, acc = _dtypes(dtype_name, device)
    model = build_model(backbone, 9, str(ckpt_dir))
    want = segmentation_eval(make_segment_fn(model.seg, dtype, dev), mem, 9,
                             batch, device=dev, dtype=acc)
    problems = [k for k in ("iou", "precision", "recall")
                if not np.array_equal(got[k], want[k], equal_nan=True)]
    if not np.array_equal(got["confusion"], want["confusion"]):
        problems.append("confusion")
    problems += [k for k in ("mIoU", "pixel_acc")
                 if not np.array_equal(got[k], want[k], equal_nan=True)]
    return {"problems": problems, "result": got}


def _label_channel_1(path):
    lab = _png(path)
    return (lab[..., 1] if lab.ndim == 3 else lab).astype(np.int32)


def planted_faults(train: Dict, val: Dict, out_dir, ckpt_dir,
                   backbone: str, dtype_name: str, device) -> Dict:
    """The problems each planted fault makes the unchanged checks report
    (each list must be non-empty): the label read from channel 1 (on
    ``val``, whose labels are RGB), ``sorted`` in place of the natural
    order (on ``train``, of more than ten samples), and the padding of the
    last batch handed to the stretch (``fusion_cli_check`` at a batch
    size that pads ``val``'s last batch)."""
    out = {}
    with patched(datasets, "_load_label", _label_channel_1):
        out["label from channel 1"] = folder_problems(
            FusionFolderDataset(val["root"]), val)
    with patched(datasets, "_natsort", sorted):
        out["sorted, not natural order"] = folder_problems(
            FusionFolderDataset(train["root"]), train)
    n = len(val["names"])
    batch = next(b for b in range(2, n) if n % b)
    real = evaluator.iterate_eval

    def padding_is_real(dataset, batch_size, *a, **kw):
        for names, _, arrays in real(dataset, batch_size, *a, **kw):
            yield names, batch_size, arrays

    with patched(evaluator, "iterate_eval", padding_is_real):
        out["padding in the stretch"] = fusion_cli_check(
            val, out_dir, ckpt_dir, backbone, batch, dtype_name,
            device)["problems"]
    return out
