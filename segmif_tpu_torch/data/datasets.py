"""Host-side datasets (counterpart of ``segmif_tpu/data/datasets.py``):
folder loaders for the FMB / MFNet / MSRS layouts, the VOC layout and a
synthetic dataset. Decoding stays on the host; augmentation and
normalisation run on the device (``data.augment``).

 - ``FusionFolderDataset``: per-name IR / Visible / guide / Label PNGs in
   subdirectories of one root (the reference's voc_fusion*.py).
 - ``PairFolderDataset``: globbed ir / vi / label directories, naturally
   sorted (TaskFusion_dataset2).
 - ``MFNetDataset``: names from ``<split>.txt``, 4-channel RGBT images
   resized with PIL (bilinear, which antialiases when it shrinks) and
   labels (nearest).
 - ``MethodFolderDataset``: one directory of a method's fused images.
 - ``VOCSegDataset``: JPEGImages / SegmentationClassAug with a name list.
 - ``SyntheticFusionDataset``: deterministic procedural samples.

Every loader returns float32 [H, W, C] images in [0, 255] and int32
[H, W] labels, byte for byte what the JAX package's loaders return.

Per file, PNG and JPEG go through the native decoder
(``data.native``, runtime/dataloader.cpp) when its probe accepts the
file, and everything else through PIL. When the native library did not
build, every file goes through PIL, and the first read logs why.
``SEGMIF_DISABLE_NATIVE_IO=1`` turns the native decoder off.
"""
from __future__ import annotations

import logging
import os
import re
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_native_mod = None
_native_checked = False
_native_lock = threading.Lock()


def _natsort(names: Sequence[str]) -> List[str]:
    """Natural order: ``img2`` before ``img10``."""
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return sorted(names, key=key)


def _native():
    """The native decoder module if its library built (and is not turned
    off), else None; the first call logs which decoder reads the files."""
    global _native_mod, _native_checked
    with _native_lock:
        if not _native_checked:
            _native_checked = True
            log = logging.getLogger("segmif_tpu_torch")
            if os.environ.get("SEGMIF_DISABLE_NATIVE_IO"):
                log.info("image decode: PIL (SEGMIF_DISABLE_NATIVE_IO set)")
            else:
                from . import native

                if native.available():
                    _native_mod = native
                else:
                    log.warning("image decode: PIL for every file; the "
                                "native decoder did not build: %s",
                                native.build_error())
        return _native_mod


def _load_image(path: Path, gray_to_rgb: bool = False) -> np.ndarray:
    nat = _native()
    if nat is not None and path.suffix.lower() in (".png", ".jpg", ".jpeg"):
        try:
            _, _, c = nat.probe_image(path)
        except IOError:
            c = None   # a file the native decoder does not take: PIL's
        if c is not None:
            out_c = 3 if (gray_to_rgb or c >= 3) else 1
            return nat.decode_image(path, channels=out_c)
    from PIL import Image

    arr = np.asarray(Image.open(path)).astype(np.float32)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1) if gray_to_rgb else arr[..., None]
    elif arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr


def _load_label(path: Path) -> np.ndarray:
    from PIL import Image

    lab = np.asarray(Image.open(path))
    if lab.ndim == 3:
        lab = lab[..., 0]
    return lab.astype(np.int32)


class FusionFolderDataset:
    """The 5-tuple dataset: (name, IR, VIS, guide, label).

    root/
      Infrared/<name>.png   (gray; stacked to 3 channels)
      Visible/<name>.png    (RGB)
      <guide_dir>/<name>.png  (the fused guide / target image)
      Label/<name>.png      (class ids)
    """

    def __init__(self, root: str | Path,
                 split_names: Optional[Sequence[str]] = None,
                 ir_dir: str = "Infrared", vis_dir: str = "Visible",
                 guide_dir: str = "Mask2", label_dir: str = "Label"):
        self.root = Path(root)
        self.dirs = dict(ir=self.root / ir_dir, vis=self.root / vis_dir,
                         guide=self.root / guide_dir,
                         label=self.root / label_dir)
        if split_names is None:
            names = [p.name for p in self.dirs["ir"].iterdir()
                     if p.suffix.lower() in (".png", ".jpg", ".bmp", ".tif")]
            self.names = _natsort(names)
        else:
            self.names = list(split_names)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int):
        n = self.names[i]
        ir = _load_image(self.dirs["ir"] / n, gray_to_rgb=True)
        vis = _load_image(self.dirs["vis"] / n, gray_to_rgb=True)
        guide = _load_image(self.dirs["guide"] / n, gray_to_rgb=True)
        label = _load_label(self.dirs["label"] / n)
        return n, ir, vis, guide, label

    def sample_paths(self):
        """Per-sample (ir, vis, guide, label) paths, for the native batch
        loader (``data.native.NativeLoader``)."""
        return [(self.dirs["ir"] / n, self.dirs["vis"] / n,
                 self.dirs["guide"] / n, self.dirs["label"] / n)
                for n in self.names]


class PairFolderDataset:
    """Eval loader over (ir_dir, vis_dir, label_dir) with globbed, naturally
    sorted file lists."""

    EXTS = (".bmp", ".tif", ".jpg", ".png")

    def __init__(self, ir_dir: str | Path, vis_dir: str | Path,
                 label_dir: Optional[str | Path] = None):
        self.ir_dir = Path(ir_dir)
        self.vis_dir = Path(vis_dir)
        self.label_dir = Path(label_dir) if label_dir else None
        self.names = _natsort([p.name for p in self.ir_dir.iterdir()
                               if p.suffix.lower() in self.EXTS])

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int):
        n = self.names[i]
        ir = _load_image(self.ir_dir / n)[..., 0:1]
        vis = _load_image(self.vis_dir / n, gray_to_rgb=True)
        label = _load_label(self.label_dir / n) if self.label_dir else None
        return n, ir, vis, label


class MFNetDataset:
    """MFNet split loader: names from ``<split>.txt`` under root; 4-channel
    RGBT images in images/, labels in labels/; resized to ``size`` with
    PIL (images bilinear, labels nearest)."""

    def __init__(self, root: str | Path, split: str = "test",
                 size: Tuple[int, int] = (480, 640)):
        self.root = Path(root)
        self.size = size
        with open(self.root / f"{split}.txt") as f:
            self.names = [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int):
        from PIL import Image

        n = self.names[i]
        h, w = self.size
        img = Image.open(self.root / "images" / f"{n}.png").resize(
            (w, h), resample=Image.BILINEAR)
        img = np.asarray(img).astype(np.float32)
        lab = Image.open(self.root / "labels" / f"{n}.png").resize(
            (w, h), resample=Image.NEAREST)
        lab = np.asarray(lab).astype(np.int32)
        # RGBT layout: channels 0-2 visible, channel 3 thermal
        vis = img[..., :3]
        ir = img[..., 3:4] if img.shape[-1] > 3 else img[..., :1]
        return n, ir, vis, lab


class MethodFolderDataset:
    """A method's fused images, for the segmentation eval of
    ``cli.test_segmentation``: (name, image [H,W,3], label)."""

    def __init__(self, fused_dir: str | Path,
                 label_dir: Optional[str | Path] = None):
        self.fused_dir = Path(fused_dir)
        self.label_dir = Path(label_dir) if label_dir else None
        self.names = _natsort(
            [p.name for p in self.fused_dir.iterdir()
             if p.suffix.lower() in PairFolderDataset.EXTS])

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int):
        n = self.names[i]
        img = _load_image(self.fused_dir / n, gray_to_rgb=True)
        label = _load_label(self.label_dir / n) if self.label_dir else None
        return n, img, label


class VOCSegDataset:
    """PASCAL-VOC-layout segmentation dataset: the name list from
    ``<name_list_dir>/<split>.txt``, images in ``JPEGImages/``, labels in
    ``SegmentationClassAug/``. ``stage='test'`` has no labels and returns
    the image's first channel as a placeholder label. ``class_labels``
    gives the one-hot class presence of a sample's mask."""

    def __init__(self, root_dir: str | Path,
                 name_list_dir: Optional[str | Path] = None,
                 split: str = "train", stage: str = "train",
                 ignore_index: int = 255):
        self.root = Path(root_dir)
        self.img_dir = self.root / "JPEGImages"
        self.label_dir = self.root / "SegmentationClassAug"
        self.stage = stage
        self.ignore_index = ignore_index
        lst = Path(name_list_dir or self.root) / f"{split}.txt"
        with open(lst) as f:
            self.names = [ln.strip().split()[0] for ln in f if ln.strip()]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int):
        n = self.names[i]
        img = _load_image(self.img_dir / f"{n}.jpg", gray_to_rgb=True)
        if self.stage == "test":
            label = img[..., 0].astype(np.int32)
        else:
            label = _load_label(self.label_dir / f"{n}.png")
        return n, img, label

    def class_labels(self, i: int, num_classes: int = 21) -> np.ndarray:
        """One-hot uint8 vector of the classes present in the mask
        (ignore_index and out-of-range ids dropped)."""
        _, _, label = self[i]
        present = np.unique(label)
        present = present[(present != self.ignore_index)
                          & (present < num_classes)]
        onehot = np.zeros((num_classes,), np.uint8)
        onehot[present] = 1
        return onehot


class SyntheticFusionDataset:
    """Deterministic procedurally generated IR/VIS/guide/label samples with
    MFNet-like statistics, for tests and smoke runs. ``ds[i]`` is
    ``(name, ir [H,W,3], vis [H,W,3], guide [H,W,3], label [H,W])``: the
    images float32 in [0, 255], the label int32."""

    def __init__(self, n: int = 16, size: Tuple[int, int] = (480, 640),
                 num_classes: int = 9, seed: int = 0):
        self.n = n
        self.size = size
        self.num_classes = num_classes
        self.seed = seed
        self.names = [f"synthetic_{i:05d}.png" for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        h, w = self.size
        rng = np.random.default_rng(self.seed * 100003 + i)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, 4)
        base = (np.sin(xx / 37.0 + phase[0]) + np.cos(yy / 23.0 + phase[1]))
        hot = np.maximum(np.sin(xx / 11.0 + phase[2]) *
                         np.cos(yy / 17.0 + phase[3]), 0.0)
        ir = np.clip((base * 0.25 + 0.5 + hot * 0.4) * 255.0, 0, 255)
        ir3 = np.stack([ir] * 3, -1).astype(np.float32)
        vis = np.stack([
            np.clip((base * 0.3 + 0.5) * 255.0, 0, 255),
            np.clip((base * 0.2 + 0.45) * 255.0, 0, 255),
            np.clip((-base * 0.25 + 0.5) * 255.0, 0, 255),
        ], -1).astype(np.float32)
        guide = np.clip(np.maximum(ir3, vis), 0, 255).astype(np.float32)
        label = (np.floor((hot * 2 + base + 2) * 2.0).astype(np.int32)
                 % self.num_classes)
        return self.names[i], ir3, vis, guide, label
