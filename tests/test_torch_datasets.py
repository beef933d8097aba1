"""The port's folder datasets (``segmif_tpu_torch.data.datasets``) against
the JAX package's, on files written with the JAX package's ``save_png``:
names and arrays bit for bit (dtypes included), through the native
decoder and through PIL, for

 - ``FusionFolderDataset`` (a gray IR PNG stacked to 3 channels, RGB VIS
   and guide, gray labels; ``sample_paths``),
 - ``PairFolderDataset`` (gray and RGB IR, an unlabelled variant),
 - ``MFNetDataset`` (4-channel RGBT PNGs shrunk by PIL's bilinear resize,
   which antialiases, labels by nearest),
 - ``MethodFolderDataset`` (with and without labels),
 - ``VOCSegDataset`` (JPEG images; train and test stages; ``class_labels``),

in natural order (``img2`` before ``img10``)."""
import numpy as np
import pytest

import segmif_tpu.data.datasets as jax_datasets
from segmif_tpu.eval.image_io import save_png
from segmif_tpu_torch.data import datasets

NAMES = ["img10.png", "img2.png", "img1.png"]
NATURAL = ["img1.png", "img2.png", "img10.png"]


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    """Both packages through the native decoder, or both through PIL."""
    if request.param == "pil":
        monkeypatch.setattr(datasets, "_native_mod", None)
        monkeypatch.setattr(datasets, "_native_checked", True)
        monkeypatch.setattr(jax_datasets, "_USE_NATIVE", False)
    else:
        assert datasets._native() is not None, "the native decoder built"
        assert jax_datasets._native() is not None
    return request.param


def _rng(seed):
    return np.random.default_rng(seed)


def _write_fusion(root, seed=0, h=20, w=28):
    rng = _rng(seed)
    for n in NAMES:
        save_png(root / "Infrared" / n, rng.integers(0, 256, (h, w),
                                                     dtype=np.uint8))
        for d in ("Visible", "Mask2"):
            save_png(root / d / n, rng.integers(0, 256, (h, w, 3),
                                                dtype=np.uint8))
        save_png(root / "Label" / n, rng.integers(0, 9, (h, w),
                                                  dtype=np.uint8))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or isinstance(x, str):
            assert x == y
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def _same_dataset(mine, ref):
    assert mine.names == ref.names
    for i in range(len(ref)):
        _same(mine[i], ref[i])


def test_natsort():
    got = datasets._natsort(["a10b2", "a2b10", "a2b9", "a10b1", "b"])
    assert got == ["a2b9", "a2b10", "a10b1", "a10b2", "b"]
    assert got == jax_datasets._natsort(["a10b2", "a2b10", "a2b9", "a10b1",
                                         "b"])


def test_fusion_folder_dataset(tmp_path, decoder):
    _write_fusion(tmp_path)
    mine = datasets.FusionFolderDataset(tmp_path)
    ref = jax_datasets.FusionFolderDataset(tmp_path)
    assert mine.names == NATURAL
    _same_dataset(mine, ref)
    _, ir, vis, guide, label = mine[0]
    assert ir.shape == (20, 28, 3) and label.dtype == np.int32
    np.testing.assert_array_equal(ir[..., 0], ir[..., 2])
    assert mine.sample_paths() == ref.sample_paths()
    split = datasets.FusionFolderDataset(tmp_path, split_names=["img2.png"])
    assert split.names == ["img2.png"]
    _same(split[0], mine[1])


@pytest.mark.parametrize("ir_rgb,labelled", [(False, True), (True, False)])
def test_pair_folder_dataset(tmp_path, decoder, ir_rgb, labelled):
    rng = _rng(1)
    for n in NAMES:
        save_png(tmp_path / "ir" / n, rng.integers(
            0, 256, (12, 16, 3) if ir_rgb else (12, 16), dtype=np.uint8))
        save_png(tmp_path / "vi" / n, rng.integers(0, 256, (12, 16, 3),
                                                   dtype=np.uint8))
        save_png(tmp_path / "label" / n, rng.integers(0, 9, (12, 16),
                                                      dtype=np.uint8))
    args = (tmp_path / "ir", tmp_path / "vi",
            tmp_path / "label" if labelled else None)
    mine = datasets.PairFolderDataset(*args)
    assert mine.names == NATURAL
    _same_dataset(mine, jax_datasets.PairFolderDataset(*args))
    assert mine[0][1].shape == (12, 16, 1)
    assert (mine[0][3] is None) == (not labelled)


def test_mfnet_dataset(tmp_path):
    """4-channel RGBT PNGs shrunk from 40x56 to 24x32 (PIL's bilinear
    antialiases when it shrinks), labels by nearest; and a 3-channel image
    (IR from channel 0)."""
    rng = _rng(2)
    names = ["00012D", "00003N", "00100D"]
    for k, n in enumerate(names):
        c = 3 if k == 2 else 4
        save_png(tmp_path / "images" / f"{n}.png",
                 rng.integers(0, 256, (40, 56, c), dtype=np.uint8))
        save_png(tmp_path / "labels" / f"{n}.png",
                 rng.integers(0, 9, (40, 56), dtype=np.uint8))
    (tmp_path / "test.txt").write_text("\n".join(names) + "\n\n")
    mine = datasets.MFNetDataset(tmp_path, "test", (24, 32))
    _same_dataset(mine, jax_datasets.MFNetDataset(tmp_path, "test",
                                                  (24, 32)))
    _, ir, vis, lab = mine[0]
    assert ir.shape == (24, 32, 1) and vis.shape == (24, 32, 3)
    assert lab.dtype == np.int32 and mine.names == names


@pytest.mark.parametrize("labelled", [True, False])
def test_method_folder_dataset(tmp_path, decoder, labelled):
    rng = _rng(3)
    for n in NAMES + ["notes.txt"]:
        if n.endswith(".txt"):
            (tmp_path / "fused" / n).write_text("not an image")
            continue
        save_png(tmp_path / "fused" / n, rng.integers(0, 256, (10, 14, 3),
                                                      dtype=np.uint8))
        save_png(tmp_path / "label" / n, rng.integers(0, 9, (10, 14),
                                                      dtype=np.uint8))
    args = (tmp_path / "fused", tmp_path / "label" if labelled else None)
    mine = datasets.MethodFolderDataset(*args)
    assert mine.names == NATURAL
    _same_dataset(mine, jax_datasets.MethodFolderDataset(*args))


@pytest.mark.parametrize("stage", ["train", "test"])
def test_voc_seg_dataset(tmp_path, decoder, stage):
    """JPEG images (the native decoder and PIL both decode them; the two
    packages agree with each other through either), PNG labels with the
    ignore index, and ``class_labels``."""
    rng = _rng(4)
    names = ["2007_000032", "2007_000005"]
    for k, n in enumerate(names):
        save_png(tmp_path / "JPEGImages" / f"{n}.jpg",
                 rng.integers(0, 256, (18, 22, 3), dtype=np.uint8))
        lab = rng.integers(0, 6 + 10 * k, (18, 22), dtype=np.uint8)
        lab[:3] = 255
        save_png(tmp_path / "SegmentationClassAug" / f"{n}.png", lab)
    (tmp_path / "lists").mkdir()
    (tmp_path / "lists" / "val.txt").write_text(
        "".join(f"{n} extra\n" for n in names))
    args = (tmp_path, tmp_path / "lists", "val", stage)
    mine = datasets.VOCSegDataset(*args)
    ref = jax_datasets.VOCSegDataset(*args)
    _same_dataset(mine, ref)
    for i in range(len(names)):
        for c in (21, 12):
            a, b = mine.class_labels(i, c), ref.class_labels(i, c)
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    if stage == "train":
        assert mine.class_labels(0, 21).sum() == 6


def test_synthetic_dataset_has_no_paths():
    assert not hasattr(datasets.SyntheticFusionDataset(2, (8, 8)),
                       "sample_paths")
