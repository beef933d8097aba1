"""The port's disk-backed splits (``train/streaming.py``) and the
interactive trainer's ``streaming`` and ``dump_fused_images``, on folders
written with the JAX package's ``save_png`` (mit_b0, 32x32, 4 training and
2 validation pairs):

 - ``StreamingFusionData`` against the JAX package's: the items, names and
   paths, the uint8 memmap under the checkpoint dir, a memmap of another
   geometry recreated, the seg view reading the memmap, the refusal
   before the first regeneration;
 - one port round with ``streaming`` (Python readers, the in-memory run's
   batch order) gives the in-memory round's losses, mIoU and fused bytes
   exactly, and its val SSIM, averaged over the batches weighted by their
   sizes, within 1e-6; both rounds dump the fused PNGs;
 - a streaming round reads its fusion phase through the native loader
   when asked;
 - one f64 round of the streaming port trainer against the JAX streaming
   trainer, with the harness and limits of test_torch_interactive_parity
   (both fusion phases through the native loader on one thread, so that
   the C++ shuffle delivers its batches in one order).
"""
import numpy as np
import pytest

import segmif_tpu.data.datasets as jax_datasets
import segmif_tpu.data.native as jax_native
import segmif_tpu.train.streaming as jax_streaming
from segmif_tpu.data.datasets import SyntheticFusionDataset
from segmif_tpu.eval.image_io import save_png
from segmif_tpu_torch.data import native
from segmif_tpu_torch.data.datasets import FusionFolderDataset
from segmif_tpu_torch.eval.image_io import load_fused_dir
from segmif_tpu_torch.train import interactive, streaming
from test_torch_interactive import tiny_cfg
from test_torch_interactive_parity import run_round
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


def _write(root, n, seed, size=(32, 32)):
    src = SyntheticFusionDataset(n=n, size=size, seed=seed)
    for i in range(n):
        name, ir, vis, g, lab = src[i]
        for d, a in (("Infrared", ir[..., 0]), ("Visible", vis),
                     ("Mask2", g), ("Label", lab)):
            save_png(root / d / name, a.astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    return _write(d / "train", 4, 0), _write(d / "val", 2, 1)


def test_streaming_data_equals_jax(folders, tmp_path):
    train, _ = folders
    mine = streaming.StreamingFusionData(FusionFolderDataset(train),
                                         tmp_path / "a", "train")
    ref = jax_streaming.StreamingFusionData(
        jax_datasets.FusionFolderDataset(train), tmp_path / "b", "train")
    assert len(mine) == len(ref) == 4 and mine.names == ref.names
    assert mine.sample_paths() == ref.sample_paths()
    for i in range(4):
        for a, b in zip(mine[i][1:], ref[i][1:]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(RuntimeError, match="regenerate_fused"):
        mine.seg_view()[0]
    mm = mine.ensure_fused(32, 32)
    rm = ref.ensure_fused(32, 32)
    assert mm.shape == rm.shape == (4, 32, 32, 3) and mm.dtype == np.uint8
    assert mine.cache_path.name == ref.cache_path.name == "fused_train.u8"
    fused = np.random.default_rng(0).integers(0, 256, mm.shape,
                                              dtype=np.uint8)
    mm[:] = fused
    rm[:] = fused
    mm.flush()
    for i in range(4):
        a, b = mine.seg_view()[i], ref.seg_view()[i]
        np.testing.assert_array_equal(a[3], fused[i])
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    # a new run over the same dir reads the file; another geometry
    # recreates it
    again = streaming.StreamingFusionData(FusionFolderDataset(train),
                                          tmp_path / "a", "train")
    np.testing.assert_array_equal(again.ensure_fused(32, 32), fused)
    bigger = streaming.StreamingFusionData(FusionFolderDataset(train),
                                           tmp_path / "a", "train")
    assert bigger.ensure_fused(40, 48).shape == (4, 40, 48, 3)
    assert bigger.cache_path.stat().st_size == 4 * 40 * 48 * 3
    with pytest.raises(AttributeError):
        streaming.StreamingFusionData(SyntheticFusionDataset(2, (8, 8)),
                                      tmp_path / "c").sample_paths()


def _round(ckpt, folders, stream, native_loader=False):
    cfg = tiny_cfg(ckpt, streaming=stream, dump_fused_images=True,
                   native_loader=native_loader)
    t = interactive.InteractiveTrainer(
        cfg, *(FusionFolderDataset(r) for r in folders), device="cpu")
    return t, t.run()


def test_streaming_round_equals_the_in_memory_round(folders, tmp_path):
    mem, mem_res = _round(tmp_path / "mem", folders, False)
    st, st_res = _round(tmp_path / "st", folders, True)
    assert isinstance(st.train_data, streaming.StreamingFusionData)
    assert st.fusion_loss_history == mem.fusion_loss_history
    assert st.seg_loss_history == mem.seg_loss_history
    assert st_res == mem_res and 0.0 <= st_res["best_mIoU"] <= 1.0
    for split in ("train_data", "val_data"):
        a, b = getattr(st, split).fused, getattr(mem, split).fused
        assert isinstance(a, np.memmap) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose([v for _, v in st.ssim_history],
                               [v for _, v in mem.ssim_history], rtol=1e-6)
    for t, root in ((st, tmp_path / "st"), (mem, tmp_path / "mem")):
        for tag, n in (("train", 4), ("val", 2)):
            dumped = load_fused_dir(root / f"fused_{tag}_r1")
            assert dumped.shape == (n, 32, 32, 3)
    np.testing.assert_array_equal(load_fused_dir(tmp_path / "st" /
                                                 "fused_val_r1"),
                                  load_fused_dir(tmp_path / "mem" /
                                                 "fused_val_r1"))


def test_streaming_round_reads_through_the_native_loader(folders, tmp_path,
                                                         monkeypatch):
    readers = []
    real = interactive.Prefetcher

    def recording(*args, **kwargs):
        pf = real(*args, **kwargs)
        readers.append(pf._native is not None)
        return pf

    monkeypatch.setattr(interactive, "Prefetcher", recording)
    t, res = _round(tmp_path, folders, True, native_loader=True)
    assert readers == [True, False]   # the fusion phase; the seg view
    assert all(np.isfinite(v) for _, _, v in t.fusion_loss_history)
    assert 0.0 <= res["best_mIoU"] <= 1.0


def _one_thread_loader(module, monkeypatch):
    real = module.NativeLoader

    class OneThread(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **{**kwargs, "num_threads": 1})

    monkeypatch.setattr(module, "NativeLoader", OneThread)


def test_one_streaming_round_matches_jax_f64(folders, tmp_path,
                                             monkeypatch):
    _one_thread_loader(native, monkeypatch)
    _one_thread_loader(jax_native, monkeypatch)
    run_round(tmp_path, monkeypatch,
              [jax_datasets.FusionFolderDataset(r) for r in folders],
              [FusionFolderDataset(r) for r in folders], streaming=True)
