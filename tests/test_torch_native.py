"""The port's ctypes binding of runtime/dataloader.cpp
(``segmif_tpu_torch.data.native``) against the JAX package's binding of
the same source, and the ``Prefetcher``'s native path:

 - ``probe_image``, ``decode_image`` (PNG gray / RGB / RGBA and JPEG, with
   and without the bilinear resize) and ``NativeLoader`` batches (one
   thread, the same seed) equal the JAX binding's bit for bit;
 - the port builds its own library (``data/build/<hash>/``), never the
   JAX tests' ``runtime/libsegmif_io.so``, and processes building at once
   all load a complete library;
 - the native ``Prefetcher`` gives the JAX native ``Prefetcher``'s
   batches (uint8 images where JAX has float32, the same values);
   ``start_batch`` takes the Python readers; a dataset without paths
   takes them too;
 - a planted build failure makes ``available()`` False with the
   compiler's message kept, and a ``Prefetcher`` asked for the native
   loader raises, naming it, instead of falling back.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from segmif_tpu.data import native as jax_native
from segmif_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from segmif_tpu.eval.image_io import save_png
from segmif_tpu_torch.data import datasets, native
from segmif_tpu_torch.data.datasets import (FusionFolderDataset,
                                            SyntheticFusionDataset)
from segmif_tpu_torch.data.pipeline import Prefetcher

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    files = {}
    for name, shape in (("gray.png", (18, 26)), ("rgb.png", (18, 26, 3)),
                        ("rgba.png", (18, 26, 4))):
        files[name] = rng.integers(0, 256, shape, dtype=np.uint8)
        save_png(d / name, files[name])
    Image.fromarray(rng.integers(0, 256, (18, 26, 3), dtype=np.uint8)).save(
        d / "photo.jpg", quality=90)
    return d, files


def _folder(root, n=6, size=(16, 24)):
    src = SyntheticFusionDataset(n=n, size=size, seed=3)
    for i in range(n):
        name, ir, vis, g, lab = src[i]
        for d, a in (("Infrared", ir[..., 0]), ("Visible", vis),
                     ("Mask2", g), ("Label", lab)):
            save_png(root / d / name, a.astype(np.uint8))
    return FusionFolderDataset(root)


def test_builds_its_own_library():
    assert native.available(), native.build_error()
    path = native._lib_path()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert native.SOURCE == ROOT / "runtime" / "dataloader.cpp"
    assert Path(native._load()._name) == path


@pytest.mark.parametrize("name", ["gray.png", "rgb.png", "rgba.png",
                                  "photo.jpg"])
def test_probe_and_decode_equal_jax(images, name):
    d, files = images
    p = d / name
    assert native.probe_image(p) == jax_native.probe_image(p)
    for channels in (1, 3):
        for size in (None, (9, 13), (30, 40)):
            got = native.decode_image(p, size=size, channels=channels)
            want = jax_native.decode_image(p, size=size, channels=channels)
            assert got.dtype == want.dtype == np.float32
            assert got.tobytes() == want.tobytes(), (channels, size)
    if name in files and files[name].ndim == 3:
        np.testing.assert_array_equal(native.decode_image(p),
                                      files[name][..., :3])


def test_decode_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    for fn in (native.probe_image, native.decode_image):
        with pytest.raises(IOError):
            fn(bad)


def test_native_loader_equals_jax(tmp_path):
    ds = _folder(tmp_path)
    paths = ds.sample_paths()
    mine = native.NativeLoader(paths, 2, (16, 24), num_threads=1, seed=5,
                               resize=False)
    ref = jax_native.NativeLoader(paths, 2, (16, 24), num_threads=1,
                                  seed=5, resize=False)
    for a, b, _ in zip(mine, ref, range(7)):   # past an epoch boundary
        assert a.shape == (2, 4, 16, 24, 3)
        assert a.tobytes() == b.tobytes()
    mine.close()
    ref.close()


def test_prefetcher_native_path_equals_jax(tmp_path):
    ds = _folder(tmp_path)
    pf = Prefetcher(ds, 2, seed=4, num_threads=1)
    ref = JaxPrefetcher(ds, 2, seed=4, num_threads=1, use_native=True)
    assert pf._native is not None and ref._native is not None
    for a, b, _ in zip(pf, ref, range(5)):
        assert a["ir"].dtype == np.uint8 and b["ir"].dtype == np.float32
        assert a["label"].dtype == b["label"].dtype == np.int32
        for k in ("ir", "vis", "guide", "label"):
            assert a[k].flags.c_contiguous
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pf.close()
    ref.close()


def test_start_batch_and_pathless_data_take_the_python_readers(tmp_path):
    ds = _folder(tmp_path)
    resumed = Prefetcher(ds, 2, seed=4, start_batch=1)
    assert resumed._native is None
    python = Prefetcher(ds, 2, seed=4, use_native=False)
    assert python._native is None
    it = iter(python)
    next(it)
    got, want = next(iter(resumed)), next(it)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    resumed.close()
    python.close()
    synthetic = Prefetcher(SyntheticFusionDataset(4, (8, 8)), 2)
    assert synthetic._native is None
    synthetic.close()


def test_planted_build_failure_raises_and_does_not_fall_back(tmp_path,
                                                             monkeypatch):
    broken = tmp_path / "dataloader.cpp"
    broken.write_text('#include "no_such_header_anywhere.h"\n')
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(datasets, "_native_mod", None)   # a new process's
    monkeypatch.setattr(datasets, "_native_checked", False)
    assert not native.available()
    assert "no_such_header_anywhere.h" in native.build_error()
    assert not list((tmp_path / "build").rglob("*.so*"))
    with pytest.raises(native.NativeUnavailable, match="did not build"):
        native.decode_image(tmp_path / "x.png")
    ds = _folder(tmp_path / "data")
    with pytest.raises(RuntimeError, match="use_native=False") as e:
        Prefetcher(ds, 2)
    assert "no_such_header_anywhere.h" in str(e.value)
    pf = Prefetcher(ds, 2, use_native=False)   # per file through PIL
    assert next(iter(pf))["ir"].shape == (2, 16, 24, 3)
    pf.close()
    assert datasets._native() is None


def test_a_failed_read_reaches_the_consumer(tmp_path):
    ds = _folder(tmp_path)
    (tmp_path / "Label" / ds.names[0]).unlink()
    pf = Prefetcher(ds, len(ds), use_native=False)
    with pytest.raises(RuntimeError, match="reader thread failed") as e:
        next(iter(pf))
    assert isinstance(e.value.__cause__, FileNotFoundError)
    pf.close()


def test_concurrent_builds_each_load_a_complete_library(tmp_path):
    """Three processes build into one empty build dir at once: each
    compiles under its own temporary name and renames it into place, so
    every one loads a complete library and decodes."""
    png = tmp_path / "x.png"
    save_png(png, np.arange(12, dtype=np.uint8).reshape(3, 4))
    code = (
        "import sys; from pathlib import Path\n"
        "from segmif_tpu_torch.data import native\n"
        f"native.BUILD_ROOT = Path({str(tmp_path / 'build')!r})\n"
        f"a = native.decode_image({str(png)!r}, channels=1)\n"
        "print(int(a.sum()))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert [o.strip() for o, _ in outs] == [str(sum(range(12)))] * 3
    built = list((tmp_path / "build").rglob("*"))
    assert [p.name for p in built if p.is_file()] == [native.LIB_NAME]
