"""The CLIs with ``--spatial 2`` on two gloo CPU ranks that the CLIs spawn
themselves (mit_b0, f32, seeded random weights), and the multi-rank dry
run (``parallel.dryrun``) on 2 ranks:

 - ``cli.test_fusion --spatial 2`` on a folder of two 64x48 pairs writes
   the fused PNGs that ``--spatial 0`` (the plain fuse) writes, within one
   level of 255 (the row split sums the FFM grams in another order, and
   a pixel at a rounding boundary may quantise one level apart);
 - ``cli.stretch --spatial 2 --synthetic`` at 64x64 returns rank 0's
   fused image and logits, within 1e-4 of ``--spatial 1``'s (the fused
   RGB in [0, 1]; the logits relative to their largest magnitude): the
   seeded weights are not at the reference scale, and their fused Y
   reaches tens before the clip, so f32 sums in another order move it by
   about 1e-6 of that.
"""
import numpy as np
import pytest

from segmif_tpu_torch.cli import stretch, test_fusion
from segmif_tpu_torch.parallel import dist, dryrun
from segmif_tpu_torch.eval.image_io import save_png
from segmif_tpu_torch.data.datasets import _load_image
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

SMALL = ["--config", "configs/stretch_1080p.yaml", "--backbone", "mit_b0",
         "--device", "cpu"]


def test_test_fusion_spatial_2(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "test_all"
    names = ["a.png", "b.png"]
    for n in names:
        for d, c in (("Infrared", 1), ("Visible", 3), ("Mask2", 3),
                     ("Label", 1)):
            a = rng.integers(0, 9 if d == "Label" else 256, (64, 48, c))
            save_png(root / d / n, a.astype(np.uint8)[..., 0] if c == 1
                     else a.astype(np.uint8))
    common = ["--data_root", str(root), "--backbone", "mit_b0", "-B", "2",
              "--checkpoint_dir", str(tmp_path / "none"), "--device", "cpu"]
    out = {}
    for n in (0, 2):
        out[n] = tmp_path / f"fused{n}"
        got = test_fusion.main(common + ["--out_dir", str(out[n]),
                                         "--spatial", str(n)])
        assert got == names
    for n in names:
        a = _load_image(out[0] / n).astype(np.int32)
        b = _load_image(out[2] / n).astype(np.int32)
        assert a.shape == b.shape == (64, 48, 3)
        assert np.abs(a - b).max() <= 1, n


def test_stretch_spatial_2():
    args = SMALL + ["--synthetic", "--size", "64", "64"]
    fused, logits = stretch.main(args + ["--spatial", "2"])
    want_fused, want_logits = stretch.main(args + ["--spatial", "1"])
    assert fused.shape == want_fused.shape == (1, 64, 64, 3)
    assert logits.shape == want_logits.shape == (1, 16, 16, 15)
    np.testing.assert_allclose(fused.numpy(), want_fused.numpy(), rtol=0,
                               atol=1e-4)
    scale = np.abs(want_logits.numpy()).max()
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), rtol=0,
                               atol=1e-4 * scale)


def test_spatial_refused_with_static_guide(tmp_path):
    with pytest.raises(ValueError, match="not taken with --spatial"):
        test_fusion.main(["--data_root", str(tmp_path), "--spatial", "2",
                          "--static_guide", "x.png", "--device", "cpu"])


def test_dryrun_two_ranks(tmp_path):
    line = dist.launch(dryrun._rank, 2, (None,), timeout=240, threads=1,
                       workdir=str(tmp_path))
    assert line[0] == line[1]
    assert line[0].startswith("dryrun OK on 2 ranks (gloo on cpu")
    assert "mesh data=2, model=1" in line[0]
    assert "spatial fused (1, 64, 64, 1)" in line[0]
