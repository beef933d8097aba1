"""The port's export CLI (``python -m segmif_tpu_torch.cli.export``) on the
CPU at mit_b0 32x32, and a ``.pt2`` loaded in a fresh process: the
counterpart of ``tests/test_serving.py::test_export_cli``; the static
guide, int8 with the calibration fallback and fuse-only through the CLI,
against ``make_serving_fn`` built the way the CLI builds it (bit for bit);
``--platforms`` refused. The fresh-process load is in
``test_torch_export_load.py``.
"""
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (autouse fixture)
from segmif_tpu_torch import serving
from segmif_tpu_torch.cli import export
from segmif_tpu_torch.cli.test_fusion import build_model
from segmif_tpu_torch.eval.image_io import save_png

SMALL = ["--backbone", "mit_b0", "--batch", "1", "--height", "32",
         "--width", "32", "--device", "cpu"]


def test_export_cli(tmp_path):
    out = tmp_path / "cli_artifact.pt2"
    specs = export.main(["--out", str(out)] + SMALL)
    assert out.exists() and out.stat().st_size > 0
    assert specs == (((1, 32, 32, 1), "float32"), ((1, 32, 32, 3), "float32"))
    fn = serving.load_serving_artifact(out)
    fused_rgb, pred = fn(torch.zeros((1, 32, 32, 1)),
                         torch.zeros((1, 32, 32, 3)))
    assert fused_rgb.shape == (1, 32, 32, 3) and pred.shape == (1, 32, 32)


def test_export_cli_static_guide_int8_fuse_only(tmp_path):
    """--static_guide --int8 (no calibration images: the fallback
    calibrates on the guide with uniform-noise IR) --fuse_only: the
    program equals the in-process serving closure built the same way."""
    rng = np.random.default_rng(11)
    guide = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    save_png(tmp_path / "guide.png", guide)
    out = tmp_path / "art.pt2"
    export.main(["--out", str(out), "--static_guide",
                 str(tmp_path / "guide.png"), "--int8", "--fuse_only"]
                + SMALL)
    fn = serving.load_serving_artifact(out)
    assert serving.segmif_nodes(fn) == {"drdb_int8_growth": 4,
                                        "drdb_int8_tail": 4}
    g = torch.from_numpy(guide.astype(np.float32) / 255.0)[None]
    cal = np.random.default_rng(0)
    ir_cal = torch.from_numpy(cal.uniform(0, 1, (1, 32, 32, 1))
                              .astype(np.float32))
    serve = serving.make_serving_fn(
        build_model("mit_b0", 9), guide_rgb=g, with_seg=False,
        int8_calibration=(ir_cal, g), device="cpu")
    ir = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 1))
                          .astype(np.float32))
    vis = torch.from_numpy(rng.uniform(0, 1, (1, 32, 32, 3))
                           .astype(np.float32))
    assert torch.equal(fn(ir, vis), serve(ir, vis))


def test_export_cli_refuses_platforms(tmp_path):
    with pytest.raises(ValueError, match="runs on the device it was "
                                         "exported for"):
        export.main(["--out", str(tmp_path / "x.pt2"), "--platforms",
                     "tpu,cpu"] + SMALL)
