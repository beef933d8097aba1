"""The port's inference CLIs and checkpoint key check on the CPU, against
the JAX package's CLIs (mit_b0; 5 pairs at 32x32 written with the JAX
package's ``save_png``; weights at the reference modules' scale, saved as
the port's ``state_dict``s, which are the reference ``.pth`` layout):

 - ``cli.test_fusion``: the JAX CLI reads the files through
   ``--torch_fusion_ckpt`` / ``--torch_seg_ckpt`` and converts them, the
   port's reads the same files as they are; their PNGs differ on at most
   0.1% of the bytes, in both quantisation modes and with
   ``--static_guide``, by at most one level with a single rounding and 4
   with the reference's. Why: the two fused arrays differ by f32 sums in
   other orders (about 1e-6), and a value within that of a level boundary
   truncates to either side; the reference's double quantisation then
   stretches that one-level step by 255 / (max - min) of the batch's
   truncated values (a step of 3 was read here; 4 holds for any batch
   spanning more than 85 levels). 6.5e-5 of the bytes differed in each
   mode that differed at all.
 - ``cli.test_segmentation`` on the same fused folder: the two tables'
   per-class IoU and precision within 1e-2 and the mIoU within 1e-2
   (predictions at argmax near-ties of random weights may go the other
   way on a few of the 5120 pixels; a pixel moves an IoU by about 1e-3),
   the same lines printed.
 - ``cli.convert_checkpoint``: passes on good files, fails (exit 1) on a
   renamed key, a file of another width and an encoder checkpoint that
   lacks a key, and lets an encoder's ``head.*`` through.
 - ``--spatial N`` is refused where a rank would hold fewer than 16 of
   an image's rows (``--spatial 2`` on CPU ranks is in
   ``test_torch_spatial_cli.py``); without a card and without ``--device
   cpu`` the CLIs raise.
 - ``cli.train --data_root`` runs one tiny round from folders, in memory
   and ``--streaming``.
 - ``segmif_tpu_torch.disk_check`` (chip_smoke.py's phase 10) on the CPU at
   a small size: every check holds, and each planted fault fails one.
"""
import numpy as np
import pytest
import torch

from segmif_tpu.cli import test_fusion as jax_test_fusion
from segmif_tpu.cli import test_segmentation as jax_test_segmentation
from segmif_tpu.data.datasets import SyntheticFusionDataset
from segmif_tpu.eval.image_io import save_png
from segmif_tpu_torch import disk_check
from segmif_tpu_torch.cli import convert_checkpoint, test_fusion
from segmif_tpu_torch.cli import test_segmentation
from segmif_tpu_torch.cli import train as cli_train
from segmif_tpu_torch.data.datasets import FusionFolderDataset
from segmif_tpu_torch.drift import init_reference_scale
from segmif_tpu_torch.eval.image_io import load_fused_dir
from segmif_tpu_torch.models.network import JointPipeline
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

PNG_SHARE = 1e-3
PNG_LEVELS = {False: 1, True: 4}   # by --reference_quantization
SEG_ATOL = 1e-2


def _write(root, n, seed, size=(32, 32)):
    src = SyntheticFusionDataset(n=n, size=size, seed=seed)
    for i in range(n):
        _, ir, vis, g, lab = src[i]
        name = f"pair{i}.png"
        for d, a in (("Infrared", ir[..., 0]), ("Visible", vis),
                     ("Mask2", g), ("Label", lab)):
            save_png(root / d / name, a.astype(np.uint8))
    return root


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    model = JointPipeline("mit_b0")
    with torch.no_grad():
        init_reference_scale(model, torch.Generator().manual_seed(3))
    torch.save(model.fusion.state_dict(), d / "fusion.pth")
    torch.save(model.seg.state_dict(), d / "seg.pth")
    return {"dir": d, "data": _write(d / "test_all", 5, 1),
            "train": _write(d / "train_all", 4, 0)}


def _fusion_args(s, out, extra=()):
    d = s["dir"]
    return ["--data_root", str(s["data"]), "--out_dir", str(out),
            "--checkpoint_dir", str(d / "none"), "--torch_fusion_ckpt",
            str(d / "fusion.pth"), "--torch_seg_ckpt", str(d / "seg.pth"),
            "--backbone", "mit_b0", "-B", "2"] + list(extra)


@pytest.mark.parametrize("extra", [
    [], ["--reference_quantization"],
    ["--static_guide", "STATIC", "--reference_quantization"]])
def test_test_fusion_equals_jax(setup, tmp_path, extra):
    guide = str(setup["data"] / "Mask2" / "pair3.png")
    extra = [guide if a == "STATIC" else a for a in extra]
    names = test_fusion.main(_fusion_args(setup, tmp_path / "port", extra)
                             + ["--device", "cpu"])
    jax_test_fusion.main(_fusion_args(setup, tmp_path / "jax", extra))
    assert names == [f"pair{i}.png" for i in range(5)]
    got, want = (np.rint(load_fused_dir(tmp_path / d) * 255)
                 for d in ("port", "jax"))
    assert got.shape == want.shape == (5, 32, 32, 3)
    assert np.abs(got - want).max() <= PNG_LEVELS[
        "--reference_quantization" in extra]
    assert (got != want).mean() <= PNG_SHARE
    assert got.std() > 10   # real images, not a constant


def test_test_segmentation_equals_jax(setup, tmp_path, capsys):
    test_fusion.main(_fusion_args(setup, tmp_path / "fused")
                     + ["--device", "cpu"])
    args = ["--fused_dir", str(tmp_path / "fused"), "--label_dir",
            str(setup["data"] / "Label"), "--checkpoint_dir",
            str(tmp_path / "none"), "--torch_seg_ckpt",
            str(setup["dir"] / "seg.pth"), "--backbone", "mit_b0", "-B",
            "2"]
    capsys.readouterr()
    got = test_segmentation.main(args + ["--device", "cpu", "--log_file",
                                         str(tmp_path / "port.txt")])
    port_out = capsys.readouterr().out
    want = jax_test_segmentation.main(args + ["--log_file",
                                              str(tmp_path / "jax.txt")])
    jax_out = capsys.readouterr().out
    assert got["confusion"].sum() == want["confusion"].sum() == 5 * 32 * 32
    for k in ("iou", "precision"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SEG_ATOL,
                                   err_msg=k)
    assert abs(got["mIoU"] - want["mIoU"]) <= SEG_ATOL
    table = [ln.split()[0] for ln in port_out.splitlines()]
    assert table == [ln.split()[0] for ln in jax_out.splitlines()
                     if ln.split()]
    assert table[:2] == ["class", "unlabeled"] and table[-1] == "mIoU"
    assert (tmp_path / "port.txt").read_text().startswith("== ")


def test_cli_refusals(setup, tmp_path):
    # 4 ranks would hold 8 of the images' 32 rows each, fewer than the
    # halo: refused before any rank is spawned
    with pytest.raises(ValueError, match="rows per shard 8 < halo 16"):
        test_fusion.main(_fusion_args(setup, tmp_path, ["--spatial", "4"])
                         + ["--device", "cpu"])
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_fusion.main(_fusion_args(setup, tmp_path))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_segmentation.main(["--fused_dir", str(tmp_path),
                                    "--label_dir", str(tmp_path)])


def test_convert_checkpoint_key_check(setup, tmp_path, capsys):
    d = setup["dir"]
    good = ["--torch_fusion_ckpt", str(d / "fusion.pth"), "--torch_seg_ckpt",
            str(d / "seg.pth"), "--backbone", "mit_b0"]
    assert convert_checkpoint.main(good) == 0
    assert capsys.readouterr().out.count("matches") == 2
    sd = torch.load(d / "seg.pth", weights_only=True)
    sd["denoise_net.classifier.renamed"] = sd.pop(
        "denoise_net.classifier.weight")
    torch.save(sd, tmp_path / "renamed.pth")
    assert convert_checkpoint.main(["--torch_seg_ckpt",
                                    str(tmp_path / "renamed.pth"),
                                    "--backbone", "mit_b0"]) == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out
    assert "missing: denoise_net.classifier.weight" in out
    assert "unexpected: denoise_net.classifier.renamed" in out
    # the fusion's tap projections and the seg net are sized by the
    # backbone: mit_b0 files against mit_b1 modules
    assert convert_checkpoint.main(good[:2] + ["--backbone", "mit_b1"]) == 1
    assert "shape: conv3.weight" in capsys.readouterr().out
    assert convert_checkpoint.main(good[2:4] + ["--backbone", "mit_b1"]) == 1
    assert "shape: " in capsys.readouterr().out
    enc = JointPipeline("mit_b0").seg.denoise_net.encoder.state_dict()
    enc["head.weight"] = torch.zeros(3)
    torch.save(enc, tmp_path / "enc.pth")
    assert convert_checkpoint.main(["--torch_encoder_ckpt",
                                    str(tmp_path / "enc.pth"), "--backbone",
                                    "mit_b0"]) == 0
    del enc["block1.0.attn.q.weight"]
    torch.save(enc, tmp_path / "enc.pth")
    assert convert_checkpoint.main(["--torch_encoder_ckpt",
                                    str(tmp_path / "enc.pth"), "--backbone",
                                    "mit_b0"]) == 1
    with pytest.raises(SystemExit):
        convert_checkpoint.main([])


@pytest.mark.parametrize("extra", [[], ["--streaming"]])
def test_cli_train_on_folders(setup, tmp_path, extra):
    args = ["--data_root", str(setup["train"]), "--val_root",
            str(setup["data"]), "--crop_size", "32", "--backbone", "mit_b0",
            "--rounds", "1", "--fusion_iters", "1", "--seg_iters", "1",
            "--checkpoint_dir", str(tmp_path), "--device", "cpu"] + extra
    result = cli_train.main(args)
    assert 0.0 <= result["best_mIoU"] <= 1.0
    log = (tmp_path / "train.log").read_text()
    assert "folder data: 4 training pairs" in log
    assert ("native C++ loader" in log) == bool(extra)
    assert (tmp_path / "fused_val.u8").exists() == bool(extra)
    assert (tmp_path / "fusion_params.pth").exists()


def test_disk_to_disk_checks_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 10 (a)-(d) and its planted faults, through
    ``disk_check``, at mit_b0 32x48 with 12 training and 5 val pairs."""
    dc = disk_check
    train = dc.write_folder(tmp_path / "train", 12, (32, 48), 0)
    val = dc.write_folder(tmp_path / "val", 5, (32, 48), 1, rgb_labels=True)
    for w in (train, val):
        assert dc.folder_problems(FusionFolderDataset(w["root"]), w) == []
    dec = dc.decoder_checks([train, val], threads=2, repeats=1)
    assert dec["problems"] == [] and dec["native_error"] is None
    assert all(v > 0 for v in dec["rates"].values())
    ck = tmp_path / "ck"
    tr = dc.trainer_check(train, val, ck, "mit_b0", "float32", "cpu",
                          ["--fusion_iters", "1", "--seg_iters", "1",
                           "--crop_size", "32"])
    assert tr["problems"] == [] and tr["fresh"] == {"share": 0.0, "max": 0}
    guide = val["root"] / "Mask2" / "frame0.png"
    fd = dc.fusion_cli_check(val, tmp_path / "fused", ck, "mit_b0", 2,
                             "float32", "cpu")
    fs = dc.fusion_cli_check(val, tmp_path / "static", ck, "mit_b0", 2,
                             "float32", "cpu", static_guide=guide,
                             reference_quantization=True)
    assert fd["problems"] == fs["problems"] == []
    assert not np.array_equal(fd["pngs"], fs["pngs"])
    sg = dc.segmentation_cli_check(tmp_path / "fused", val, ck, "mit_b0", 2,
                                   "float32", "cpu", tmp_path / "seg.txt")
    assert sg["problems"] == []
    faults = dc.planted_faults(train, val, tmp_path / "planted", ck,
                               "mit_b0", "float32", "cpu")
    assert set(faults) == {"label from channel 1",
                           "sorted, not natural order",
                           "padding in the stretch"}
    for fault, problems in faults.items():
        assert problems, fault
