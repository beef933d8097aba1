"""The interactive trainer and ``cli.train`` under data parallelism on
gloo CPU ranks (mit_b0, synthetic 32x32 data, f64):

 - one round of ``InteractiveTrainer.run()`` on 2 ranks (2 fusion
   iterations, the regeneration, 2 seg iterations and the eval; batches
   of 2, one row a rank) against the same run in one process: the logged
   losses within rtol 1e-9, the val SSIM and the mIoU history equal, the
   fusion and seg weights and BatchNorm buffers within 1e-7 of each
   leaf's largest magnitude (the leaves whose exact gradient is zero
   take +-lr AdamW steps on rounding noise: not compared); both ranks'
   weights the same, bit for bit;
 - only rank 0 writes the checkpoints;
 - the same run stopped on both ranks right after the fusion phase's
   first mid-phase checkpoint and resumed by new trainers ends where the
   uninterrupted 2-rank run ends, bit for bit;
 - ``cli.train --mesh_data 2 --device cpu`` spawns its two ranks and
   trains; ``cli.train --mesh_model 2`` spawns two ranks, trains with the
   model split over them, and writes role checkpoints in one process's
   layout that the JAX package's converters load (the seg network's
   logits within 2e-4 of the port's one-process network on the same
   file).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_ranks as pr
from segmif_tpu.models.network import \
    SegmentationNetwork as JaxSegmentationNetwork
from segmif_tpu.train.checkpoint import (load_torch_fusion_network,
                                         load_torch_seg_network)
from segmif_tpu_torch.cli import train as cli_train
from segmif_tpu_torch.models.network import JointPipeline
from segmif_tpu_torch.train.compare import exact_zero_grad
from segmif_tpu_torch.parallel import dist
from torch_threads import one_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = pr.trainer_runs(None, tmp_path_factory.mktemp("one"),
                              tmp_path_factory.mktemp("one_b"))
    finally:
        torch.set_num_threads(threads)
    a, b = tmp_path_factory.mktemp("dp_a"), tmp_path_factory.mktemp("dp_b")
    ranks = dist.launch(pr.trainer_runs, 2, (str(a), str(b)), timeout=300,
                        threads=1, workdir=str(tmp_path_factory.mktemp("r")))
    return one, ranks, a


def _weights(run):
    return {f"{m}.{k}": v for m in ("fusion", "seg")
            for k, v in run[m].items()}


def test_dp_round_matches_one_process(runs):
    one, ranks, _ = runs
    want, got = one[0], ranks[0][0]
    for key in ("fusion_loss", "seg_loss"):
        w, g = np.array(want[key]), np.array(got[key])
        assert w.shape == g.shape and len(w) > 0, key
        np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=key)
    assert got["ssim"] == pytest.approx(want["ssim"], rel=1e-9)
    assert got["result"] == want["result"]
    ww, gw = _weights(want), _weights(got)
    for k, v in ww.items():
        if v.dtype.kind == "f" and not exact_zero_grad(k):
            np.testing.assert_allclose(gw[k], v, rtol=0,
                                       atol=1e-7 * np.abs(v).max(),
                                       err_msg=k)
    other = _weights(ranks[1][0])
    for k, v in gw.items():
        np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_only_rank_0_writes(runs):
    _, ranks, ckpt = runs
    assert ranks[0][0]["writes"]["role"] > 0
    assert ranks[0][0]["writes"]["phase"] > 0
    assert ranks[1][1]["writes"] == {"role": 0, "phase": 0}
    assert json.loads((ckpt / "progress.json").read_text())[
        "next_round"] == 2
    assert (ckpt / "fusion_params.pth").exists()
    assert (ckpt / "seg_params.pth").exists()


def test_dp_resume_matches_uninterrupted(runs):
    _, ranks, _ = runs
    for r in ranks:
        run, resumed = r
        want, got = _weights(run), _weights(resumed)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert resumed["result"]["best_mIoU"] == run["result"]["best_mIoU"]


def test_cli_train_mesh_data_2(tmp_path):
    result = cli_train.main([
        "--synthetic", "4", "--synthetic_size", "32", "32", "--crop_size",
        "32", "--backbone", "mit_b0", "--rounds", "1", "--fusion_iters", "2",
        "--seg_iters", "2", "--checkpoint_dir", str(tmp_path), "--device",
        "cpu", "--mesh_data", "2"])
    assert 0.0 <= result["best_mIoU"] <= 1.0
    log = (tmp_path / "train.log").read_text()
    assert "training complete" in log
    assert (tmp_path / "seg_params.pth").exists()


def test_mesh_model_refused(tmp_path):
    """Once refused; now ``--mesh_model 2`` trains on 2 spawned ranks."""
    result = cli_train.main([
        "--synthetic", "4", "--synthetic_size", "32", "32", "--crop_size",
        "32", "--backbone", "mit_b0", "--rounds", "1", "--fusion_iters", "2",
        "--seg_iters", "2", "--checkpoint_dir", str(tmp_path), "--device",
        "cpu", "--mesh_model", "2"])
    assert 0.0 <= result["best_mIoU"] <= 1.0
    assert "training complete" in (tmp_path / "train.log").read_text()
    whole = JointPipeline("mit_b0", num_classes=9)
    for role, name in (("fusion", "fusion_params.pth"),
                       ("seg", "seg_params.pth")):
        getattr(whole, role).load_state_dict(
            torch.load(tmp_path / name, weights_only=True), strict=True)
    params, stats = load_torch_seg_network(tmp_path / "seg_params.pth")
    load_torch_fusion_network(tmp_path / "fusion_params.pth")
    img = torch.rand((1, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(0))
    with torch.no_grad():
        logits = whole.seg(img)
    want = JaxSegmentationNetwork("mit_b0", 9).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(img.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4)
