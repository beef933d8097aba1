"""The interactive trainer under tensor parallelism and streaming under
data parallelism, on gloo CPU ranks (mit_b0, synthetic 32x32 data, f64):

 - one round of ``InteractiveTrainer.run()`` with ``mesh_model`` 2 on 2
   ranks (2 fusion iterations, the regeneration, 2 seg iterations and the
   eval, batches of 2, the model split over the two ranks) against the
   same run in one process: the logged losses within rtol 1e-9, the val
   SSIM and the mIoU history equal, the fusion and seg weights and
   BatchNorm buffers, gathered whole, within 1e-7 of each leaf's largest
   magnitude (the leaves whose exact gradient is zero are not compared,
   as in test_torch_parallel_trainer.py); both ranks' weights the same
   bit for bit; rank 0 alone writes, and the role checkpoints hold one
   process's layout;
 - the same run stopped on both ranks right after the fusion phase's
   first mid-phase checkpoint (the split state gathered into it) and
   resumed by new trainers ends where the uninterrupted run ends, bit for
   bit;
 - one streaming round (PNG folders, Python readers) on 2 data-parallel
   ranks against one process: the same losses, SSIM, mIoU and weights
   (the limits above), and the fused memmaps that rank 0 wrote and both
   ranks read equal to one process's, byte for byte.
"""
import json

import numpy as np
import pytest
import torch

import parallel_ranks as pr
from segmif_tpu_torch.disk_check import write_folder
from segmif_tpu_torch.models.network import JointPipeline
from segmif_tpu_torch.parallel import dist
from segmif_tpu_torch.train.compare import exact_zero_grad
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

LAUNCH_S = 300


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = pr.trainer_runs(None, tmp_path_factory.mktemp("one"),
                              tmp_path_factory.mktemp("one_b"))
    finally:
        torch.set_num_threads(threads)
    a, b = tmp_path_factory.mktemp("tp_a"), tmp_path_factory.mktemp("tp_b")
    ranks = dist.launch(pr.trainer_runs, 2, (str(a), str(b), 2),
                        timeout=LAUNCH_S, threads=1,
                        workdir=str(tmp_path_factory.mktemp("r")))
    return one, ranks, a


def _weights(run):
    return {f"{m}.{k}": v for m in ("fusion", "seg")
            for k, v in run[m].items()}


def _close_to_one(got, want):
    for key in ("fusion_loss", "seg_loss"):
        w, g = np.array(want[key]), np.array(got[key])
        assert w.shape == g.shape and len(w) > 0, key
        np.testing.assert_allclose(g, w, rtol=1e-9, err_msg=key)
    assert got["ssim"] == pytest.approx(want["ssim"], rel=1e-9)
    assert got["result"] == want["result"]
    ww, gw = _weights(want), _weights(got)
    assert set(ww) == set(gw)
    for k, v in ww.items():
        assert gw[k].shape == v.shape, k
        if v.dtype.kind == "f" and not exact_zero_grad(k):
            np.testing.assert_allclose(gw[k], v, rtol=0,
                                       atol=1e-7 * np.abs(v).max(),
                                       err_msg=k)


def test_tp_round_matches_one_process(runs):
    one, ranks, _ = runs
    _close_to_one(ranks[0][0], one[0])
    other, mine = _weights(ranks[1][0]), _weights(ranks[0][0])
    for k, v in mine.items():
        np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_tp_rank_0_writes_one_process_layout(runs):
    _, ranks, ckpt = runs
    assert ranks[0][0]["writes"]["role"] > 0
    assert ranks[1][1]["writes"] == {"role": 0, "phase": 0}
    assert json.loads((ckpt / "progress.json").read_text())[
        "next_round"] == 2
    whole = JointPipeline("mit_b0", num_classes=9)
    for role, name in (("fusion", "fusion_params.pth"),
                       ("seg", "seg_params.pth")):
        sd = torch.load(ckpt / name, weights_only=True)
        want = getattr(whole, role).state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


def test_tp_resume_matches_uninterrupted(runs):
    _, ranks, _ = runs
    for run, resumed in ranks:
        want, got = _weights(run), _weights(resumed)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert resumed["result"]["best_mIoU"] == run["result"]["best_mIoU"]


def test_streaming_under_dp_matches_one_process(tmp_path):
    roots = [tmp_path / "train", tmp_path / "val"]
    write_folder(roots[0], 4, (32, 32), seed=0)
    write_folder(roots[1], 2, (32, 32), seed=1)
    args = [str(r) for r in roots]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = pr.streaming_run(None, *args, str(tmp_path / "one"))
    finally:
        torch.set_num_threads(threads)
    (tmp_path / "r").mkdir()
    ranks = dist.launch(pr.streaming_run, 2, (*args, str(tmp_path / "dp")),
                        timeout=LAUNCH_S, threads=1,
                        workdir=str(tmp_path / "r"))
    for got in ranks:
        _close_to_one(got, one)
        for a, b in zip(got["fused"], one["fused"]):
            assert a.tobytes() == b.tobytes()
    assert (tmp_path / "dp" / "fused_train.u8").exists()


def test_dryrun_four_ranks_splits_the_model(tmp_path):
    """The dry run on 4 ranks takes the JAX mesh, data 2 x model 2, and
    reads what the 2 data-parallel ranks read."""
    from segmif_tpu_torch.parallel import dryrun

    lines = {n: dist.launch(dryrun._rank, n, (None,), timeout=LAUNCH_S,
                            threads=1, workdir=str(tmp_path))
             for n in (2, 4)}
    assert len(set(lines[4])) == 1
    assert lines[4][0].startswith("dryrun OK on 4 ranks (gloo on cpu; mesh "
                                  "data=2, model=2): ")
    assert lines[4][0].split("): ")[1] == lines[2][0].split("): ")[1]
