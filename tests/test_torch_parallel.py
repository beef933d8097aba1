"""Data parallelism of the port (``segmif_tpu_torch.parallel.mesh`` and the
steps' ``shard``) on gloo CPU ranks, in f64, mit_b0 at 32x32, against one
process on the whole batch (``dp_parity``'s comparison; every rank's
results the same, bit for bit):

 - 2 ranks: the seg step with drop-path, dropout and BatchNorm at a global
   batch of 4 (the second rank's labels all ignored); the fusion step
   (round >= 2) and the seg step at a batch of 3, which 2 does not
   divide (the JAX replicated fallback);
 - 4 ranks: the fusion step, rounds 1 and >= 2, and the seg step at a
   global batch of 8 (the last rank's labels all ignored);
 - planted faults fail the comparison: the CE averaged per rank instead
   of over the global count of valid pixels, and BatchNorm on each
   rank's own statistics (both on the seg step of 4);
 - ``fusion.grad_accum`` > 1 under data parallelism raises, as the JAX
   driver does.

The batches of 4 in both steps and both rounds, on 2 and 4 ranks, and
against JAX: ``test_torch_parallel_jax.py``.
"""
import dataclasses

import pytest
import torch

import dp_parity as dpp
import train_parity as tp
from segmif_tpu_torch.parallel.mesh import BatchShard
from segmif_tpu_torch.train.compare import KeepGrads
from segmif_tpu_torch.train.interactive import refuse_under_dp
from segmif_tpu_torch.train.state import FusionTrainState
from segmif_tpu_torch.train.steps import make_fusion_train_step
from test_torch_interactive import tiny_cfg
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

CASES2 = ["seg b4", "fusion r2 b3", "seg b3"]
CASES4 = ["fusion r1 b8", "fusion r2 b8", "seg b8"]
# each fault planted on the ranks of a case above
FAULTS = {"ce_per_rank": "seg b4", "bn_local": "seg b4"}


@pytest.fixture(scope="module")
def weights():
    return dpp.weights()


@pytest.fixture(scope="module")
def one(weights):
    return dpp.one_process(weights, CASES2 + CASES4)


@pytest.fixture(scope="module")
def dp2(weights, tmp_path_factory):
    return dpp.on_ranks(weights, 2, CASES2, str(tmp_path_factory.mktemp(
        "ranks")), faults=list(FAULTS.items()))


@pytest.fixture(scope="module")
def dp4(weights, tmp_path_factory):
    return dpp.on_ranks(weights, 4, CASES4, str(tmp_path_factory.mktemp(
        "ranks")))


@pytest.mark.parametrize("case", CASES2)
def test_dp2_matches_one_process(dp2, one, case):
    dpp.ranks_agree(dp2[case])
    dpp.check_one_process(dp2[case][0], one[case])


@pytest.mark.parametrize("case", CASES4)
def test_dp4_matches_one_process(dp4, one, case):
    dpp.ranks_agree(dp4[case])
    dpp.check_one_process(dp4[case][0], one[case])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail(dp2, one, fault):
    with pytest.raises(AssertionError):
        dpp.check_one_process(dp2["fault " + fault][0], one[FAULTS[fault]])


def test_grad_accum_refused_under_dp(weights, tmp_path):
    cfg = tiny_cfg(tmp_path)
    cfg.fusion = dataclasses.replace(cfg.fusion, grad_accum=2)
    with pytest.raises(ValueError, match="requires mesh_data == 1"):
        refuse_under_dp(cfg, 2)
    refuse_under_dp(cfg, 1)
    model = tp.port_model(weights[0])
    tx = KeepGrads()
    step = make_fusion_train_step(model, tx, False, grad_accum=2,
                                  compute_dtype=torch.float32, device="cpu")
    state = FusionTrainState.create(model.fusion, tx)
    shard = BatchShard(0, 2, 4, 0.5, comm=None)
    with pytest.raises(ValueError, match="data parallelism OR accumulation"):
        step(state, {}, 0.4, shard=shard)
