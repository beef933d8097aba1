"""Data parallelism of the port in f32 on 2 gloo CPU ranks, one row each,
against the JAX single-device step at the f32 parity tests' tolerances
and data seeds:

 - the fusion step, rounds 1 and >= 2 (``train_parity``, data seed 9,
   batch 2): the losses within rtol 1e-4, every gradient leaf within 1e-3
   of its largest magnitude (+1e-7), the DWA state within 1e-6;
 - round 1 on the harness's own data seed 13 against the port's
   one-process step with ``grad_accum=2``, which computes the same mean
   on micro-batches of one row, a rank's shapes: every gradient leaf
   within 1e-6 of its largest magnitude;
 - the seg step without drop-path and dropout (``seg_parity``, data seed
   3, batch 2): the loss within rtol 1e-5, every gradient leaf within 1e-3
   of its largest magnitude (the exact-zero leaves within 1e-6 of the
   largest gradient), the BatchNorm buffers within 1e-5 of each buffer's
   largest magnitude;
 - both ranks' results the same, bit for bit.
"""
import numpy as np
import pytest
import torch

import parallel_ranks as pr
import seg_parity as sp
import train_parity as tp
from segmif_tpu_torch.parallel import dist
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

SEG_SEED = 3
# The fusion step's data seed against JAX. In f32 a relu input within
# rounding of zero takes the other branch where two computations round
# differently, and a rank computes on a batch of 1 where one process
# computes on 2. ``tests/f32_seed_scan.py`` over seeds 1-20, both round
# kinds: the one-process step holds 1e-3 against JAX on 29 of the 40
# (seed, round) pairs, which is why train_parity takes seed 13, and the
# 2-rank step on 28; the 2-rank step against the one-process step fails
# on seeds 4, 5, 7, 8, 11, 13 and 16 (on seed 13, 8.9e-3 of DRDB4.Dcov2's
# largest gradient), and in round 1 it equals the one-process step with
# ``grad_accum=2`` (a rank's shapes, no ranks) within 4e-42 on all 20:
# the flips come from the batch-1 shapes, not the ranks. So the JAX
# comparison runs on a seed where neither side flips (9), and round 1 on
# seed 13 is held to the accumulated step; the f64 comparison
# (test_torch_parallel.py) holds the step on any data.
FUSION_SEED = 9
HARNESS_SEED = tp.DATA_SEED


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the ranks' results) of the three steps."""
    model, variables = tp.jax_variables()
    fusion_data = tp.batch(FUSION_SEED)
    want = {r1: tp.run_jax(model, variables, fusion_data, r1, 1)
            for r1 in (True, False)}
    with pytest.MonkeyPatch.context() as mp:
        sp.no_regularisers(mp)
        seg_model, seg_vars = sp.jax_variables()
        seg_data = sp.batch(SEG_SEED)
        want["seg"] = sp.run_jax(seg_model, seg_vars, seg_data, False)
    joint = pr.state_dict_numpy(tp.port_model(variables))
    seg_sd = pr.state_dict_numpy(sp.port_model(seg_vars))
    cases = [dict(kind="fusion", sd=joint, dtype="float32",
                  data=fusion_data, round1=r1) for r1 in (True, False)]
    cases.append(dict(kind="seg", sd=seg_sd, dtype="float32",
                      data={"guide": seg_data["image"],
                            "label": seg_data["label"]},
                      regularisers=False))
    harness_data = tp.batch(HARNESS_SEED)
    cases.append(dict(kind="fusion", sd=joint, dtype="float32",
                      data=harness_data, round1=True))
    got = dist.launch(pr.run_cases, 2, (cases,), timeout=240, threads=1,
                      workdir=str(tmp_path_factory.mktemp("ranks")))
    rows = {k: v.reshape((2, 1) + v.shape[1:])
            for k, v in harness_data.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the ranks: the sums' blocking follows it
    try:
        want["accum"] = tp.run_port(tp.port_model(variables), rows, True,
                                    2)[1]
    finally:
        torch.set_num_threads(threads)
    return want, got


@pytest.mark.parametrize("round1", [True, False])
def test_dp_fusion_step_matches_jax_f32(runs, round1):
    want, got = runs
    i = 0 if round1 else 1
    assert all(np.array_equal(r[i]["grads"][k], got[0][i]["grads"][k])
               for r in got for k in got[0][i]["grads"])
    g = got[0][i]
    want_m, want_g, want_dwa = want[round1]
    for k in ("loss", "loss_fusion", "loss_seg"):
        np.testing.assert_allclose(g["metrics"][k], want_m[k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(g["metrics"]["weights"], want_m["weights"],
                               atol=1e-6)
    assert set(g["grads"]) == set(want_g)
    for k, e in want_g.items():
        e = e.numpy()
        np.testing.assert_allclose(g["grads"][k], e, rtol=0,
                                   atol=1e-3 * np.abs(e).max() + 1e-7,
                                   err_msg=k)
    for name in ("prev", "prev2"):
        np.testing.assert_allclose(g["dwa"][name], getattr(want_dwa, name),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_dp_seg_step_matches_jax_f32(runs):
    want, got = runs
    for k, v in got[0][2]["stats"].items():
        np.testing.assert_array_equal(got[1][2]["stats"][k], v)
    g = got[0][2]
    w_loss, w_grads, w_stats = want["seg"]
    np.testing.assert_allclose(g["metrics"]["loss"], w_loss, rtol=1e-5)
    sp.assert_leaves_close(g["grads"], w_grads, 1e-3, 1e-6)
    sp.assert_stats_close(g["stats"], w_stats, 1e-5)


def test_dp_fusion_step_equals_accumulation_f32(runs):
    want, got = runs
    g = got[0][3]["grads"]
    assert set(g) == set(want["accum"])
    for k, e in want["accum"].items():
        e = e.numpy()
        np.testing.assert_allclose(g[k], e, rtol=0,
                                   atol=1e-6 * np.abs(e).max(), err_msg=k)
