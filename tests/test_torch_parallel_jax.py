"""Data parallelism of the port against the JAX single-device step, in
f64 on gloo CPU ranks (mit_b0 at 32x32; the JAX step under
``train_parity.jax_in_f64``): the fusion step, rounds 1 and >= 2, and the
seg step without drop-path and dropout (whose draws differ between the
packages), at a global batch of 4 whose last two rows' labels are all
ignored (the second of 2 ranks, the last two of 4, hold no valid pixel),
on 2 and 4 ranks:

 - against one process on the whole batch (``dp_parity``'s comparison;
   every rank's results the same, bit for bit);
 - against JAX at the f64 parity tests' tolerances
   (``train_parity.assert_step_matches_jax_f64``,
   ``test_torch_seg_step_f64.py``): losses rtol 1e-6, each gradient leaf
   within 1e-5 of its largest magnitude, DWA 1e-6; the seg step's
   BatchNorm buffers within 1e-5 (its exact-zero leaves within 1e-12 of
   the largest gradient).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import dp_parity as dpp
import seg_parity as sp
import train_parity as tp
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

CASES = ["fusion r1 b4", "fusion r2 b4", "seg b4 plain"]


@pytest.fixture(scope="module")
def weights():
    return dpp.weights()


@pytest.fixture(scope="module")
def one(weights):
    return dpp.one_process(weights, CASES)


@pytest.fixture(scope="module")
def dp2(weights, tmp_path_factory):
    return dpp.on_ranks(weights, 2, CASES, str(tmp_path_factory.mktemp(
        "ranks")))


@pytest.fixture(scope="module")
def dp4(weights, tmp_path_factory):
    return dpp.on_ranks(weights, 4, CASES, str(tmp_path_factory.mktemp(
        "ranks")))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_dp_matches_one_process(dp2, dp4, one, world, case):
    runs = dp2 if world == 2 else dp4
    dpp.ranks_agree(runs[case])
    dpp.check_one_process(runs[case][0], one[case])


@pytest.fixture(scope="module")
def jax_f64(weights):
    """The JAX single-device steps in f64 on the batch of 4: fusion
    rounds 1 and >= 2 (gradients, metrics, DWA) and the seg step without
    drop-path and dropout (loss, gradients, BatchNorm buffers)."""
    variables, seg_vars, _, _ = weights
    a = dpp.data(1, 4, ignored_rows=2)
    out = {}
    with tp.jax_in_f64():
        m64 = JaxJointPipeline("mit_b0", num_classes=tp.CLASSES,
                               dtype=jnp.float64)
        for r1 in (True, False):
            out[r1] = tp.run_jax(m64, tp._f64(variables), a, r1, 1)
    with pytest.MonkeyPatch.context() as mp:
        sp.no_regularisers(mp)
        with tp.jax_in_f64():
            seg64 = sp.jax_network.SegmentationNetwork("mit_b0", sp.CLASSES,
                                                       dtype=jnp.float64)
            out["seg"] = sp.run_jax(seg64, tp._f64(seg_vars),
                                    {"image": a["guide"],
                                     "label": a["label"]}, False)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["fusion r1", "fusion r2", "seg"])
def test_dp_matches_jax_f64(dp2, dp4, jax_f64, world, kind):
    """The f64 parity tests' tolerances: losses rtol 1e-6, each gradient
    leaf within 1e-5 of its largest magnitude, DWA 1e-6; the seg step's
    BatchNorm buffers within 1e-5 (its exact-zero leaves within 1e-12 of
    the largest gradient)."""
    runs = dp2 if world == 2 else dp4
    if kind == "seg":
        got = runs["seg b4 plain"][0]
        w_loss, w_grads, w_stats = jax_f64["seg"]
        np.testing.assert_allclose(got["metrics"]["loss"], w_loss, rtol=1e-6)
        sp.assert_leaves_close(got["grads"], w_grads, 1e-5, 1e-12)
        sp.assert_leaves_close(got["stats"], w_stats, 1e-5, 0.0)
        return
    got = runs[kind + " b4"][0]
    want_m, want_g, want_dwa = jax_f64[kind == "fusion r1"]
    for k in ("loss", "loss_fusion", "loss_seg"):
        np.testing.assert_allclose(got["metrics"][k], want_m[k], rtol=1e-6,
                                   err_msg=k)
    assert set(got["grads"]) == set(want_g)
    for k, e in want_g.items():
        e = e.numpy()
        np.testing.assert_allclose(got["grads"][k], e, rtol=0,
                                   atol=1e-5 * np.abs(e).max() + 1e-12,
                                   err_msg=k)
    for name in ("prev", "prev2"):
        np.testing.assert_allclose(got["dwa"][name],
                                   getattr(want_dwa, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    if kind == "fusion r2":   # the all-ignored shard holds no CE pixel
        assert float(got["metrics"]["loss_seg"]) > 0.0
