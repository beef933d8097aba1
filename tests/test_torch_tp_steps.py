"""Tensor parallelism of the port's train steps on gloo CPU ranks, f64,
mit_b0 at 32x32 (``dp_parity``'s weights and global batch of 4, the last
two rows' labels all ignored): the fusion step, rounds 1 and >= 2, and the
seg step with and without drop-path and dropout, on TP 2 (2 ranks, one
model group) and on DP 2 x TP 2 (4 ranks: rank r at data r // 2, model
r % 2):

 - against one process on the whole batch (``dp_parity``'s comparison:
   losses 1e-10, gradients 1e-9 of each leaf's largest magnitude, ...),
   the split leaves' gradients and weights gathered whole; every rank of
   a model group holds the same whole leaves and the same gathered ones,
   bit for bit;
 - without drop-path and dropout, against the JAX package's
   single-device f64 steps at ``test_torch_parallel_jax.py``'s limits
   (losses rtol 1e-6, each gradient leaf within 1e-5 of its largest
   magnitude, DWA 1e-6; the seg step's BatchNorm buffers within 1e-5);
 - planted faults fail the comparison with one process: the FFM gather's
   backward as a reduce-scatter (the FFM's gradients M times too large),
   kv split contiguously, and the gradients summed over every rank
   instead of the data group. (proj's bias added on every rank moves no
   step at these weights, whose linear biases are zero: the forward tests
   plant it, with drawn biases.)
"""
import jax.numpy as jnp
import numpy as np
import pytest

import dp_parity as dpp
import seg_parity as sp
import train_parity as tp
from segmif_tpu.models.network import JointPipeline as JaxJointPipeline
from segmif_tpu_torch.parallel import dist
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

CASES = ["fusion r1 b4", "fusion r2 b4", "seg b4 plain", "seg b4"]
# (fault, case) planted on TP 2 and on DP 2 x TP 2
FAULTS = {2: [("gather_reduce_scatter", "fusion r2 b4"),
              ("kv_contiguous", "seg b4 plain")],
          4: [("world_sum", "fusion r2 b4"),
              ("gather_reduce_scatter", "fusion r1 b4")]}


@pytest.fixture(scope="module")
def weights():
    return dpp.weights()


@pytest.fixture(scope="module")
def one(weights):
    return dpp.one_process(weights, CASES)


def _on_ranks(weights, world, workdir):
    c = dpp.cases(weights)
    todo = [(n, dict(c[n], model=2)) for n in CASES]
    todo += [(f"fault {f}", dict(c[n], model=2, faults=(f,)))
             for f, n in FAULTS[world]]
    ranks = dist.launch(dpp.pr.run_cases, world, ([x for _, x in todo],),
                        timeout=dpp.LAUNCH_S, threads=1, workdir=workdir)
    return {n: [r[i] for r in ranks] for i, (n, _) in enumerate(todo)}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    return {w: _on_ranks(weights, w, str(tmp_path_factory.mktemp(
        f"ranks{w}"))) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_tp_matches_one_process(runs, one, world, case):
    dpp.ranks_agree(runs[world][case])
    dpp.check_one_process(runs[world][case][0], one[case])


@pytest.fixture(scope="module")
def jax_f64(weights):
    """The JAX single-device f64 steps on the batch of 4: fusion rounds 1
    and >= 2, the seg step without drop-path and dropout."""
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
def test_tp_matches_jax_f64(runs, jax_f64, world, kind):
    if kind == "seg":
        got = runs[world]["seg b4 plain"][0]
        w_loss, w_grads, w_stats = jax_f64["seg"]
        np.testing.assert_allclose(got["metrics"]["loss"], w_loss, rtol=1e-6)
        sp.assert_leaves_close(got["grads"], w_grads, 1e-5, 1e-12)
        sp.assert_leaves_close(got["stats"], w_stats, 1e-5, 0.0)
        return
    got = runs[world][kind + " b4"][0]
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


@pytest.mark.parametrize("world,fault,case",
                         [(w, f, c) for w, fs in FAULTS.items()
                          for f, c in fs])
def test_planted_faults_fail(runs, one, world, fault, case):
    with pytest.raises(AssertionError):
        dpp.check_one_process(runs[world]["fault " + fault][0], one[case])
