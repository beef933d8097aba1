"""Shared set-up of the data-parallel tests (``test_torch_parallel*.py``):
the mit_b0 weights and batches of the parity harnesses (``train_parity``,
``seg_parity``), the cases, their runs in one process and on gloo CPU
ranks (``parallel_ranks``, spawned by ``parallel.dist.launch`` with a
``file://`` rendezvous under the test's tmp directory and a time limit,
one intra-op thread a rank), and the one-process comparison:

the losses within rtol 1e-10, every gradient leaf within 1e-9 of its
largest magnitude (the seg leaves whose exact gradient is zero within
1e-12 of the largest gradient: ``seg_parity``), the updated weights
within 1e-9 of each leaf's largest plus 1e-6 of a step, the BatchNorm
buffers within 1e-9 of the largest buffer value, the DWA state within
1e-12.
"""
import numpy as np
import torch

import parallel_ranks as pr
import seg_parity as sp
import train_parity as tp
from segmif_tpu_torch.parallel import dist
from segmif_tpu_torch.train.compare import exact_zero_grad

LAUNCH_S = 240


def _f64(data):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in data.items()}


def data(seed, b, ignored_rows=0):
    """The parity tests' batch (``train_parity.batch``) of ``b`` rows in
    f64, the last ``ignored_rows`` rows' labels all ignored."""
    d = _f64(tp.batch(seed, (b,)))
    if ignored_rows:
        d["label"][b - ignored_rows:] = 255
    return d


def weights():
    """(JAX variables, JAX seg variables, fusion-side state dict, seg
    state dict)."""
    _, variables = tp.jax_variables()
    joint = pr.state_dict_numpy(tp.port_model(variables))
    _, seg_vars = sp.jax_variables()
    seg = pr.state_dict_numpy(sp.port_model(seg_vars))
    return variables, seg_vars, joint, seg


def cases(weights):
    """Every case of the DP tests, by name: the parity tests' batches of
    4 (the last two rows' labels ignored), 8 (likewise) and 3, fusion
    rounds 1 and >= 2, the seg step with and without drop-path and
    dropout."""
    _, _, joint, seg = weights
    a = data(1, 4, ignored_rows=2)   # the last shard of 2 (or 2 of 4)
    big = data(2, 8, ignored_rows=2)
    three = data(3, 3)
    fus = dict(kind="fusion", sd=joint, dtype="float64")
    sg = dict(kind="seg", sd=seg, dtype="float64")
    return {
        "fusion r1 b4": dict(fus, data=a, round1=True),
        "fusion r2 b4": dict(fus, data=a, round1=False),
        "seg b4 plain": dict(sg, data=a, regularisers=False),
        "seg b4": dict(sg, data=a),
        "fusion r1 b8": dict(fus, data=big, round1=True),
        "fusion r2 b8": dict(fus, data=big, round1=False),
        "seg b8": dict(sg, data=big),
        "fusion r2 b3": dict(fus, data=three, round1=False),
        "seg b3": dict(sg, data=three),
    }


def one_process(weights, names):
    """The one-process step of the named cases, by name, on one intra-op
    thread (beside the other test workers)."""
    c = cases(weights)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dict(zip(names, pr.run_cases(None, [c[n] for n in names])))
    finally:
        torch.set_num_threads(threads)


def on_ranks(weights, world, names, workdir, faults=()):
    """The named cases on ``world`` ranks, by name (each a list of the
    ranks' results); ``faults``: (fault, case) pairs, run as "fault
    <fault>"."""
    c = cases(weights)
    todo = [(n, c[n]) for n in names]
    todo += [("fault " + f, dict(c[n], faults=(f,))) for f, n in faults]
    ranks = dist.launch(pr.run_cases, world, ([x for _, x in todo],),
                        timeout=LAUNCH_S, threads=1, workdir=workdir)
    return {n: [r[i] for r in ranks] for i, (n, _) in enumerate(todo)}


def check_one_process(got, want):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-10,
                                   atol=1e-14, err_msg=k)
    if "dwa" in want:
        for k, v in want["dwa"].items():
            np.testing.assert_allclose(got["dwa"][k], v, rtol=1e-12,
                                       err_msg=k)
        pr.assert_close_leaves(got["grads"], want["grads"], 1e-9, "grad")
    else:
        sp.assert_leaves_close(got["grads"], want["grads"], 1e-9, 1e-12)
        # a running mean may hold rounding noise only: the buffers within
        # 1e-9 of the largest buffer value
        top = max(np.abs(v).max() for v in want["stats"].values())
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=0,
                                       atol=1e-9 * top, err_msg=k)
    # the weights within 1e-9 of each leaf's largest, plus 1e-6 of a
    # step (LR); AdamW's first step normalises each gradient element, so
    # the leaves whose exact gradient is zero move by +-LR on rounding
    # noise, on both sides: not compared
    for k, v in want["params"].items():
        if not exact_zero_grad(k):
            np.testing.assert_allclose(
                got["params"][k], v, rtol=0,
                atol=1e-9 * np.abs(v).max() + 1e-6 * pr.LR, err_msg=k)


def ranks_agree(ranks):
    first = ranks[0]
    for other in ranks[1:]:
        for part, tree in first.items():
            for k, v in tree.items():
                np.testing.assert_array_equal(other[part][k], v,
                                              err_msg=f"{part} {k}")
