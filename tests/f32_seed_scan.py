"""How often the f32 fusion-step comparison against JAX holds, by data
seed: the one-process step of the port and its data-parallel step on two
gloo CPU ranks (one row each), on the harness of the f32 parity tests
(``train_parity``: mit_b0 32x32, batch 2, fusion weights at the
reference modules' scale, ``batch(seed)``).

For each seed and each round kind (1, and >= 2) it prints the worst
gradient leaf, max|err| / max|ref| with the leaf's name, of
 - (one) the port's one-process step against JAX's step,
 - (dp) the port's 2-rank step against JAX's step,
 - (dp-one) the 2-rank step against the one-process step,
and, in round 1 (where the loss is a mean over equal rows, so that
accumulation is the same maths as the global batch):
 - (accum-one) the one-process step with ``grad_accum=2`` (micro-batches
   of one row: a rank's shapes, no ranks) against the one-process step,
 - (dp-accum) the 2-rank step against that accumulated step;
then, per comparison, the (seed, round) pairs whose every leaf holds
1e-3, the f32 parity tests' limit. Where (dp-one) fails and (accum-one)
fails alike while (dp-accum) holds, the ranks' batch of one row rounds
otherwise than the batch of two (a relu input within rounding of zero
taking the other branch), not the ranks' exchange.

    python tests/f32_seed_scan.py              # seeds 1-20
    python tests/f32_seed_scan.py --seeds 1 4
"""
import argparse
import os
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import parallel_ranks as pr  # noqa: E402
import train_parity as tp  # noqa: E402
from segmif_tpu.train.state import FusionTrainState as JaxState  # noqa: E402
from segmif_tpu.train.steps import (  # noqa: E402
    make_fusion_train_step as jax_step)
from segmif_tpu_torch.convert import fusion_state_dict_from_jax  # noqa: E402
from segmif_tpu_torch.parallel import dist  # noqa: E402

LIMIT = 1e-3


def worst(got, want):
    """(max over leaves of max|got - want| / max|want|, that leaf)."""
    errs = {k: np.abs(np.asarray(got[k]) - w).max() / max(np.abs(w).max(),
                                                           1e-30)
            for k, w in want.items()}
    k = max(errs, key=errs.get)
    return errs[k], k


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--seeds", type=int, nargs=2, default=(1, 20),
                   metavar=("FIRST", "LAST"))
    args = p.parse_args()
    seeds = range(args.seeds[0], args.seeds[1] + 1)
    torch.set_num_threads(1)
    model, variables = tp.jax_variables()
    seg_vars = {"params": {"seg": variables["params"]["seg"]},
                "batch_stats": {"seg": variables["batch_stats"]["seg"]}}
    tx = tp._jax_keep_grads()
    jax_steps = {r1: jax.jit(jax_step(model, tx, round1=r1, grad_accum=1))
                 for r1 in (True, False)}
    sd = pr.state_dict_numpy(tp.port_model(variables))
    rounds = (True, False)
    cases = [dict(kind="fusion", sd=sd, dtype="float32", data=tp.batch(s),
                  round1=r1) for s in seeds for r1 in rounds]
    with tempfile.TemporaryDirectory() as tmp:
        dp = dist.launch(pr.run_cases, 2, (cases,), timeout=1800, threads=1,
                         workdir=tmp)[0]
    held = {"one": [], "dp": [], "dp-one": [], "accum-one": [],
            "dp-accum": []}
    for i, case in enumerate(cases):
        seed, r1 = seeds[i // 2], case["round1"]
        state = JaxState.create(variables["params"]["fusion"], tx)
        new, _ = jax_steps[r1](state, seg_vars, case["data"],
                               jnp.float32(tp.FUSION_SCALE))
        want = {k: v.numpy() for k, v in fusion_state_dict_from_jax(
            jax.tree.map(np.asarray, new.opt_state)).items()}
        one = {k: v.numpy() for k, v in tp.run_port(
            tp.port_model(variables), case["data"], r1, 1)[1].items()}
        res = {"one": worst(one, want), "dp": worst(dp[i]["grads"], want),
               "dp-one": worst(dp[i]["grads"], one)}
        if r1:
            rows = {k: v.reshape((2, 1) + v.shape[1:])
                    for k, v in case["data"].items()}
            accum = {k: v.numpy() for k, v in tp.run_port(
                tp.port_model(variables), rows, r1, 2)[1].items()}
            res["accum-one"] = worst(accum, one)
            res["dp-accum"] = worst(dp[i]["grads"], accum)
        print(f"seed {seed:2d} round {'1' if r1 else '>=2'}: " + "; ".join(
            f"{name} {e:.2e} ({k})" for name, (e, k) in res.items()),
            flush=True)
        for name, (e, _) in res.items():
            if e <= LIMIT:
                held[name].append((seed, r1))
    for name, ok in held.items():
        kinds = rounds if name in ("one", "dp", "dp-one") else (True,)
        pairs = {(s, r) for s in seeds for r in kinds}
        fail = ", ".join(f"{s}/{'1' if r else '>=2'}"
                         for s, r in sorted(pairs - set(ok)))
        print(f"{name}: {len(ok)} of {len(pairs)} (seed, round) pairs hold "
              f"{LIMIT:g}; failing (seed/round): {fail or 'none'}")


if __name__ == "__main__":
    main()
