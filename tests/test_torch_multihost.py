"""Data parallelism over several hosts (torchrun nodes) in the port:
``parallel.dist.host_layout`` / ``launch(ranks_per_host=)``, the
``Prefetcher``'s per-host stride (the JAX package's ``shard_by_process``),
the host-aware ``BatchShard`` and the trainer's file writers.

 - The ``Prefetcher`` of host h of P yields, batch for batch and name for
   name, what the JAX ``Prefetcher`` yields under ``jax.process_index()``
   = h and ``process_count()`` = P (both patched here, the JAX package
   untouched), for P = 2 and 3, from the start and resumed at batch 3,
   over two epochs of the host's names; the hosts' names in one epoch are
   disjoint and their union is the epoch less each host's dropped
   remainder; the native loader is handed only the host's paths and gives
   the JAX native ``Prefetcher``'s batches.
 - On 2 emulated hosts x 2 gloo CPU ranks (mit_b0, 32x32, f64, global
   batch 8: 4 rows a host from its ``Prefetcher``, 2 a rank) the fusion
   steps (rounds 1 and >= 2) and the seg step equal one process on the
   hosts' batches concatenated in host order, within 1e-12 of each leaf's
   largest magnitude (losses and DWA state within rtol 1e-12; the updated
   weights also within 1e-9 of an AdamW step); every rank
   holds the same results; both hosts reading host 0's stride fail that
   comparison; a model group across hosts and a host batch that the
   host's data ranks do not divide raise.
 - The trainer on 2 hosts x 2 ranks (one f64 round at global batches of
   4): with one shared checkpoint dir rank 0 alone writes, with a dir a
   host each host's first rank writes a whole copy; in both a run stopped
   after the fusion phase's first mid-phase checkpoint and resumed ends
   where the uninterrupted run (shared dir) ends, bit for bit;
   ``cli.train --mesh_model 2`` (a model group a
   host) writes a copy and a ``train.log`` a host; the dry run runs.
 - ``host_layout`` refuses hosts of unequal size and a GROUP_RANK that
   disagrees with the ranks' numbering.
"""
import json

import jax
import numpy as np
import pytest
import torch

import dp_parity as dpp
import parallel_ranks as pr
import seg_parity as sp
from segmif_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from segmif_tpu.eval.image_io import save_png
from segmif_tpu_torch import drift
from segmif_tpu_torch.data import native, pipeline
from segmif_tpu_torch.data.datasets import (FusionFolderDataset,
                                            SyntheticFusionDataset)
from segmif_tpu_torch.data.pipeline import Prefetcher
from segmif_tpu_torch.models.network import (JointPipeline,
                                             SegmentationNetwork,
                                             init_params)
from segmif_tpu_torch.parallel import dist
from segmif_tpu_torch.train.compare import exact_zero_grad
from torch_threads import one_thread  # noqa: F401 (autouse fixture)

HOSTS, PER_HOST = 2, 2
SEED = 11
CASES = ["fusion r1 b8", "fusion r2 b8", "seg b8"]
FAULT = ("same_stride", "fusion r2 b8")


class IndexDataset:
    """Sample i: images and label filled with i, named by i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((2, 3, 3), i, np.uint8)
        return str(i), img, img + 1, img + 2, np.full((2, 3), i, np.int32)


def _names(batch):
    return batch["label"][:, 0, 0].tolist()


def _take(pf, k):
    it = iter(pf)
    try:
        return [next(it) for _ in range(k)]
    finally:
        pf.close()


def _as_host(monkeypatch, h, p):
    monkeypatch.setattr(pipeline, "host_layout", lambda: (h, p))
    monkeypatch.setattr(jax, "process_index", lambda: h)
    monkeypatch.setattr(jax, "process_count", lambda: p)


LAYOUTS = [(h, p) for p in (2, 3) for h in range(p)]


@pytest.mark.parametrize("start", [0, 3])
@pytest.mark.parametrize("h,p", LAYOUTS)
def test_host_prefetcher_equals_jax(monkeypatch, h, p, start):
    """13 names in batches of 2: hosts of 7 / 6 (P = 2) or 5 / 4 / 4
    (P = 3) names, so epochs of 3 or 2 batches and a dropped remainder;
    two epochs of batches from ``start``."""
    _as_host(monkeypatch, h, p)
    ds = IndexDataset(13)
    k = 2 * (len(range(h, 13, p)) // 2)
    got = _take(Prefetcher(ds, 2, seed=5, num_threads=2, start_batch=start),
                k)
    want = _take(JaxPrefetcher(ds, 2, seed=5, num_threads=2,
                               use_native=False, start_batch=start), k)
    assert [_names(b) for b in got] == [_names(b) for b in want]
    assert all(n % p == h for b in got for n in _names(b))
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("p", [2, 3])
def test_host_strides_cover_one_epoch(monkeypatch, p):
    n, b = 13, 2
    seen = []
    for h in range(p):
        monkeypatch.setattr(pipeline, "host_layout", lambda h=h: (h, p))
        per_epoch = len(range(h, n, p)) // b
        names = [x for batch in _take(Prefetcher(IndexDataset(n), b, seed=5),
                                      per_epoch) for x in _names(batch)]
        assert len(set(names)) == len(names) == per_epoch * b
        assert set(names) <= set(range(h, n, p))
        seen.append(set(names))
    union = set().union(*seen)
    assert sum(len(s) for s in seen) == len(union)   # disjoint
    assert len(union) == sum(len(range(h, n, p)) // b * b for h in range(p))
    # shard_by_process=False: every host reads an epoch of all the names
    monkeypatch.setattr(pipeline, "host_layout", lambda: (1, p))
    whole = [x for batch in _take(Prefetcher(IndexDataset(n), b, seed=5,
                                             shard_by_process=False), n // b)
             for x in _names(batch)]
    assert len(set(whole)) == len(whole) == n // b * b
    assert {x % p for x in whole} == set(range(p))


def _folder(root, n=6, size=(16, 24)):
    src = SyntheticFusionDataset(n=n, size=size, seed=3)
    for i in range(n):
        name, ir, vis, g, lab = src[i]
        for d, a in (("Infrared", ir[..., 0]), ("Visible", vis),
                     ("Mask2", g), ("Label", lab)):
            save_png(root / d / name, a.astype(np.uint8))
    return FusionFolderDataset(root)


@pytest.mark.parametrize("h", [0, 1])
def test_native_loader_reads_only_the_host_paths(tmp_path, monkeypatch, h):
    ds = _folder(tmp_path)
    _as_host(monkeypatch, h, HOSTS)
    handed = []
    real = native.NativeLoader

    def spy(paths, *a, **k):
        handed.append(list(paths))
        return real(paths, *a, **k)

    monkeypatch.setattr(native, "NativeLoader", spy)
    pf = Prefetcher(ds, 2, seed=4, num_threads=1)
    ref = JaxPrefetcher(ds, 2, seed=4, num_threads=1, use_native=True)
    assert pf._native is not None and ref._native is not None
    assert handed == [ds.sample_paths()[h::HOSTS]]
    for a, b, _ in zip(pf, ref, range(4)):   # past an epoch boundary
        for k in ("ir", "vis", "guide", "label"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    pf.close()
    ref.close()


# ---------------------------------------------------------------- steps ----

@pytest.fixture(scope="module")
def weights():
    """``dp_parity.weights``' layout from the port's own seeded init (the
    fusion side at the reference modules' scale): the steps are held to
    one process of the port, so no JAX init is needed."""
    joint = drift.init_reference_scale(
        JointPipeline("mit_b0", num_classes=pr.CLASSES),
        torch.Generator().manual_seed(0))
    seg = init_params(SegmentationNetwork("mit_b0", pr.CLASSES),
                      torch.Generator().manual_seed(1))
    return None, None, pr.state_dict_numpy(joint), pr.state_dict_numpy(seg)


@pytest.fixture(scope="module")
def one(weights):
    """One process on the hosts' Prefetcher batches concatenated in host
    order, by case."""
    cases = dpp.cases(weights)
    todo = []
    with pytest.MonkeyPatch.context() as mp:
        for name in CASES:
            parts = []
            for h in range(HOSTS):
                mp.setattr(pipeline, "host_layout", lambda h=h: (h, HOSTS))
                parts.append(pr.host_batch(cases[name]["data"], SEED)[0])
            todo.append(dict(cases[name], data={
                k: np.concatenate([b[k] for b in parts]) for k in parts[0]}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dict(zip(CASES, pr.run_cases(None, todo)))
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def launched(weights, tmp_path_factory):
    """One launch of 2 hosts x 2 ranks: the steps and the trainer runs
    (``parallel_ranks.host_run``), and the trainer's checkpoint dirs."""
    cases = dpp.cases(weights)
    todo = [cases[n] for n in CASES]
    todo.append(dict(cases[FAULT[1]], faults=(FAULT[0],)))
    dirs = [tmp_path_factory.mktemp(n) for n in
            ("shared_a", "shared_b", "own", "cli")]
    ranks = dist.launch(pr.host_run, HOSTS * PER_HOST,
                        (todo, SEED, [str(d) for d in dirs]),
                        timeout=dpp.LAUNCH_S, threads=1,
                        workdir=str(tmp_path_factory.mktemp("ranks")),
                        ranks_per_host=PER_HOST)
    return ranks, dirs


@pytest.fixture(scope="module")
def hosts(launched):
    return launched[0]


def check_hosts(got, want, rtol=1e-12):
    """``got`` against ``want`` within ``rtol`` of each leaf's largest
    magnitude (losses and DWA state within rtol; the leaves whose exact
    gradient is zero within ``rtol`` of the largest gradient). The updated
    weights also within 1e-9 of a step (lr): AdamW's first step is about
    lr g / (|g| + eps), so an element whose gradient is small carries its
    gradient's relative error into the step (2e-11 of lr read here); the
    leaves whose exact gradient is zero move by +-lr on rounding noise on
    both sides and are not compared."""
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol,
                                   err_msg=k)
    for k, v in want.get("dwa", {}).items():
        np.testing.assert_allclose(got["dwa"][k], v, rtol=rtol, err_msg=k)
    sp.assert_leaves_close(got["grads"], want["grads"], rtol, rtol)
    if "stats" in want:
        top = max(np.abs(v).max() for v in want["stats"].values())
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], v, rtol=0,
                                       atol=rtol * top, err_msg=k)
    for k, v in want["params"].items():
        if not exact_zero_grad(k):
            np.testing.assert_allclose(
                got["params"][k], v, rtol=0,
                atol=rtol * np.abs(v).max() + 1e-9 * pr.LR, err_msg=k)


def test_host_layout_of_the_emulated_hosts(hosts):
    for r, out in enumerate(hosts):
        h = r // PER_HOST
        assert tuple(out["layout"]) == (h, HOSTS)
        assert tuple(out["mesh"]) == (h, HOSTS, r % PER_HOST)
    rows = [hosts[h * PER_HOST]["rows"][0] for h in range(HOSTS)]
    assert rows == [list(range(h, 8, HOSTS)) for h in range(HOSTS)]


@pytest.mark.parametrize("case", CASES)
def test_hosts_match_one_process(hosts, one, case):
    i = CASES.index(case)
    dpp.ranks_agree([r["cases"][i] for r in hosts])
    check_hosts(hosts[0]["cases"][i], one[case])


def test_same_stride_fault_fails(hosts, one):
    bad = hosts[0]["cases"][len(CASES)]
    assert [r["rows"][len(CASES)] for r in hosts] == \
        [list(range(0, 8, HOSTS))] * (HOSTS * PER_HOST)
    with pytest.raises(AssertionError):
        check_hosts(bad, one[FAULT[1]])


def test_multihost_refusals(hosts):
    for out in hosts:
        model, six, five = out["refusals"]
        assert "spans hosts" in model and "mesh_model must divide" in model
        for msg, rows in ((six, "3"), (five, "2.5")):
            assert msg is not None and f"reads {rows} rows" in msg
            assert "no meaning across hosts" in msg


# -------------------------------------------------------------- writers ----

@pytest.fixture(scope="module")
def writers(launched):
    ranks, dirs = launched
    return [r["writers"] for r in ranks], dirs[:3]


def _weights(run):
    return {f"{m}.{k}": v for m in ("fusion", "seg")
            for k, v in run[m].items()}


def _whole_copy(d):
    assert json.loads((d / "progress.json").read_text())["next_round"] == 2
    for name in ("fusion_params.pth", "seg_params.pth", "val_seg.txt"):
        assert (d / name).exists(), (d, name)
    assert not list(d.glob(".shared_*")) and not list(d.glob("*.tmp*"))


@pytest.mark.parametrize("layout", ["shared", "per_host"])
def test_hosts_resume_matches_uninterrupted(writers, layout):
    """Either layout's stopped and resumed run against the uninterrupted
    run with the shared dir: the same training, bit for bit."""
    ranks, _ = writers
    i = ["shared", "per_host"].index(layout)
    for r in ranks:
        run, resumed = r[0][0], r[i][1]
        want, got = _weights(run), _weights(resumed)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert resumed["result"]["best_mIoU"] == run["result"]["best_mIoU"]
        assert run["fusion_loss"] and run["seg_loss"]


def test_shared_dir_one_writer(writers):
    ranks, (a, b, _) = writers
    writer = [r[0][1]["writer"] for r in ranks]
    assert [w for w, _ in writer] == [True] + [False] * 3
    assert "share checkpoint_dir" in writer[0][1]
    assert ranks[0][0][0]["writes"]["role"] > 0
    assert ranks[0][0][0]["writes"]["phase"] > 0
    for r in ranks[1:]:
        assert r[0][1]["writes"] == {"role": 0, "phase": 0}
    for d in (a, b):
        _whole_copy(d)
        assert not list(d.glob("host*"))


def test_dir_per_host_a_whole_copy_each(writers):
    ranks, (_, _, own) = writers
    writer = [r[1][1]["writer"] for r in ranks]
    assert [w for w, _ in writer] == [True, False, True, False]
    assert "not shared" in writer[0][1]
    for r, rank in enumerate(ranks):
        wrote = rank[1][1]["writes"]
        assert (wrote["role"] > 0 and wrote["phase"] > 0) == \
            (r % PER_HOST == 0)
    for h in range(HOSTS):
        _whole_copy(own / f"host{h}")


def test_cli_train_on_two_hosts_logs_from_each_writer(launched):
    """``cli.train --mesh_model 2`` on 2 hosts x 2 ranks, a checkpoint dir
    a host: a model group a host (fusion batch 2: one row a host), each
    host's first rank writing its copy and its ``train.log``."""
    ranks, dirs = launched
    results = [r["cli"] for r in ranks]
    assert all(r == results[0] for r in results)
    assert 0.0 <= results[0]["best_mIoU"] <= 1.0
    for h in range(HOSTS):
        d = dirs[3] / f"host{h}"
        _whole_copy(d)
        log = (d / "train.log").read_text()
        assert "training complete" in log
        assert "each host's first rank writes" in log
        assert log.count("training complete") == 1


def test_dryrun_on_two_hosts(launched):
    """The dry run on 2 hosts x 2 ranks: data 2 x model 2, a model group a
    host, every rank cutting its rows of the same global draws."""
    lines = {r["dryrun"] for r in launched[0]}
    assert len(lines) == 1
    line = lines.pop()
    assert line.startswith("dryrun OK on 4 ranks") and \
        "mesh data=2, model=2" in line


def test_host_layout_refuses_unequal_hosts(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="do not split into hosts"):
        dist.launch(pr.host_run, 4, ranks_per_host=3)
    assert dist.host_layout() == (0, 1)   # no process group
    comm = dist.init(1, 0, init_method=f"file://{tmp_path / 'rdv'}")
    try:
        assert comm.world == 1 and dist.host_layout() == (0, 1)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        monkeypatch.setenv("GROUP_RANK", "1")
        with pytest.raises(ValueError, match="GROUP_RANK is 1"):
            dist.host_layout()
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="do not split into hosts"):
            dist.host_layout()
    finally:
        dist.leave()
