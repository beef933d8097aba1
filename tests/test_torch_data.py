"""The port's host data (``segmif_tpu_torch.data``) against the JAX
package's: the synthetic dataset byte for byte, the threaded
``Prefetcher``'s batch order (with the ``start_batch`` replay that a
resumed phase relies on, across epoch boundaries), and ``iterate_eval``
with its padded last batch."""
import numpy as np
import pytest

from segmif_tpu.data.datasets import SyntheticFusionDataset as JaxSynthetic
from segmif_tpu.data.pipeline import Prefetcher as JaxPrefetcher
from segmif_tpu.data.pipeline import iterate_eval as jax_iterate_eval
from segmif_tpu_torch.data.datasets import SyntheticFusionDataset
from segmif_tpu_torch.data.pipeline import Prefetcher, iterate_eval


@pytest.mark.parametrize("n,size,classes,seed", [
    (3, (24, 40), 9, 0), (2, (17, 33), 5, 1), (2, (48, 64), 9, 7)])
def test_synthetic_dataset_is_jax_byte_for_byte(n, size, classes, seed):
    mine, ref = (cls(n, size, classes, seed)
                 for cls in (SyntheticFusionDataset, JaxSynthetic))
    assert len(mine) == len(ref) == n
    for i in range(n):
        a, b = mine[i], ref[i]
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def _take(pf, k):
    it = iter(pf)
    out = [next(it) for _ in range(k)]
    pf.close()
    return out


@pytest.mark.parametrize("start", [0, 1, 3, 4, 7])
def test_prefetcher_order_equals_jax(start):
    """Batches start..start+4 of both, with 6 samples in batches of 2 (3
    per epoch), so the replay crosses epoch boundaries."""
    ds = SyntheticFusionDataset(n=6, size=(8, 8))
    got = _take(Prefetcher(ds, 2, seed=7, num_threads=2, start_batch=start),
                5)
    want = _take(JaxPrefetcher(ds, 2, seed=7, num_threads=2,
                               use_native=False, start_batch=start), 5)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_prefetcher_replays_the_uninterrupted_sequence():
    ds = SyntheticFusionDataset(n=5, size=(8, 8))
    ref = _take(Prefetcher(ds, 2, seed=3), 6)
    for k in (1, 2, 5):
        np.testing.assert_array_equal(
            _take(Prefetcher(ds, 2, seed=3, start_batch=k), 1)[0]["ir"],
            ref[k]["ir"])


def test_prefetcher_close_stops_its_thread():
    pf = Prefetcher(SyntheticFusionDataset(n=4, size=(8, 8)), 2,
                    prefetch_depth=1)
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("n,b", [(3, 2), (4, 2), (5, 4)])
def test_iterate_eval_equals_jax_and_pads(n, b):
    ds = SyntheticFusionDataset(n=n, size=(8, 8))
    got, want = list(iterate_eval(ds, b)), list(jax_iterate_eval(ds, b))
    assert len(got) == len(want) == -(-n // b)
    for (gn, gc, ga), (wn, wc, wa) in zip(got, want):
        assert gn == wn and gc == wc
        for x, y in zip(ga, wa):
            assert x.shape[0] == b
            np.testing.assert_array_equal(x, y)
    names, count, arrays = got[-1]
    assert count == len(names) == n - b * (len(got) - 1)
    np.testing.assert_array_equal(arrays[0][-1], ds[n - 1][1])
