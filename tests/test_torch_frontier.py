"""repro_torch.core.frontier against repro.core.frontier, bit for bit.

Rows hold small integer values over few columns, so duplicates and value
ties are the common case (as in the walk sketches): every sum is exact and
the tie order (value descending, column ascending) is what is tested.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as JF
from repro_torch.core import frontier as TF

torch.set_num_threads(1)


def _rows(seed, q=6, w=40, cols=12, zero_frac=0.25):
    r = np.random.default_rng(seed)
    v = r.integers(1, 5, (q, w)).astype(np.float32)
    v[r.random((q, w)) < zero_frac] = 0.0
    i = r.integers(0, cols, (q, w)).astype(np.int32)
    i[v == 0] = 0
    return v, i


def _same(got, want):
    got_v, got_i = (t.numpy() for t in got[:2])
    want_v, want_i = (np.asarray(t) for t in want[:2])
    assert got_v.dtype == np.float32 and got_i.dtype == np.int32
    assert np.array_equal(got_v.view(np.uint32), want_v.view(np.uint32))
    assert np.array_equal(got_i, want_i)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_duplicates_bitwise(seed):
    v, i = _rows(seed)
    _same(TF.merge_duplicates(torch.from_numpy(v), torch.from_numpy(i)),
          JF.merge_duplicates(jnp.asarray(v), jnp.asarray(i)))


@pytest.mark.parametrize("k", [1, 5, 40, 64])
def test_topk_compact_bitwise(k):
    v, i = _rows(3)
    _same(TF.topk_compact(torch.from_numpy(v), torch.from_numpy(i), k),
          JF.topk_compact(jnp.asarray(v), jnp.asarray(i), k))


@pytest.mark.parametrize("k,threshold", [(4, 0.0), (12, 0.0), (50, 0.0),
                                         (8, 3.0), (12, 6.5)])
def test_compact_arrays_bitwise(k, threshold):
    v, i = _rows(4)
    _same(TF.compact_arrays(torch.from_numpy(v), torch.from_numpy(i), k,
                            threshold=threshold),
          JF.compact_arrays(jnp.asarray(v), jnp.asarray(i), k,
                            threshold=threshold))
    got = TF.compact(torch.from_numpy(v), torch.from_numpy(i), k, 12,
                     threshold=threshold)
    assert got.k == k and got.n == 12


def test_threshold_values_bitwise():
    v, _ = _rows(5)
    for eps in (0.0, 2.0, 4.5):
        got = TF.threshold_values(torch.from_numpy(v), eps).numpy()
        assert np.array_equal(got, np.asarray(
            JF.threshold_values(jnp.asarray(v), eps)))


@pytest.mark.parametrize("k", [6, 20])
def test_fold_topk_bitwise(k):
    rv, ri = _rows(6, w=k)
    av, ai = _rows(7, w=30)
    got = TF.fold_topk(*(torch.from_numpy(x) for x in (rv, ri, av, ai)), k)
    want = JF.fold_topk(*(jnp.asarray(x) for x in (rv, ri, av, ai)), k)
    _same(got, want)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_merge_sketch_parts_bitwise():
    v, i = _rows(8, w=48)
    d = np.arange(6, dtype=np.float32)
    got = TF.merge_sketch_parts(torch.from_numpy(v), torch.from_numpy(i),
                                torch.from_numpy(d), 10)
    want = JF.merge_sketch_parts(jnp.asarray(v), jnp.asarray(i),
                                 jnp.asarray(d), 10)
    _same(got, want)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_constructors_and_densify():
    src = np.array([3, 0, 7], np.int32)
    got = TF.from_sources(torch.from_numpy(src), 9)
    want = JF.from_sources(jnp.asarray(src), 9)
    _same((got.values, got.indices), (want.values, want.indices))
    assert np.array_equal(got.densify().numpy(), np.asarray(want.densify()))
    seeds = np.array([[1, 1, 4], [2, 0, 0]], np.int32)
    w = np.array([[0.5, 0.25, 0.25], [1.0, 0.0, 0.0]], np.float32)
    got = TF.from_seed_sets(torch.from_numpy(seeds), torch.from_numpy(w), 5)
    want = JF.from_seed_sets(jnp.asarray(seeds), jnp.asarray(w), 5)
    assert got.k == want.k == 3
    assert np.array_equal(got.densify().numpy(), np.asarray(want.densify()))
    assert np.array_equal(got.mass().numpy(), np.asarray(want.mass()))
