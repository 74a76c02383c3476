"""The port's incremental maintenance against the reference, bit for bit.

Same graph (the same numpy generator), same key, same edge batches: the
touch hash, a build's touch sketch, ``apply_edge_updates``'s CSR arrays,
the repair plan and report, and the repaired index and sketch must equal
the JAX package's; the repaired index must also equal the port's own
rebuild on the mutated graph.  The sharded repair is held against the
port's sharded rebuild.  ``PPRService.apply_updates`` swaps atomically,
rolls back on failure and invalidates exactly the repaired rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import updates as jupdates
from repro.core import walks as jwalks
from repro.core.graph import apply_edge_updates as j_apply_edge_updates
from repro.graphs import synthetic as jsyn
from repro_torch import convert, rng
from repro_torch.core import index as tindex
from repro_torch.core import updates as tupdates
from repro_torch.core import walks as twalks
from repro_torch.core.graph import apply_edge_updates as t_apply_edge_updates
from repro_torch.core.query import QueryConfig
from repro_torch.distributed import ShardMesh
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving import CacheConfig, PPRService, ServiceConfig
from repro_torch.serving.batching import BatchingConfig

torch.set_num_threads(1)

# rmat(10), source_batch 40: 26 chunks, the last one ragged (24 rows)
BUILD = dict(r=8, l=16, source_batch=40, c=0.25, respawn=True,
             touch_bits=2048)
# a batch touching few rows: sources of low in-traffic, one delete
INSERTS = np.array([[1000, 5], [1001, 900], [1000, 17]], np.int64)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _equal(got, want):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.asarray(want).shape
    assert np.array_equal(_bits(got), _bits(want))


def _edges(g):
    return np.stack([np.asarray(g.src.cpu() if torch.is_tensor(g.src)
                                else g.src, np.int64),
                     np.asarray(g.col_idx.cpu() if torch.is_tensor(g.col_idx)
                                else g.col_idx, np.int64)], axis=1)


@pytest.fixture(scope="module")
def graphs():
    return (jsyn.rmat(10, avg_deg=6.0, seed=3),
            tsyn.rmat(10, avg_deg=6.0, seed=3, device="cpu"))


@pytest.fixture(scope="module")
def key():
    return jax.random.PRNGKey(4)


@pytest.fixture(scope="module")
def maintained(graphs, key):
    jg, tg = graphs
    jm, _ = jupdates.build_maintainable_index(jg, key=key, **BUILD)
    tm, tstats = tupdates.build_maintainable_index(
        tg, key=convert.key_from_array(key), device="cpu", **BUILD)
    return jm, tm, tstats


@pytest.fixture(scope="module")
def deletes(graphs):
    return _edges(graphs[0])[[3000]]


# -- touch filters -------------------------------------------------------------

@pytest.mark.parametrize("n_bits", [1024, 4096, 65536, 1000])
def test_touch_hash_bits_match_reference(n_bits):
    """Random int32 ids, negative ones and the extremes included."""
    v = np.random.default_rng(n_bits).integers(
        -2**31, 2**31, 4000).astype(np.int32)
    v[:4] = [0, -1, 2**31 - 1, -2**31]
    want = np.asarray(jwalks.touch_hash_bits(jnp.asarray(v), n_bits))
    got = twalks.touch_hash_bits(torch.from_numpy(v), n_bits)
    assert got.dtype == torch.int32 and got.shape == (4000, 4)
    _equal(got, want)


@pytest.mark.parametrize("respawn", [False, True])
def test_walk_touch_filters_match_reference(graphs, key, respawn):
    """The walk engine's filters row for row, on both schedules, at a
    width that is not a power of two."""
    jg, tg = graphs
    src = np.arange(0, 1024, 9, dtype=np.int32)
    kw = dict(l=32, c=0.05, max_steps=8, respawn=respawn, touch_bits=1000)
    want = jwalks.simulate_walks_sparse(jg, jnp.asarray(src), 32, key, **kw)
    got = twalks.simulate_walks_sparse(
        tg, torch.from_numpy(src), 32, convert.key_from_array(key), **kw)
    assert got.touch.shape == (len(src), 1000)
    _equal(got.touch, want.touch)
    _equal(got.moves, want.moves)


def test_default_touch_bits_match_reference():
    for r in (1, 4, 5, 16, 100, 255, 10**6):
        assert tupdates.default_touch_bits(r) == jupdates.default_touch_bits(r)


def test_build_touch_sketch_matches_reference(maintained):
    jm, tm, stats = maintained
    assert tm.touch.bits.dtype == torch.bool
    _equal(tm.touch.bits, jm.touch.bits)
    _equal(tm.index.values, jm.index.values)
    _equal(tm.index.indices, jm.index.indices)
    assert tm.params == tupdates.BuildParams(**vars(jm.params))
    assert tm.n_chunks == jm.n_chunks == 26
    assert "touch" not in stats


def test_touch_bits_leave_the_index_and_ledger_unchanged(graphs, key,
                                                         maintained):
    _, tm, stats = maintained
    kw = {k: v for k, v in BUILD.items() if k != "touch_bits"}
    plain, pstats = tindex.build_index(
        graphs[1], key=convert.key_from_array(key), device="cpu", **kw)
    _equal(plain.values, tm.index.values.numpy())
    _equal(plain.indices, tm.index.indices.numpy())
    assert (pstats["kept_mass"], pstats["dropped_mass"]) == (
        stats["kept_mass"], stats["dropped_mass"])


# -- edge updates --------------------------------------------------------------

@pytest.mark.parametrize("case", ["insert_delete", "duplicate_insert",
                                  "noop", "delete_all_copies"])
def test_apply_edge_updates_matches_reference(graphs, case):
    jg, tg = graphs
    e = _edges(jg)
    ins, dels = {
        "insert_delete": (INSERTS, e[[3, 10, 400]]),
        "duplicate_insert": (np.concatenate([e[:2], e[:1]]), None),
        "noop": (None, np.zeros((0, 2), np.int64)),
        "delete_all_copies": (None, e[e[:, 0] == e[0, 0]]),
    }[case]
    jg2, jt = j_apply_edge_updates(jg, inserts=ins, deletes=dels)
    tg2, tt = t_apply_edge_updates(tg, inserts=ins, deletes=dels)
    assert (tg2.n, tg2.m) == (jg2.n, jg2.m)
    for name in ("row_ptr", "col_idx", "src", "out_deg"):
        _equal(getattr(tg2, name), getattr(jg2, name))
    assert tt.dtype == np.int64
    np.testing.assert_array_equal(tt, jt)
    if case == "noop":
        assert tg2 is tg


def test_apply_edge_updates_untouched_windows_identical(graphs, deletes):
    tg = graphs[1]
    tg2, touched = t_apply_edge_updates(tg, inserts=INSERTS, deletes=deletes)
    rp, ci = tg.row_ptr.numpy(), tg.col_idx.numpy()
    rp2, ci2 = tg2.row_ptr.numpy(), tg2.col_idx.numpy()
    for v in sorted(set(range(tg.n)) - set(touched.tolist())):
        np.testing.assert_array_equal(ci[rp[v]:rp[v + 1]],
                                      ci2[rp2[v]:rp2[v + 1]])


@pytest.mark.parametrize("bad", ["missing", "multiplicity", "out_of_range",
                                 "negative", "shape"])
def test_apply_edge_updates_errors_match_reference(graphs, bad):
    jg, tg = graphs
    e = _edges(jg)
    have = set(map(tuple, e.tolist()))
    missing = next((0, d) for d in range(jg.n) if (0, d) not in have)
    e0 = tuple(e[0])
    copies = sum(1 for x in map(tuple, e.tolist()) if x == e0)
    kwargs = {
        "missing": dict(deletes=np.array([missing])),
        "multiplicity": dict(deletes=np.array([e0] * (copies + 1))),
        "out_of_range": dict(inserts=np.array([[0, jg.n]])),
        "negative": dict(inserts=np.array([[-1, 0]])),
        "shape": dict(inserts=np.array([[0, 1, 2]])),
    }[bad]
    with pytest.raises(ValueError) as want:
        j_apply_edge_updates(jg, **kwargs)
    with pytest.raises(ValueError) as got:
        t_apply_edge_updates(tg, **kwargs)
    assert str(got.value) == str(want.value)


# -- repair --------------------------------------------------------------------

def test_plan_repair_matches_reference(maintained):
    jm, tm, _ = maintained
    for touched in ([1000, 1001, 1000, -3, 5000], [], [0], [17, 900]):
        want = jupdates.plan_repair(jm, touched)
        got = tupdates.plan_repair(tm, touched)
        assert sorted(got) == sorted(want)
        for k in ("touched", "dirty_rows", "chunks"):
            assert got[k].dtype == np.int64
            np.testing.assert_array_equal(got[k], want[k])
        assert got["n_chunks_total"] == want["n_chunks_total"]


def test_touch_sketch_covers_fingerprint_support(maintained):
    """No false negatives: every vertex a row puts mass on was a counted
    position, so querying it names the row."""
    _, tm, _ = maintained
    vals, idxs = tm.index.values.numpy(), tm.index.indices.numpy()
    for row in range(0, tm.real_n, 37):
        for v in np.unique(idxs[row][vals[row] > 0]):
            assert row in tm.touch.dirty_rows([int(v)])


def test_repair_matches_reference_and_rebuild(graphs, key, maintained,
                                              deletes):
    jg, tg = graphs
    jm, tm, _ = maintained
    jg2, jm2, want = jupdates.apply_updates(jm, jg, INSERTS, deletes)
    tg2, tm2, got = tupdates.apply_updates(tm, tg, INSERTS, deletes)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k
    # partial: the ragged last chunk stays out, the repair sweeps fewer
    assert 0 < got["repaired_chunks"] < got["total_chunks"]
    assert got["resample_ratio"] > 1.0
    _equal(tm2.index.values, jm2.index.values)
    _equal(tm2.index.indices, jm2.index.indices)
    _equal(tm2.touch.bits, jm2.touch.bits)
    for name in ("row_ptr", "col_idx"):
        _equal(getattr(tg2, name), getattr(jg2, name))
    rebuilt, rstats = tindex.build_index(
        tg2, key=convert.key_from_array(key), device="cpu", **BUILD)
    assert torch.equal(tm2.index.values, rebuilt.values)
    assert torch.equal(tm2.index.indices, rebuilt.indices)
    assert torch.equal(tm2.touch.bits, rstats["touch"])
    # the inputs are not changed
    _equal(tm.index.values, jm.index.values)
    _equal(tm.touch.bits, jm.touch.bits)


def test_repair_of_the_ragged_tail_matches_reference(graphs, maintained):
    """An insert from a vertex of the last, 24-row chunk (padded with
    source 0) repairs that chunk as the reference does."""
    jg, tg = graphs
    jm, tm, _ = maintained
    ins = np.array([[1023, 1], [1010, 4]])
    _, jm2, want = jupdates.apply_updates(jm, jg, inserts=ins)
    _, tm2, got = tupdates.apply_updates(tm, tg, inserts=ins)
    assert 25 in got["dirty_row_ids"] // 40
    assert got["rows_replaced"] == want["rows_replaced"]
    _equal(tm2.index.values, jm2.index.values)
    _equal(tm2.touch.bits, jm2.touch.bits)


def test_apply_updates_noop_and_wrong_graph(graphs, maintained):
    _, tm, _ = maintained
    g2, m2, report = tupdates.apply_updates(tm, graphs[1])
    assert m2 is tm and g2 is graphs[1]
    assert report["repaired_chunks"] == report["dirty_rows"] == 0
    other = tsyn.rmat(9, avg_deg=6.0, seed=3, device="cpu")
    with pytest.raises(ValueError, match="built on"):
        tupdates.apply_updates(tm, other, inserts=np.array([[0, 1]]))


def test_sharded_repair_matches_sharded_rebuild(graphs):
    """The padded sharded grid (1,024 vertices over 3 shards of 360 rows,
    56 pad rows) on a 2 x 3 stacked mesh: repair sweeps the build's
    chunks with its keys, pad rows zeroed; equal to a sharded rebuild on
    the mutated graph, bit for bit."""
    tg = graphs[1]
    mesh = ShardMesh(data=2, model=3, device="cpu")
    kw = dict(r=8, l=16, source_batch=40, c=0.25, touch_bits=1024)
    m, stats = tupdates.build_maintainable_index(
        tg, key=rng.prng_key(9), mesh=mesh, **kw)
    assert m.index.n == stats["n_pad"] == 1080 and m.params.r_splits == 2
    ins = np.array([[1000, 5], [1079 - 56, 3]])
    g2, m2, report = tupdates.apply_updates(m, tg, inserts=ins)
    assert 0 < report["repaired_chunks"] < report["total_chunks"] == 27
    assert report["dirty_row_ids"].max() < tg.n
    ref, rstats = tindex.build_index_sharded(
        g2, key=rng.prng_key(9), mesh=mesh, respawn=False, **kw)
    assert torch.equal(m2.index.values, ref.values)
    assert torch.equal(m2.index.indices, ref.indices)
    assert torch.equal(m2.touch.bits, rstats["touch"])
    assert not bool(m2.touch.bits[tg.n:].any())


# -- the service -----------------------------------------------------------------

def _service(tg, m, capacity=64):
    cfg = ServiceConfig(
        query=QueryConfig(t_iterations=2, top_k=10, hub_split_degree=64),
        batching=BatchingConfig(max_batch=8, max_wait_s=10.0),
        cache=CacheConfig(capacity=capacity))
    return PPRService(tg, None, cfg, device="cpu", maintainer=m)


def _answers(svc, vertices):
    answers, _ = svc.run_closed_loop(vertices)
    return {a.vertex: (a.top_vertices, a.top_scores, a.cached)
            for a in answers}


def test_service_apply_updates_invalidates_exactly(graphs, maintained,
                                                   deletes):
    tg = graphs[1]
    _, tm, _ = maintained
    svc = _service(tg, tm)
    vertices = list(range(0, 1024, 16))
    before = _answers(svc, vertices)
    assert len(svc.cache) == len(vertices)
    epoch = svc.cache.epoch
    report = svc.apply_updates(inserts=INSERTS, deletes=deletes)
    dirty = set(report["dirty_row_ids"].tolist())
    stale = [v for v in vertices if v in dirty]
    assert 0 < len(stale) < len(vertices)
    assert report["cache_invalidated"] == len(stale)
    assert len(svc.cache) == len(vertices) - len(stale)
    assert svc.cache.epoch > epoch
    assert svc.stats["updates_applied"] == 1
    assert svc.stats["rows_repaired"] == report["dirty_rows"]
    assert svc.pipeline.engine is svc.engine
    # the repaired rows' answers are recomputed on the new graph and
    # index; the others are served from the cache, unchanged
    _, m2, _ = tupdates.apply_updates(tm, tg, INSERTS, deletes)
    fresh = _service(svc.graph, m2, capacity=0)
    got, want = _answers(svc, vertices), _answers(fresh, stale)
    for v in vertices:
        assert got[v][2] == (v not in dirty)
        old = want[v] if v in dirty else before[v]
        _equal(torch.from_numpy(got[v][0]), old[0])
        _equal(torch.from_numpy(got[v][1]), old[1])


@pytest.mark.parametrize("failure", ["bad_delete", "engine"])
def test_service_apply_updates_rolls_back(graphs, maintained, monkeypatch,
                                          failure):
    tg = graphs[1]
    _, tm, _ = maintained
    svc = _service(tg, tm)
    vertices = list(range(3, 1024, 64))
    before = _answers(svc, vertices)
    state = (svc.graph, svc.maintainer, svc.engine, svc.cache.epoch,
             len(svc.cache))
    if failure == "bad_delete":
        present = set(map(tuple, _edges(tg).tolist()))
        missing = next((5, d) for d in range(tg.n) if (5, d) not in present)
        kwargs = dict(inserts=INSERTS, deletes=np.array([missing]))
        err = ValueError
    else:
        class Boom(RuntimeError):
            pass

        def boom(*args, **kw):
            raise Boom("engine construction failed")
        monkeypatch.setattr("repro_torch.serving.engine.BatchQueryEngine",
                            boom)
        kwargs = dict(inserts=INSERTS)
        err = Boom
    with pytest.raises(err):
        svc.apply_updates(**kwargs)
    monkeypatch.undo()
    assert svc.stats["update_rollbacks"] == 1
    assert svc.stats["updates_applied"] == 0
    assert (svc.graph, svc.maintainer, svc.engine, svc.cache.epoch,
            len(svc.cache)) == state
    after = _answers(svc, vertices)
    for v in vertices:
        _equal(torch.from_numpy(after[v][1]), before[v][1])


def test_service_without_maintainer_refuses_updates(graphs, maintained):
    _, tm, _ = maintained
    svc = PPRService(graphs[1], tm.index, device="cpu")
    with pytest.raises(ValueError, match="maintainer"):
        svc.apply_updates(inserts=INSERTS)
