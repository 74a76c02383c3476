"""The port's Monte-Carlo path against the reference's, on the CPU.

``rng.randint``, the dense walk engine, the MCFP and MCEP estimators (dense
and sparse), the legacy index build, Theorem 2.1's planner, the memory
planner, the ``mcfp`` serving mode, the COO helpers of ``graphs.formats``
and the distributed ``make_walk_counts_step``.  Both packages get the same
graph (the same numpy generator) and the same key; every comparison is
bit for bit (float bits, integer words) unless a test says otherwise.  The
reference's four-shard walk-counts step runs in a subprocess with four
fake host devices (this file, run as a script).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed_engine as jde
from repro.core import index as jindex
from repro.core import mcep as jmcep
from repro.core import mcfp as jmcfp
from repro.core import query as jquery
from repro.core import theory as jtheory
from repro.core import walks as jwalks
from repro.core.graph import Graph as JGraph
from repro.graphs import formats as jformats
from repro.graphs import synthetic as jsyn
from repro.serving import PPRService as JService
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving.batching import BatchingConfig as JBatching
from repro_torch import convert, rng
from repro_torch.core import distributed_engine as tde
from repro_torch.core import index as tindex
from repro_torch.core import mcep as tmcep
from repro_torch.core import mcfp as tmcfp
from repro_torch.core import query as tquery
from repro_torch.core import theory as ttheory
from repro_torch.core import walks as twalks
from repro_torch.distributed import ShardMesh
from repro_torch.graphs import formats as tformats
from repro_torch.serving import PPRService, ServiceConfig
from repro_torch.serving.batching import BatchingConfig
from repro_torch.serving.pipeline import PipelineConfig

torch.set_num_threads(1)

SOURCES = np.array([0, 1, 5, 17, 64, 100, 333, 511, 700, 1023], np.int32)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want)
    assert np.array_equal(_bits(got), _bits(want))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _port_graph(g):
    return convert.graph_from_arrays(
        g.row_ptr, g.col_idx, g.src, g.out_deg, g.n, g.m, device="cpu")


def _keys(seed=4, fold=None):
    key = jax.random.PRNGKey(seed)
    if fold is not None:
        key = jax.random.fold_in(key, fold)
    return key, convert.key_from_array(jax.random.key_data(key))


@pytest.fixture(scope="module")
def graphs():
    """rmat(10): hubs (max out-degree 214) and 371 dangling vertices."""
    g = jsyn.rmat(10, avg_deg=6.0, seed=1)
    deg = np.asarray(g.out_deg)
    assert deg.max() > 100 and (deg == 0).sum() > 100
    return g, _port_graph(g)


@pytest.fixture(scope="module")
def tail_dangling():
    """A graph whose last vertices are dangling: their CSR slot lies at
    ``m``, past the last edge, which a move must never read."""
    src = np.array([0, 0, 0, 1, 2, 2, 3, 4, 4, 4, 4])
    dst = np.array([1, 2, 5, 3, 0, 6, 7, 0, 1, 2, 3])
    g = JGraph.from_edges(src, dst, n=8)
    assert np.asarray(g.row_ptr)[-1] == np.asarray(g.row_ptr)[5] == g.m
    return g, _port_graph(g)


# -- rng.randint ----------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [
    (0, 1), (0, 2), (0, 3), (0, 7), (0, 1 << 16), (0, (1 << 16) + 1),
    (3, 70000), (0, 1 << 20), (0, 2**31 - 1), (-100, 100),
    (-2**31, 2**31 - 1), (5, 5), (7, 3), (-4, -9),
])
@pytest.mark.parametrize("shape", [(1000,), (6, 7)])
def test_randint_bitwise(lo, hi, shape):
    """Spans of 1, 2, 3, 2**16 + 1 (the uint32 product wraps) and 2**31 -
    1, ``maxval <= minval`` (always ``minval``), and a span of 2**32 - 1."""
    key, tkey = _keys(3, fold=11)
    want = jax.random.randint(key, shape, lo, hi, dtype=jnp.int32)
    got = rng.randint(tkey, shape, lo, hi)
    assert got.dtype == torch.int32
    _same(got, want)


@pytest.mark.parametrize("top", [1, 300, 1 << 20, 2**31 - 1])
def test_randint_array_maxval_bitwise(top):
    """One ``maxval`` per draw, as a walk move draws ``[0, max(deg, 1))``,
    zeros included."""
    r = np.random.default_rng(top % 97)
    maxval = r.integers(0, top, 2000, endpoint=True).astype(np.int32)
    maxval[:5] = 0
    key, tkey = _keys(8)
    want = jax.random.randint(key, (2000,), 0, jnp.maximum(maxval, 1))
    got = rng.randint(tkey, (2000,), 0, torch.clamp(_t(maxval), min=1))
    _same(got, want)


def test_randint_batched_keys_bitwise():
    key, tkey = _keys(5)
    keys = jax.random.split(key, 3)
    tkeys = rng.split(tkey, 3)
    want = jax.vmap(lambda k: jax.random.randint(k, (40,), 2, 70001))(keys)
    _same(rng.randint(tkeys, (40,), 2, 70001), want)


# -- the dense walk engine --------------------------------------------------------

def _walk_counts(jg, tg, sources, r, seed, **kw):
    key, tkey = _keys(seed)
    ws, wr = jwalks.walks_for_sources(jnp.asarray(sources), r)
    want = jwalks.simulate_walks(jg, ws, wr, key, n_rows=len(sources), **kw)
    tws, twr = twalks.walks_for_sources(_t(sources), r)
    got = twalks.simulate_walks(tg, tws, twr, tkey, n_rows=len(sources),
                                **kw)
    return got, want


@pytest.mark.parametrize("r,kw", [
    (50, {}), (7, dict(c=0.3, max_steps=20)), (1, dict(max_steps=3)),
])
def test_simulate_walks_bitwise(graphs, r, kw):
    jg, tg = graphs
    got, want = _walk_counts(jg, tg, SOURCES, r, seed=r, **kw)
    for name in ("fp_counts", "ep_counts", "moves", "walks"):
        _same(getattr(got, name), getattr(want, name))
    assert np.all(got.walks.numpy() == r)
    assert torch.equal(got.fp_counts.sum(dim=1), got.moves)


def test_simulate_walks_dangling_past_last_edge(tail_dangling):
    jg, tg = tail_dangling
    got, want = _walk_counts(jg, tg, np.arange(8, dtype=np.int32), 20, 2)
    for name in ("fp_counts", "ep_counts", "moves", "walks"):
        _same(getattr(got, name), getattr(want, name))


def test_walks_for_sources_and_walk_lengths():
    src = np.array([4, 0, 9], np.int32)
    want = jwalks.walks_for_sources(jnp.asarray(src), 5)
    got = twalks.walks_for_sources(_t(src), 5)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        _same(a, b)
    for c, steps in ((0.15, 64), (0.5, 10)):
        key, tkey = _keys(6)
        _same(twalks.sample_walk_lengths(tkey, 3000, c, steps),
              jwalks.sample_walk_lengths(key, 3000, c, steps))


# -- the estimators ---------------------------------------------------------------

@pytest.mark.parametrize("mods", [(jmcfp, tmcfp), (jmcep, tmcep)],
                         ids=["mcfp", "mcep"])
def test_dense_estimators_bitwise(graphs, mods):
    jg, tg = graphs
    jm, tm = mods
    key, tkey = _keys(9)
    want = jm.estimate_ppr(jg, jnp.asarray(SOURCES), 40, key)
    got = tm.estimate_ppr(tg, _t(SOURCES), 40, tkey)
    _same(got, want)


@pytest.mark.parametrize("mods", [(jmcfp, tmcfp), (jmcep, tmcep)],
                         ids=["mcfp", "mcep"])
@pytest.mark.parametrize("l", [300, 24])      # covering, truncating
def test_sparse_estimators_bitwise(graphs, mods, l):
    jg, tg = graphs
    jm, tm = mods
    key, tkey = _keys(10)
    want = jm.estimate_ppr_sparse(jg, jnp.asarray(SOURCES), 40, key, l=l)
    got = tm.estimate_ppr_sparse(tg, _t(SOURCES), 40, tkey, l=l)
    assert (got.k, got.n) == (want.k, want.n)
    _same(got.values, want.values)
    _same(got.indices, want.indices)


def test_estimate_ppr_batched_ragged_tail(graphs):
    """23 sources in chunks of 8: the tail pads with vertex 0, and the
    stats are there before the first chunk is consumed."""
    jg, tg = graphs
    key, tkey = _keys(12)
    src = np.arange(100, 123, dtype=np.int32)
    jstats, tstats = {}, {}
    want = jmcfp.estimate_ppr_batched(jg, src, 16, key, source_batch=8,
                                      stats=jstats)
    got = tmcfp.estimate_ppr_batched(tg, src, 16, tkey, source_batch=8,
                                     stats=tstats)
    assert tstats == jstats == dict(pad_rows=1, pad_fraction=1 / 24)
    chunks = list(zip(got, want))
    assert [len(g[0]) for g, _ in chunks] == [8, 8, 7]
    for (gids, gest), (wids, west) in chunks:
        assert np.array_equal(gids, wids)
        _same(gest, west)


# -- the legacy index build -------------------------------------------------------

@pytest.mark.parametrize("case", ["all", "subset"])
def test_build_index_legacy_bitwise(graphs, case):
    """Values and indices bit for bit; the f32 mass totals sum in another
    order, so the total and kept mass agree within 1e-6 relative, the
    dropped mass within 1e-6 of the total."""
    jg, tg = graphs
    key, tkey = _keys(13)
    kw = dict(r=12, l=32, source_batch=256)
    if case == "subset":   # duplicates and a ragged tail of 3
        src = np.concatenate([np.arange(0, 1000, 3), [3, 6, 999]])
        kw.update(sources=src, source_batch=64)
    want, wstats = jindex.build_index(jg, key=key, engine="legacy", **kw)
    got, stats = tindex.build_index(tg, key=tkey, engine="legacy",
                                    device="cpu", **kw)
    assert (got.n, got.l) == (want.n, want.l)
    _same(got.values, want.values)
    _same(got.indices, want.indices)
    assert stats.keys() == wstats.keys()
    for k in ("pad_rows", "pad_fraction", "r", "l", "engine",
              "duplicate_sources", "nbytes"):
        assert stats[k] == wstats[k], k
    total = wstats["kept_mass"] + wstats["dropped_mass"]
    assert stats["kept_mass"] + stats["dropped_mass"] == pytest.approx(
        total, rel=1e-6)
    assert stats["kept_mass"] == pytest.approx(wstats["kept_mass"], rel=1e-6)
    assert abs(stats["dropped_mass"] - wstats["dropped_mass"]) <= 1e-6 * total
    assert stats["drop_fraction"] == pytest.approx(wstats["drop_fraction"],
                                                   abs=1e-6)


def test_build_index_legacy_rejects_sparse_options(graphs):
    _, tg = graphs
    for kw in (dict(r_splits=2), dict(respawn=True)):
        with pytest.raises(ValueError, match="sparse engine"):
            tindex.build_index(tg, r=4, l=8, key=rng.prng_key(0),
                               engine="legacy", device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        tindex.build_index(tg, r=4, l=8, key=rng.prng_key(0),
                           engine="bogus", device="cpu")


# -- Theorem 2.1 and the memory planner -------------------------------------------

@pytest.mark.parametrize("c", [0.15, 0.3])
def test_theory_functions_equal(c):
    for gamma in (0.0, 0.01, 0.1, 0.5):
        for r in (1, 100, 1000, 20000):
            for name in ("overestimate_bound", "two_sided_bound",
                         "index_error_bound"):
                assert getattr(ttheory, name)(gamma, r, c) == \
                    getattr(jtheory, name)(gamma, r, c), name
    for gamma in (0.01, 0.05, 0.2):
        for delta in (0.01, 0.1, 0.5):
            assert ttheory.walks_required(gamma, delta, c) == \
                jtheory.walks_required(gamma, delta, c)
    for r in (1, 100, 1000):
        assert ttheory.mcep_equivalent_walks(r, c) == \
            jtheory.mcep_equivalent_walks(r, c)
    assert ttheory.mcep_equivalent_walks(1000) == 6667
    assert ttheory.expected_walk_length(c) == jtheory.expected_walk_length(c)
    for tail in (1e-2, 1e-5):
        assert ttheory.max_steps_for_tail(tail, c) == \
            jtheory.max_steps_for_tail(tail, c)
    for t in (0, 2, 7):
        assert ttheory.verd_error_factor(t, c) == \
            jtheory.verd_error_factor(t, c)
    with pytest.raises(ValueError):
        ttheory.overestimate_bound(-1.0, 10)
    with pytest.raises(ValueError):
        ttheory.walks_required(0.1, 1.0)


@pytest.mark.parametrize("n", [1 << 10, 1 << 20, 41_652_230])
@pytest.mark.parametrize("budget", [1 << 20, 1 << 30, 20 << 30, 80 << 30])
@pytest.mark.parametrize("respawn", [True, False])
def test_planner_equals_reference(n, budget, respawn):
    got = tindex.plan_for_budget(n, budget, respawn=respawn)
    want = jindex.plan_for_budget(n, budget, respawn=respawn)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for r in (0, 1, got.r, 100, 1000):
        kw = dict(respawn=respawn, source_batch=512)
        assert tindex.walk_state_cost(r, **kw) == \
            jindex.walk_state_cost(r, **kw)
    for r in (1, 100, max(got.r, 1)):
        assert tindex.preprocessing_cost_model(n, r, respawn=respawn) == \
            jindex.preprocessing_cost_model(n, r, respawn=respawn)


# -- the mcfp serving mode ----------------------------------------------------------

def _engines(jg, tg, **kw):
    cfg = dict(mode="mcfp", top_k=16, r_online=60, seed=7, **kw)
    return (jquery.BatchQueryEngine(jg, None, jquery.QueryConfig(**cfg)),
            tquery.BatchQueryEngine(tg, None, tquery.QueryConfig(**cfg),
                                    device="cpu"))


def test_mcfp_mode_dispatch_keys_bitwise(graphs):
    jg, tg = graphs
    je, te = _engines(jg, tg)
    assert not te.uses_sparse_path()
    for seq in range(3):
        _same(te.dispatch_key(seq), jax.random.key_data(je.dispatch_key(seq)))
        want = je.query_topk_async(jnp.asarray(SOURCES),
                                   key=je.dispatch_key(seq))
        got = te.query_topk_async(SOURCES, key=te.dispatch_key(seq))
        _same(got[0], want[0])
        _same(got[1], want[1])
    # without a key: the base key (async), then the stateful split
    _same(te.query_topk_async(SOURCES)[0], je.query_topk_async(
        jnp.asarray(SOURCES))[0])
    for _ in range(2):
        _same(te.query_dense(SOURCES), je.query_dense(jnp.asarray(SOURCES)))


def test_mcfp_mode_run_folds_chunk_offsets(graphs):
    jg, tg = graphs
    je, te = _engines(jg, tg, max_batch=4)
    want = je.run(SOURCES)
    got = te.run(SOURCES)
    _same(got["values"], want["values"])
    _same(got["indices"], want["indices"])
    again = tquery.BatchQueryEngine(tg, None, te.config, device="cpu")
    _same(again.run(SOURCES)["values"], want["values"])


def test_mcfp_mode_refuses_seed_sets(graphs):
    jg, tg = graphs
    with pytest.raises(ValueError, match="seed-set"):
        tquery.BatchQueryEngine(tg, None, tquery.QueryConfig(
            mode="mcfp", max_seeds=4), device="cpu")
    _, te = _engines(jg, tg)
    seeds = np.array([[1, 2]], np.int32)
    weights = np.ones((1, 2), np.float32)
    for call in (te.query_dense, te.query_topk, te.query_topk_async):
        with pytest.raises(ValueError, match="seed-set"):
            call(seeds, weights=weights)


def _served(svc, work):
    answers, _ = svc.run_closed_loop(work)
    by_id = sorted(answers, key=lambda a: a.request_id)
    return [np.stack([getattr(a, k) for a in by_id])
            for k in ("top_scores", "top_vertices")]


def test_mcfp_service_matches_reference_at_depths_1_and_4(graphs):
    """The service folds each dispatch's sequence number into the key: at
    depths 1 and 4 the port gives the reference's bytes (three full
    batches of 8, dispatched by size)."""
    jg, tg = graphs
    work = [int(v) for v in np.random.default_rng(3).integers(0, jg.n, 24)]
    q = dict(mode="mcfp", top_k=16, r_online=40, seed=5)
    jsvc = JService(jg, None, JServiceConfig(
        query=jquery.QueryConfig(**q),
        batching=JBatching(max_batch=8, max_wait_s=60.0)))
    want = _served(jsvc, work)
    for depth in (1, 4):
        svc = PPRService(tg, None, ServiceConfig(
            query=tquery.QueryConfig(**q),
            batching=BatchingConfig(max_batch=8, max_wait_s=60.0),
            pipeline=PipelineConfig(depth=depth)), device="cpu")
        got = _served(svc, work)
        for a, b in zip(got, want):
            _same(a, b)


# -- graphs.formats ---------------------------------------------------------------

def test_coo_sorted_by_dst_and_pad_edges(graphs):
    jg, tg = graphs
    for a, b in zip(tformats.to_coo_sorted_by_dst(tg),
                    jformats.to_coo_sorted_by_dst(jg)):
        _same(a, b)
    for multiple in (1, 7, 128, 4096):
        want = jformats.pad_edges(jg, multiple)
        got = tformats.pad_edges(tg, multiple)
        assert (got.n, got.m) == (want.n, want.m)
        for name in ("row_ptr", "col_idx", "src", "out_deg"):
            _same(getattr(got, name), getattr(want, name))


# -- the distributed walk-counts step ------------------------------------------------

WALK_SOURCES = np.array([0, 3, 7, 11], np.int32)
WALK_R = 64


def _walk_counts_inputs():
    g = jsyn.rmat(10, avg_deg=6.0, seed=1)
    ws = np.repeat(WALK_SOURCES, WALK_R)
    wr = np.repeat(np.arange(len(WALK_SOURCES), dtype=np.int32), WALK_R)
    return g, ws, wr


def _reference_walk_counts(data, model):
    g, ws, wr = _walk_counts_inputs()
    cfg = jde.DistConfig(n=g.n, ep=model, q_tile=len(WALK_SOURCES))
    mesh = jax.make_mesh((data, model), ("data", "model"))
    fn = jde.make_walk_counts_step(cfg, mesh, max_steps=32)
    with mesh:
        fp, moves = jax.jit(fn)(g.row_ptr, g.col_idx, g.out_deg,
                                jnp.asarray(ws), jnp.asarray(wr),
                                jax.random.PRNGKey(2))
    return np.asarray(fp), np.asarray(moves)


def _port_walk_counts(data, model):
    g, ws, wr = _walk_counts_inputs()
    tg = _port_graph(g)
    cfg = tde.DistConfig(n=g.n, ep=model, q_tile=len(WALK_SOURCES))
    fn = tde.make_walk_counts_step(cfg, ShardMesh(data, model, device="cpu"),
                                   max_steps=32)
    return fn(tg.row_ptr, tg.col_idx, tg.out_deg, _t(ws), _t(wr),
              rng.prng_key(2))


def test_walk_counts_step_one_shard_bitwise():
    fp, moves = _port_walk_counts(1, 1)
    want_fp, want_moves = _reference_walk_counts(1, 1)
    _same(fp, want_fp)
    _same(moves, want_moves)


def test_walk_counts_step_four_shards_bitwise(tmp_path):
    """A 2 x 2 mesh: two data replicas of 128 walks, two vertex intervals.
    The reference runs in a subprocess with four fake host devices."""
    out = tmp_path / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    want = np.load(out)
    fp, moves = _port_walk_counts(2, 2)
    _same(fp, want["fp"])
    _same(moves, want["moves"])
    assert float(moves.sum()) == float(fp.sum()) > 0
    # the two replicas walk different streams: not twice one replica
    one_fp, _ = _port_walk_counts(1, 2)
    assert not torch.equal(fp, 2 * one_fp)


def test_walk_counts_step_rejects_uneven_walks():
    g, ws, wr = _walk_counts_inputs()
    tg = _port_graph(g)
    cfg = tde.DistConfig(n=g.n, ep=1, q_tile=4)
    fn = tde.make_walk_counts_step(cfg, ShardMesh(3, 1, device="cpu"))
    with pytest.raises(ValueError, match="data shards"):
        fn(tg.row_ptr, tg.col_idx, tg.out_deg, _t(ws), _t(wr),
           rng.prng_key(0))
    with pytest.raises(ValueError, match="'model' shards"):
        tde.make_walk_counts_step(tde.DistConfig(n=g.n, ep=2, q_tile=4),
                                  ShardMesh(1, 1, device="cpu"))


if __name__ == "__main__":
    assert jax.device_count() == 4, jax.devices()
    fp_, moves_ = _reference_walk_counts(2, 2)
    np.savez(sys.argv[1], fp=fp_, moves=moves_)
