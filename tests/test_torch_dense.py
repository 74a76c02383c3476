"""The dense route of the port against the reference, on the CPU.

The ELL view, the dense push and combine (the plain versions of the
``ell_spmm`` and dense ``index_combine`` kernels), dense VERD, the
baselines, the metrics and the engine's dense answers are held against
the JAX package on the same numpy-seeded inputs: integer outputs exactly,
float answers within 1e-5 L1 per row, kernel-level comparisons at the
reference's own ``rtol=1e-4, atol=1e-5``.  The reference's Pallas kernels
run in interpret mode, as its own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import densify_rows
from repro.core import graph as jgraph
from repro.core import index as jindex
from repro.core import metrics as jmetrics
from repro.core import power_iteration as jpi
from repro.core import query as jquery
from repro.core import verd as jverd
from repro.graphs import formats as jfmt
from repro.graphs import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import PPRService as JService
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving.batching import BatchingConfig as JBatching
from repro_torch import convert, rng
from repro_torch.core import graph as tgraph
from repro_torch.core import index as tindex
from repro_torch.core import metrics as tmetrics
from repro_torch.core import power_iteration as tpi
from repro_torch.core import query as tquery
from repro_torch.core import verd as tverd
from repro_torch.core.frontier import topk_dense
from repro_torch.graphs import formats as tfmt
from repro_torch.graphs import synthetic as tsyn
from repro_torch.kernels import ell_spmm as tell
from repro_torch.kernels import index_combine as tcomb
from repro_torch.kernels import ops as tops
from repro_torch.serving import CacheConfig, PPRService, ServiceConfig
from repro_torch.serving.batching import BatchingConfig
from repro_torch.serving.pipeline import PipelineConfig

torch.set_num_threads(1)
TOL = 1e-5
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def _graphs(name):
    """The same graph in both packages (same generator, same seed)."""
    if name == "rmat":
        return (jsyn.rmat(11, avg_deg=8.0, seed=2),
                tsyn.rmat(11, avg_deg=8.0, seed=2, device="cpu"))
    if name == "er":
        return (jsyn.erdos_renyi(600, 4.0, seed=3),
                tsyn.erdos_renyi(600, 4.0, seed=3, device="cpu"))
    if name == "star":
        return jsyn.star(50), tsyn.star(50, device="cpu")
    raise ValueError(name)


def _row_l1(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum(axis=-1).max())


@pytest.fixture(scope="module")
def setup():
    jg, tg = _graphs("rmat")
    jidx, _ = jindex.build_index(jg, r=16, l=32, key=jax.random.PRNGKey(4),
                                 source_batch=1024)
    tidx = convert.index_from_arrays(jidx.values, jidx.indices, device="cpu")
    return jg, tg, jidx, tidx


# -- the ELL view and the push ------------------------------------------------

@pytest.mark.parametrize("name", ["rmat", "er", "star"])
@pytest.mark.parametrize("k,pad", [(4, 1), (16, 1), (32, 1), (8, 256)])
def test_to_ell_chunks_bit_equal(name, k, pad):
    jg, tg = _graphs(name)
    je = jfmt.to_ell_chunks(jg, k=k, pad_rows_to=pad)
    te = tfmt.to_ell_chunks(tg, k=k, pad_rows_to=pad)
    assert (te.rows, te.k, te.n) == (je.rows, je.k, je.n)
    for field in ("nbr", "weight", "row2vertex"):
        want = np.asarray(getattr(je, field))
        got = getattr(te, field).numpy()
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), field
    r2v = te.row2vertex[:te.rows_used].numpy()
    vr = te.vertex_rows.numpy()
    assert vr[-1] == te.rows_used and np.all(np.diff(r2v) >= 0)
    assert np.array_equal(np.repeat(np.arange(te.n), np.diff(vr)), r2v)


@pytest.mark.parametrize("q,rows,k,n", [
    (8, 256, 8, 64), (16, 512, 16, 128), (8, 256, 4, 32), (24, 768, 32, 200),
])
def test_ell_spmm_plain_matches_reference_oracle(q, rows, k, n):
    r = np.random.default_rng(q * rows + k)
    f = r.random((q, n)).astype(np.float32)
    nbr = r.integers(0, n, (rows, k)).astype(np.int32)
    w = r.random((rows, k)).astype(np.float32)
    want = np.asarray(jref.ell_spmm_ref(jnp.asarray(f), jnp.asarray(nbr),
                                        jnp.asarray(w)))
    np.testing.assert_allclose(
        tell.ell_spmm_partial_plain(_t(f), _t(nbr), _t(w)).numpy(), want,
        **KERNEL_TOL)
    # one row per vertex: the folded form is the partials themselves
    ident = torch.arange(rows + 1, dtype=torch.int32)
    folded = tell.ell_spmm_plain(_t(f), _t(nbr), _t(w), ident[:-1], ident,
                                 rows_used=rows)
    np.testing.assert_allclose(folded.numpy(), want, **KERNEL_TOL)


def test_ell_spmm_plain_chunks_like_one_gather(monkeypatch):
    """Row blocks of the plain version (what bounds its memory at full
    size) do not change the result."""
    jg, tg = _graphs("rmat")
    ell = tg.ell()
    f = _t(np.random.default_rng(0).random((3, tg.n)).astype(np.float32))
    whole = tfmt.ell_pull(ell, f)
    monkeypatch.setattr(tell, "PLAIN_BLOCK_ELEMS", 3 * ell.k * 37)
    np.testing.assert_allclose(tops.ell_push(f, ell).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["rmat", "er", "star"])
def test_ell_push_matches_reference_push(name):
    jg, tg = _graphs(name)
    f = np.random.default_rng(5).random((5, jg.n)).astype(np.float32)
    if name == "star":
        f[:] = 1.0                          # the hub folds 49 spokes
    want_push = np.asarray(jgraph.push_forward(jg, jnp.asarray(f)))
    want_kernel = np.asarray(jops.ell_push(
        jnp.asarray(f), jfmt.to_ell_chunks(jg, k=4), interpret=True))
    tops.reset_launch_counts()
    got = tops.ell_push(_t(f), tfmt.to_ell_chunks(tg, k=4)).numpy()
    assert tops.launch_counts()["ell_spmm"] == 0   # CPU: the plain version
    np.testing.assert_allclose(got, want_push, **KERNEL_TOL)
    np.testing.assert_allclose(got, want_kernel, **KERNEL_TOL)
    got = tgraph.push_forward(tg, _t(f)).numpy()   # the graph's cached view
    np.testing.assert_allclose(got, want_push, **KERNEL_TOL)


def test_graph_ell_view_is_built_once():
    _, tg = _graphs("er")
    assert tg.ell() is tg.ell()
    assert tg.ell(k=8) is not tg.ell() and tg.ell(k=8).k == 8


def test_graph_dense_helpers_match_reference():
    jg, tg = _graphs("rmat")
    assert np.array_equal(tg.dangling_mask.numpy(),
                          np.asarray(jg.dangling_mask))
    assert np.array_equal(tg.inv_out_deg.numpy(), np.asarray(jg.inv_out_deg))
    assert np.array_equal(tg.edge_weight.numpy(), np.asarray(jg.edge_weight))
    v = int(np.argmax(np.asarray(jg.out_deg)))
    assert np.array_equal(tg.out_neighbors(v), jg.out_neighbors(v))
    jr, tr = jgraph.reverse(jg), tgraph.reverse(tg)
    for field in ("row_ptr", "col_idx", "src", "out_deg"):
        assert np.array_equal(getattr(tr, field).numpy(),
                              np.asarray(getattr(jr, field)))
    js, ts = _graphs("star")
    for source in (None, 3):
        assert np.array_equal(ts.dense_transition(source),
                              js.dense_transition(source))
    adj = (np.random.default_rng(1).random((12, 12)) < 0.3).astype(np.int8)
    jd, td = jgraph.Graph.from_dense(adj), tgraph.Graph.from_dense(
        adj, device="cpu")
    assert np.array_equal(td.col_idx.numpy(), np.asarray(jd.col_idx))
    assert np.array_equal(td.row_ptr.numpy(), np.asarray(jd.row_ptr))


@pytest.mark.parametrize("seeds", [False, True])
def test_transition_with_dangling_matches_reference(seeds):
    jg, tg = _graphs("rmat")
    r = np.random.default_rng(6)
    q = 6
    f = r.random((q, jg.n)).astype(np.float32)
    if seeds:
        src = r.integers(0, jg.n, (q, 3)).astype(np.int32)
        src[0, 2] = src[0, 0]                       # a duplicate seed
        w = r.random((q, 3)).astype(np.float32)
        want = jgraph.transition_with_dangling_seeds(
            jg, jnp.asarray(f), jnp.asarray(src), jnp.asarray(w))
        got = tgraph.transition_with_dangling_seeds(tg, _t(f), _t(src), _t(w))
    else:
        src = r.integers(0, jg.n, q).astype(np.int32)
        want = jgraph.transition_with_dangling(jg, jnp.asarray(f),
                                               jnp.asarray(src))
        got = tgraph.transition_with_dangling(tg, _t(f), _t(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(
        tgraph.dangling_mass(tg, _t(f)).numpy(),
        np.asarray(jgraph.dangling_mass(jg, jnp.asarray(f))), rtol=1e-6)


# -- the dense combine ---------------------------------------------------------

@pytest.mark.parametrize("q,n,l", [(8, 128, 8), (16, 256, 16), (4, 64, 4),
                                   (5, 100, 7)])
def test_index_combine_matches_reference_kernel(q, n, l):
    r = np.random.default_rng(q + n + l)
    s, f = (r.random((q, n)).astype(np.float32) for _ in range(2))
    f[0] = 0.0                                       # an all-zero row
    f[f < 0.3] = 0.0
    vals = r.random((n, l)).astype(np.float32)
    idx = r.integers(0, n, (n, l)).astype(np.int32)
    idx[:3] = 1                                      # duplicate columns
    args = [jnp.asarray(x) for x in (s, f, vals, idx)]
    want_kernel = np.asarray(jops.index_combine(*args, interpret=True))
    want_oracle = np.asarray(jref.index_combine_ref(*args))
    tops.reset_launch_counts()
    got = tops.index_combine(_t(s), _t(f), _t(vals), _t(idx)).numpy()
    assert tops.launch_counts()["index_combine"] == 0
    np.testing.assert_allclose(got, want_kernel, **KERNEL_TOL)
    np.testing.assert_allclose(got, want_oracle, **KERNEL_TOL)


def test_index_combine_plain_chunks_and_drops_out_of_range(monkeypatch):
    r = np.random.default_rng(2)
    q, n, l = 3, 50, 6
    s, f = (r.random((q, n)).astype(np.float32) for _ in range(2))
    vals = r.random((n, l)).astype(np.float32)
    idx = r.integers(0, n + 5, (n, l)).astype(np.int32)   # some past n
    want = np.asarray(jref.index_combine_ref(*(jnp.asarray(x) for x in (
        s, f, vals, idx))))
    monkeypatch.setattr(tcomb, "PLAIN_BLOCK_ELEMS", q * l * 7)
    got = tcomb.index_combine_plain(_t(s), _t(f), _t(vals), _t(idx))
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_combine_with_index_matches_reference(setup):
    jg, tg, jidx, tidx = setup
    r = np.random.default_rng(3)
    s = r.random((6, jg.n)).astype(np.float32)
    f = r.random((6, jg.n)).astype(np.float32)
    f[f < 0.9] = 0.0
    want = jverd.combine_with_index(jnp.asarray(s), jnp.asarray(f), jidx)
    got = tverd.combine_with_index(_t(s), _t(f), tidx)
    assert _row_l1(got.numpy(), want) <= TOL
    # an index with more rows than the graph (a padded index)
    pad = convert.index_from_arrays(
        np.pad(np.asarray(jidx.values), ((0, 9), (0, 0))),
        np.pad(np.asarray(jidx.indices), ((0, 9), (0, 0))), device="cpu")
    assert _row_l1(tverd.combine_with_index(_t(s), _t(f), pad).numpy(),
                   want) <= TOL


# -- dense VERD, the baselines and the oracles ---------------------------------

@pytest.mark.parametrize("seeds", [False, True])
@pytest.mark.parametrize("threshold", [0.0, 1e-3])
@pytest.mark.parametrize("t", [1, 3])
def test_verd_iterate_matches_reference(setup, seeds, threshold, t):
    jg, tg, _, _ = setup
    r = np.random.default_rng(t)
    q = 8
    if seeds:
        src = r.integers(0, jg.n, (q, 3)).astype(np.int32)
        src[1, 1] = src[1, 0]
        w = r.random((q, 3)).astype(np.float32)
        w[2, 2] = 0.0
        w = w / w.sum(axis=1, keepdims=True)
        js, jf = jverd.verd_iterate(jg, jnp.asarray(src), jnp.asarray(w),
                                    t=t, threshold=threshold)
        ts, tf = tverd.verd_iterate(tg, _t(src), _t(w), t=t,
                                    threshold=threshold)
    else:
        src = r.integers(0, jg.n, q).astype(np.int32)
        src[0] = int(np.nonzero(np.asarray(jg.out_deg) == 0)[0][0])
        js, jf = jverd.verd_iterate(jg, jnp.asarray(src), t=t,
                                    threshold=threshold)
        ts, tf = tverd.verd_iterate(tg, _t(src), t=t, threshold=threshold)
    assert _row_l1(ts.numpy(), js) <= TOL
    assert _row_l1(tf.numpy(), jf) <= TOL


@pytest.mark.parametrize("seeds", [False, True])
@pytest.mark.parametrize("with_index", [False, True])
def test_verd_query_matches_reference(setup, seeds, with_index):
    jg, tg, jidx, tidx = setup
    r = np.random.default_rng(9)
    kw = dict(t=2, threshold=1e-4)
    if seeds:
        src = r.integers(0, jg.n, (5, 2)).astype(np.int32)
        w = np.full((5, 2), 0.5, np.float32)
        want = jverd.verd_query(jg, jnp.asarray(src),
                                jidx if with_index else None,
                                seed_weights=jnp.asarray(w), **kw)
        got = tverd.verd_query(tg, _t(src), tidx if with_index else None,
                               seed_weights=_t(w), **kw)
    else:
        src = r.integers(0, jg.n, 5).astype(np.int32)
        want = jverd.verd_query(jg, jnp.asarray(src),
                                jidx if with_index else None, **kw)
        got = tverd.verd_query(tg, _t(src), tidx if with_index else None,
                               **kw)
    assert _row_l1(got.numpy(), want) <= TOL


def test_recursive_decomp_matches_reference_and_verd():
    """Theorem 2.3: t VERD iterations + the index combine equal Algorithm 3
    with the index rows as base vectors."""
    jg, tg = _graphs("er")
    jg, tg = jsyn.erdos_renyi(60, 3.0, seed=8), tsyn.erdos_renyi(
        60, 3.0, seed=8, device="cpu")
    base = np.random.default_rng(0).random((jg.n, jg.n)) / jg.n
    est = base.astype(np.float32)
    jidx = jindex.index_from_dense(jnp.asarray(est), jg.n)
    tidx = tindex.index_from_dense(_t(est), tg.n)
    for u in (0, 7, 31):
        want = jverd.recursive_decomp(jg, u, 2, np.asarray(
            jidx.lookup_dense(jnp.arange(jg.n))))
        got = tverd.recursive_decomp(tg, u, 2, tidx.lookup_dense(
            torch.arange(tg.n)).numpy())
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
        dense = tverd.verd_query(tg, torch.tensor([u]), tidx, t=2)
        assert _row_l1(dense.numpy()[0], got) <= TOL


def test_power_iteration_and_exact_ppr_match_reference():
    jg, tg = _graphs("rmat")
    src = np.random.default_rng(4).integers(0, jg.n, 6).astype(np.int32)
    want = jpi.power_iteration(jg, jnp.asarray(src), n_iter=60)
    got = tpi.power_iteration(tg, _t(src), n_iter=60)
    assert _row_l1(got.numpy(), want) <= TOL
    assert tmetrics.is_stochastic(got).all()
    js, ts = jsyn.erdos_renyi(30, 2.0, seed=1), tsyn.erdos_renyi(
        30, 2.0, seed=1, device="cpu")
    exact = tpi.exact_ppr_dense(ts)
    np.testing.assert_allclose(exact, jpi.exact_ppr_dense(js), rtol=1e-12,
                               atol=1e-15)
    approx = tpi.power_iteration(ts, torch.arange(ts.n), n_iter=100)
    assert _row_l1(approx.numpy(), exact) <= 1e-5


def test_index_lookup_and_truncation_match_reference(setup):
    jg, _, jidx, tidx = setup
    rows = np.array([0, 5, 5, jg.n - 1], np.int32)
    assert np.array_equal(tidx.lookup_dense(_t(rows)).numpy(),
                          np.asarray(jidx.lookup_dense(jnp.asarray(rows))))
    est = (np.random.default_rng(2).integers(0, 4, (7, 90)) / 4.0).astype(
        np.float32)
    est[0] = 0.0
    est[1, 3] = -0.25
    jv, ji = jindex.truncate_topl(jnp.asarray(est), 40)
    tv, ti = tindex.truncate_topl(_t(est), 40)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    t_idx = tindex.index_from_dense(_t(est), 40)
    assert (t_idx.l, t_idx.n) == (40, 90)


def test_fppr_lookup_matches_reference(setup):
    jg, _, jidx, tidx = setup
    r = np.random.default_rng(5)
    src = r.integers(0, jg.n, (4, 3)).astype(np.int32)
    w = r.random((4, 3)).astype(np.float32)
    want = jquery._fppr_lookup(jidx, jnp.asarray(src[:, 0]), None)
    assert np.array_equal(tquery._fppr_lookup(tidx, _t(src[:, 0]), None)
                          .numpy(), np.asarray(want))
    want = jquery._fppr_lookup(jidx, jnp.asarray(src), jnp.asarray(w))
    assert _row_l1(tquery._fppr_lookup(tidx, _t(src), _t(w)).numpy(),
                   want) <= TOL


def test_metrics_match_reference():
    r = np.random.default_rng(7)
    exact = r.random((6, 300)).astype(np.float32)
    approx = exact + r.normal(0, 0.05, exact.shape).astype(np.float32)
    approx[0] = np.round(approx[0], 1)              # ties in the top-k
    je, ja = jnp.asarray(exact), jnp.asarray(approx)
    te, ta = _t(exact), _t(approx)
    for k in (1, 10, 50):
        assert np.allclose(tmetrics.rag_at_k(te, ta, k).numpy(),
                           np.asarray(jmetrics.rag_at_k(je, ja, k)),
                           rtol=1e-6)
        assert np.array_equal(   # the same hit counts
            np.round(tmetrics.precision_at_k(te, ta, k).numpy() * k),
            np.round(np.asarray(jmetrics.precision_at_k(je, ja, k)) * k))
        assert abs(tmetrics.mean_rag(te, ta, k)
                   - jmetrics.mean_rag(je, ja, k)) <= 1e-6
    assert np.allclose(tmetrics.l1_error(te, ta).numpy(),
                       np.asarray(jmetrics.l1_error(je, ja)), rtol=1e-5)
    assert np.array_equal(tmetrics.linf_error(te, ta).numpy(),
                          np.asarray(jmetrics.linf_error(je, ja)))
    p = exact / exact.sum(axis=1, keepdims=True)
    p[1, 0] = -0.5
    assert np.array_equal(tmetrics.is_stochastic(_t(p)),
                          jmetrics.is_stochastic(jnp.asarray(p)))


# -- the engine on the dense route ---------------------------------------------

@pytest.mark.parametrize("mode", ["powerwalk", "verd", "fppr", "pi"])
def test_engine_dense_route_matches_reference(setup, mode):
    jg, tg, jidx, tidx = setup
    kw = dict(mode=mode, t_iterations=2, top_k=20, pi_iterations=40,
              max_batch=4)
    je = jquery.BatchQueryEngine(jg, jidx, jquery.QueryConfig(**kw))
    te = tquery.BatchQueryEngine(tg, tidx, tquery.QueryConfig(**kw),
                                 device="cpu")
    assert not te.uses_sparse_path() and not je.uses_sparse_path()
    src = np.random.default_rng(1).integers(0, jg.n, 6).astype(np.int32)
    dense = lambda v, i: densify_rows(np.asarray(v), np.asarray(i), jg.n)  # noqa: E731
    want = je.query_topk(jnp.asarray(src))
    for got in (te.query_topk(src), te.query_topk_async(_t(src))):
        assert got[1].dtype == torch.int32 and tuple(got[0].shape) == (6, 20)
        assert _row_l1(dense(*got), dense(*want)) <= TOL
    run = te.run(src)
    assert run["values"].shape == (6, 20) and run["mode"] == mode
    assert _row_l1(dense(run["values"], run["indices"]),
                   dense(*want)) <= TOL
    assert _row_l1(te.query_dense(src).numpy(),
                   je.query_dense(jnp.asarray(src))) <= TOL


@pytest.mark.parametrize("mode", ["powerwalk", "verd", "fppr"])
def test_engine_dense_route_seed_sets(setup, mode):
    jg, tg, jidx, tidx = setup
    kw = dict(mode=mode, t_iterations=2, top_k=15, max_seeds=3,
              frontier_path="dense")
    je = jquery.BatchQueryEngine(jg, jidx, jquery.QueryConfig(**kw))
    te = tquery.BatchQueryEngine(tg, tidx, tquery.QueryConfig(**kw),
                                 device="cpu")
    r = np.random.default_rng(2)
    seeds = r.integers(0, jg.n, (5, 3)).astype(np.int32)
    w = r.random((5, 3)).astype(np.float32)
    w[0, 2] = 0.0
    want = je.query_topk_async(jnp.asarray(seeds), weights=jnp.asarray(w))
    got = te.query_topk_async(seeds, weights=w)
    dense = lambda v, i: densify_rows(np.asarray(v), np.asarray(i), jg.n)  # noqa: E731
    assert _row_l1(dense(*got), dense(*want)) <= TOL


def test_dense_top_k_tie_order_matches_lax_top_k(setup):
    """Dangling sources: a row's answer has fewer nonzeros than its width,
    so the tail is all ties at 0, which lax.top_k fills with the lowest
    vertex ids; the port's indices must equal the reference's outright."""
    jg, tg, jidx, tidx = setup
    dangling = np.nonzero(np.asarray(jg.out_deg) == 0)[0][:6].astype(np.int32)
    for mode in ("powerwalk", "verd", "fppr"):
        kw = dict(mode=mode, t_iterations=2, top_k=64)
        je = jquery.BatchQueryEngine(jg, jidx, jquery.QueryConfig(**kw))
        te = tquery.BatchQueryEngine(tg, tidx, tquery.QueryConfig(**kw),
                                     device="cpu")
        jv, ji = je.query_topk(jnp.asarray(dangling))
        tv, ti = te.query_topk(dangling)
        assert (np.asarray(jv) == 0).any()
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-7)
    x = torch.zeros((2, 100))
    x[0, 50] = 1.0
    v, i = topk_dense(x, 10)
    assert i[0].tolist() == [50] + list(range(9))
    assert i[1].tolist() == list(range(10))


def test_mcfp_is_not_ported(setup):
    """The nonlinear modes on the dense route: ``mcfp`` serves with no
    index, bit for bit with the reference at the base key, and both it and
    ``pi`` refuse seed sets; the legacy build runs (its parity is in
    ``tests/test_torch_montecarlo.py``)."""
    jg, tg, _, _ = setup
    cfg = dict(mode="mcfp", top_k=16, r_online=30)
    te = tquery.BatchQueryEngine(tg, None, tquery.QueryConfig(**cfg),
                                 device="cpu")
    je = jquery.BatchQueryEngine(jg, None, jquery.QueryConfig(**cfg))
    src = np.arange(0, 40, 5, dtype=np.int32)
    want = je.query_topk_async(jnp.asarray(src))
    got = te.query_topk_async(src)
    assert np.array_equal(got[0].numpy().view(np.uint32),
                          np.asarray(want[0]).view(np.uint32))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    for mode in ("mcfp", "pi"):
        te = tquery.BatchQueryEngine(tg, None, tquery.QueryConfig(mode=mode),
                                     device="cpu")
        with pytest.raises(ValueError, match="seed-set"):
            te.query_topk(np.zeros((2, 2), np.int32),
                          weights=np.ones((2, 2), np.float32))
    index, stats = tindex.build_index(tg, r=2, l=4, key=rng.prng_key(0),
                                      engine="legacy", sources=src,
                                      source_batch=8, device="cpu")
    assert stats["engine"] == "legacy" and index.values.shape == (tg.n, 4)


# -- the service on the dense route ---------------------------------------------

def _serve(svc, work):
    answers, stats = svc.run_closed_loop(work)
    assert len(answers) == len(work)
    by_id = sorted(answers, key=lambda a: a.request_id)
    return (np.stack([a.top_scores for a in by_id]),
            np.stack([a.top_vertices for a in by_id]), stats)


def test_service_dense_route_is_depth_and_cache_invariant(setup):
    jg, tg, jidx, tidx = setup
    r = np.random.default_rng(0)
    work = [int(v) for v in r.integers(0, jg.n, 20)] + [3, 3]
    q = dict(t_iterations=2, top_k=16)
    runs = []
    for depth, cache in ((1, False), (4, False), (4, True)):
        svc = PPRService(tg, tidx, ServiceConfig(
            query=tquery.QueryConfig(**q),
            batching=BatchingConfig(max_batch=8),
            pipeline=PipelineConfig(depth=depth),
            cache=CacheConfig(capacity=64 if cache else 0)),
            device="cpu")
        assert svc.frontier_path == "dense"
        v, i, stats = _serve(svc, work)
        assert stats["combine_path"] == "dense"
        runs.append((v, i))
    for v, i in runs[1:]:
        assert v.tobytes() == runs[0][0].tobytes()
        assert i.tobytes() == runs[0][1].tobytes()
    jsvc = JService(jg, jidx, JServiceConfig(
        query=jquery.QueryConfig(**q), batching=JBatching(max_batch=8)))
    janswers, _ = jsvc.run_closed_loop(work)
    jv = np.stack([a.top_scores for a in sorted(
        janswers, key=lambda a: a.request_id)])
    ji = np.stack([a.top_vertices for a in sorted(
        janswers, key=lambda a: a.request_id)])
    assert _row_l1(densify_rows(runs[0][0], runs[0][1], jg.n),
                   densify_rows(jv, ji, jg.n)) <= TOL
