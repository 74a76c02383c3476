"""Sparse VERD and the query engine against the reference.

One reference-built index (converted through numpy) serves both packages;
answers must agree within 1e-5 L1 on densified rows.  rmat(12) at average
degree 10 has a 708-edge hub, so a 64-slot frontier streams its push in
chunks on its own while a width-1 frontier pushes one-shot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import densify_rows
from repro.core import index as jindex
from repro.core import query as jquery
from repro.core import verd as jverd
from repro.graphs import synthetic as jsyn
from repro_torch import convert
from repro_torch.core import frontier as TF
from repro_torch.core import query as tquery
from repro_torch.core import verd as tverd
from repro_torch.graphs import synthetic as tsyn

torch.set_num_threads(1)
TOL = 1e-5


def _l1(a, b, n):
    da = densify_rows(np.asarray(a[0]), np.asarray(a[1]), n)
    db = densify_rows(np.asarray(b[0]), np.asarray(b[1]), n)
    return float(np.abs(da - db).sum(axis=1).max())


@pytest.fixture(scope="module")
def setup():
    jg = jsyn.rmat(12, avg_deg=10.0, seed=5)
    tg = tsyn.rmat(12, avg_deg=10.0, seed=5, device="cpu")
    jidx, _ = jindex.build_index(jg, r=16, l=32, key=jax.random.PRNGKey(1),
                                 source_batch=1024)
    tidx = convert.index_from_arrays(jidx.values, jidx.indices, device="cpu")
    return jg, tg, jidx, tidx


def test_degree_cap_and_hub_splits(setup):
    jg, tg, _, _ = setup
    cap = tverd.resolve_degree_cap(tg)
    assert cap == jverd.resolve_degree_cap(jg)
    # a 64-slot frontier is wider than twice the stream target: it streams
    assert 64 * cap + 1 > 2 * max(4 * 64, cap, 4096)
    for hsd in (0, 32, 691, 1000):
        assert tverd.resolve_hub_splits(cap, hsd) == \
            jverd.resolve_hub_splits(cap, hsd)


@pytest.mark.parametrize("hsd", [0, 32])
@pytest.mark.parametrize("k,k_out,threshold", [(1, 64, 0.0), (64, 64, 0.0),
                                               (64, 16, 0.0), (64, 64, 1e-3)])
def test_sparse_push_compact(setup, hsd, k, k_out, threshold):
    jg, tg, _, _ = setup
    r = np.random.default_rng(k + k_out)
    q = 8
    fv = r.random((q, k)).astype(np.float32)
    fi = r.integers(0, jg.n, (q, k)).astype(np.int32)
    fi[0, 0] = int(np.argmax(np.asarray(jg.out_deg)))          # the hub
    src = r.integers(0, jg.n, q).astype(np.int32)
    cap = jverd.resolve_degree_cap(jg)
    want = jverd.sparse_push_compact(
        jg, jnp.asarray(fv), jnp.asarray(fi), jnp.asarray(src),
        degree_cap=cap, k_out=k_out, hub_split_degree=hsd,
        threshold=threshold)
    got = tverd.sparse_push_compact(
        tg, torch.from_numpy(fv), torch.from_numpy(fi), torch.from_numpy(src),
        degree_cap=cap, k_out=k_out, hub_split_degree=hsd,
        threshold=threshold)
    assert got.k == want.k
    assert _l1((got.values, got.indices), (want.values, want.indices),
               jg.n) <= TOL


@pytest.mark.parametrize("hsd", [0, 32])
def test_sparse_push_compact_one_slot_chunks(setup, hsd, monkeypatch):
    """A stream target of one slot width streams one frontier vertex per
    chunk (``slots = 1``, the chunk plan of a hub-heavy graph at full
    size, whose folds the kernel runs over the column-sorted view): the
    plain folds match the reference's streamed ``sparse_push_compact`` at
    the same ``stream_width``."""
    jg, tg, _, _ = setup
    r = np.random.default_rng(31 + hsd)
    q, k, k_out = 16, 24, 48
    cap = jverd.resolve_degree_cap(jg)
    h, s_ = tverd.resolve_hub_splits(cap, hsd)
    width = h * s_
    plans = []
    push = tverd.kernel_ops.frontier_push

    def spy(*args, **kwargs):
        plans.append((kwargs["slots"], kwargs["run_first"]))
        return push(*args, **kwargs)

    monkeypatch.setattr(tverd.kernel_ops, "frontier_push", spy)
    fv = r.random((q, k)).astype(np.float32)
    fv[r.random((q, k)) < 0.2] = 0.0
    fi = r.integers(0, jg.n, (q, k)).astype(np.int32)
    fi[:, :3] = np.argsort(np.asarray(jg.out_deg))[-3:]        # the hubs
    src = r.integers(0, jg.n, q).astype(np.int32)
    want = jverd.sparse_push_compact(
        jg, jnp.asarray(fv), jnp.asarray(fi), jnp.asarray(src),
        degree_cap=cap, k_out=k_out, hub_split_degree=hsd,
        stream_width=width)
    got = tverd.sparse_push_compact(
        tg, torch.from_numpy(fv), torch.from_numpy(fi), torch.from_numpy(src),
        degree_cap=cap, k_out=k_out, hub_split_degree=hsd,
        stream_width=width)
    assert plans == [(1, True)]
    assert got.k == want.k
    assert _l1((got.values, got.indices), (want.values, want.indices),
               jg.n) <= TOL


def test_sparse_push_compact_seed_sets(setup):
    jg, tg, _, _ = setup
    r = np.random.default_rng(3)
    q, k, s = 6, 64, 3
    fv = r.random((q, k)).astype(np.float32)
    fi = r.integers(0, jg.n, (q, k)).astype(np.int32)
    fi[:, :4] = np.nonzero(np.asarray(jg.out_deg) == 0)[0][:4]  # dangling
    seeds = r.integers(0, jg.n, (q, s)).astype(np.int32)
    w = r.random((q, s)).astype(np.float32)
    w[0, 2] = 0.0
    cap = jverd.resolve_degree_cap(jg)
    want = jverd.sparse_push_compact(
        jg, jnp.asarray(fv), jnp.asarray(fi), jnp.asarray(seeds),
        degree_cap=cap, k_out=48, seed_weights=jnp.asarray(w))
    got = tverd.sparse_push_compact(
        tg, torch.from_numpy(fv), torch.from_numpy(fi),
        torch.from_numpy(seeds), degree_cap=cap, k_out=48,
        seed_weights=torch.from_numpy(w))
    assert _l1((got.values, got.indices), (want.values, want.indices),
               jg.n) <= TOL


def _iterate_both(setup, hsd, q=6):
    jg, tg, _, _ = setup
    src = np.random.default_rng(hsd).integers(0, jg.n, q).astype(np.int32)
    js, jf = jverd.verd_iterate_sparse(jg, jnp.asarray(src), t=2, k=128,
                                       hub_split_degree=hsd)
    ts, tf = tverd.verd_iterate_sparse(tg, torch.from_numpy(src), t=2, k=128,
                                       hub_split_degree=hsd)
    return (js, jf), (ts, tf)


@pytest.mark.parametrize("hsd", [0, 32])
def test_combine_sparse_and_scatter(setup, hsd):
    jg, _, jidx, tidx = setup
    (js, jf), (ts, tf) = _iterate_both(setup, hsd)
    assert _l1((ts.values, ts.indices), (js.values, js.indices), jg.n) <= TOL
    assert _l1((tf.values, tf.indices), (jf.values, jf.indices), jg.n) <= TOL
    for out_k in (20, None):
        want = jverd.combine_with_index_sparse(js, jf, jidx, out_k=out_k)
        got = tverd.combine_with_index_sparse(ts, tf, tidx, out_k=out_k)
        assert got.k == want.k
        assert _l1((got.values, got.indices), (want.values, want.indices),
                   jg.n) <= TOL
    want = jverd.combine_with_index_scatter(js, jf, jidx, out_k=20)
    got = tverd.combine_with_index_scatter(ts, tf, tidx, out_k=20)
    assert _l1(got, want, jg.n) <= TOL
    # the scatter combine keeps lax.top_k's order: values descending, ties
    # by column ascending, so its indices match the reference outright
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_verd_query_sparse_without_index(setup):
    jg, tg, _, _ = setup
    src = np.arange(5, dtype=np.int32)
    want = jverd.verd_query_sparse(jg, jnp.asarray(src), None, t=2, k=64,
                                   out_k=30)
    got = tverd.verd_query_sparse(tg, torch.from_numpy(src), None, t=2,
                                  k=64, out_k=30)
    assert _l1((got.values, got.indices), (want.values, want.indices),
               jg.n) <= TOL


@pytest.mark.parametrize("hsd", [0, 32])
def test_engine_query_topk(setup, hsd):
    jg, tg, jidx, tidx = setup
    kw = dict(t_iterations=2, top_k=20, hub_split_degree=hsd, max_seeds=3,
              frontier_path="sparse")
    je = jquery.BatchQueryEngine(jg, jidx, jquery.QueryConfig(**kw))
    te = tquery.BatchQueryEngine(tg, tidx, tquery.QueryConfig(**kw),
                                 device="cpu")
    assert te.frontier_k == je.frontier_k
    assert te.uses_sparse_path() and je.uses_sparse_path()
    assert te.uses_scatter_combine(6) == je.uses_scatter_combine(6)
    r = np.random.default_rng(2)
    seeds = r.integers(0, jg.n, (6, 3)).astype(np.int32)
    w = r.random((6, 3)).astype(np.float32)
    w[0, 2] = 0.0
    cases = [
        (je.query_topk(jnp.asarray(seeds[:, 0])), te.query_topk(seeds[:, 0])),
        (je.query_topk(jnp.asarray(seeds), weights=jnp.asarray(w)),
         te.query_topk(seeds, weights=w)),
        (je.query_topk_async(jnp.asarray(seeds[:, 0])),
         te.query_topk_async(seeds[:, 0])),
        (je.query_topk_async(jnp.asarray(seeds), weights=jnp.asarray(w)),
         te.query_topk_async(torch.from_numpy(seeds),
                             weights=torch.from_numpy(w))),
    ]
    for want, got in cases:
        assert tuple(got[0].shape) == (6, 20)
        assert _l1(got, want, jg.n) <= TOL
    run = te.run(seeds[:, 0])
    assert run["queries"] == 6 and run["values"].shape == (6, 20)
    assert _l1((run["values"], run["indices"]), cases[0][0], jg.n) <= TOL


def test_engine_routing_constants_match():
    assert tquery.AUTO_SPARSE_MIN_N == jquery.AUTO_SPARSE_MIN_N
    assert tquery.SCATTER_COMBINE_BUDGET_BYTES == \
        jquery.SCATTER_COMBINE_BUDGET_BYTES
    for top_k in (1, 50, 64, 200):
        assert tquery.auto_frontier_floor(top_k) == \
            jquery.auto_frontier_floor(top_k)
    w = np.array([[1.0, 3.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    assert np.array_equal(
        tquery.normalize_seed_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jquery.normalize_seed_weights(jnp.asarray(w))))


@pytest.mark.parametrize("n_log2,kw", [
    (14, dict(top_k=50)), (14, dict(top_k=50, hub_split_degree=64)),
    (15, dict(top_k=200, t_iterations=3)), (14, dict(frontier_k=4096)),
    (14, dict(max_seeds=4, top_k=10)),
])
def test_engine_route_and_widths_match(n_log2, kw):
    """Auto-routing resolves the same route and widths in both packages
    (index-free: routing reads only the graph and the config)."""
    jg = jsyn.rmat(n_log2, avg_deg=4.0, seed=0)
    tg = convert.graph_from_arrays(jg.row_ptr, jg.col_idx, jg.src,
                                   jg.out_deg, jg.n, jg.m, device="cpu")
    je = jquery.BatchQueryEngine(jg, None, jquery.QueryConfig(mode="verd",
                                                              **kw))
    te = tquery.BatchQueryEngine(tg, None, tquery.QueryConfig(mode="verd",
                                                              **kw),
                                 device="cpu")
    assert te.frontier_k == je.frontier_k
    assert te.uses_sparse_path() == je.uses_sparse_path()
    assert te.effective_top_k == je.effective_top_k


def test_sparse_frontier_helpers(setup):
    _, tg, _, _ = setup
    f = TF.from_sources(torch.tensor([1, 2]), tg.n)
    assert f.nbytes == 2 * 1 * 8 and f.densify().shape == (2, tg.n)
