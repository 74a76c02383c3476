"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the reference's Pallas kernels (interpret mode) and oracles.

``walk_step`` is held bit for bit; the push and the combine within 1e-5
L1 on densified rows (the reference's own tolerance).  The kernels
themselves are held against these plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import densify_rows
from repro.core import frontier as JF
from repro.core import verd as jverd
from repro.core.graph import Graph as JGraph
from repro.graphs import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import verd as tverd
from repro_torch.graphs import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)


def _port_graph(g):
    return convert.graph_from_arrays(
        g.row_ptr, g.col_idx, g.src, g.out_deg, g.n, g.m, device="cpu")


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def _l1(a_v, a_i, b_v, b_i, n):
    da = densify_rows(np.asarray(a_v), np.asarray(a_i), n)
    db = densify_rows(np.asarray(b_v), np.asarray(b_i), n)
    return float(np.abs(da - db).sum(axis=1).max())


# -- walk_step ---------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 37, 256])
def test_walk_step_matches_reference_bitwise(w):
    r = np.random.default_rng(w)
    g = jsyn.erdos_renyi(200, 3.0, seed=2)       # a few dangling vertices
    cur = r.integers(0, g.n, w).astype(np.int32)
    src = r.integers(0, g.n, w).astype(np.int32)
    u = r.random(w).astype(np.float32)
    u[0] = np.float32(1.0) - np.float32(2.0 ** -24)
    tg = _port_graph(g)
    got = tops.walk_step(_t(cur), _t(src), _t(u), tg.row_ptr, tg.out_deg,
                         tg.col_idx).numpy()
    args = (jnp.asarray(cur), jnp.asarray(src), jnp.asarray(u), g.row_ptr,
            g.out_deg, g.col_idx)
    assert np.array_equal(got, np.asarray(jops.walk_step(*args)))
    assert np.array_equal(got, np.asarray(jref.walk_step_ref(*args)))
    assert np.array_equal(got, tref.walk_step_ref(
        _t(cur), _t(src), _t(u), tg.row_ptr, tg.out_deg, tg.col_idx).numpy())
    assert tops.launch_counts()["walk_step"] == 0   # plain version: no launch


@pytest.mark.parametrize("src_shape", [(2, 1), (2,), (2, 3)])
def test_walk_step_2d_shape_and_dangling_home(src_shape):
    """Sources per row (with or without a trailing 1) or per walk, through
    the wrapper and the plain version alike."""
    g = JGraph.from_edges(np.array([0, 1]), np.array([1, 0]), n=4)
    tg = _port_graph(g)
    cur = _t(np.array([[0, 2, 3], [1, 3, 2]], np.int32))
    src = np.array([[5], [6]], np.int32)
    src = _t(np.broadcast_to(src, (2, 3)).copy() if src_shape == (2, 3)
             else src.reshape(src_shape))
    u = torch.full((2, 3), 0.5)
    args = (cur, src, u, tg.row_ptr, tg.out_deg, tg.col_idx)
    assert tops.walk_step(*args).numpy().tolist() == [[1, 5, 5], [0, 6, 6]]
    assert tref.walk_step_ref(*args).numpy().tolist() == [
        [1, 5, 5], [0, 6, 6]]


def test_walk_step_edgeless_graph_jumps_home():
    tg = convert.graph_from_arrays(np.zeros(4, np.int32), np.zeros(0),
                                   np.zeros(0), np.zeros(3), 3, 0,
                                   device="cpu")
    got = tops.walk_step(_t(np.array([0, 1, 2], np.int32)),
                         _t(np.array([2, 2, 1], np.int32)), torch.rand(3),
                         tg.row_ptr, tg.out_deg, tg.col_idx)
    assert got.numpy().tolist() == [2, 2, 1]


# -- frontier_push -------------------------------------------------------------

def _push_both(g, fv, fi, srcs, *, k_out, threshold=0.0, hub_split_degree=0):
    cap = jverd.resolve_degree_cap(g)
    jf = JF.SparseFrontier(values=jnp.asarray(fv), indices=jnp.asarray(fi),
                           k=fv.shape[1], n=g.n)
    want = jops.frontier_push(
        jf, g, jnp.asarray(srcs), c=0.15, degree_cap=cap, k_out=k_out,
        threshold=threshold, hub_split_degree=hub_split_degree, q_tile=4,
        interpret=True)
    tg = _port_graph(g)
    # the port pushes through sparse_push_compact, which narrows k_out to
    # the candidate width (the reference's core op does the same)
    got = tverd.sparse_push_compact(
        tg, _t(fv), _t(fi), _t(srcs), c=0.15, degree_cap=cap, k_out=k_out,
        threshold=threshold, hub_split_degree=hub_split_degree)
    h, s = tverd.resolve_hub_splits(cap, hub_split_degree)
    assert got.k == min(k_out, fv.shape[1] * s * h + 1)
    assert _l1(got.values, got.indices, want.values, want.indices, g.n) \
        <= 1e-5
    # the port's dense oracle agrees with the reference's
    ov, oi = tref.frontier_push_ref(
        _t(fv), _t(fi), _t(srcs), tg.row_ptr, tg.out_deg, tg.col_idx,
        c=0.15, k_out=k_out, threshold=threshold)
    rv, ri = jref.frontier_push_ref(
        jnp.asarray(fv), jnp.asarray(fi), jnp.asarray(srcs), g.row_ptr,
        g.out_deg, g.col_idx, c=0.15, degree_cap=cap, k_out=k_out,
        threshold=threshold)
    assert _l1(ov, oi, rv, ri, g.n) <= 1e-5
    assert _l1(got.values, got.indices, ov, oi, g.n) <= 1e-5
    return got


@pytest.mark.parametrize("hub_split_degree", [0, 3])
@pytest.mark.parametrize("threshold", [0.0, 0.02])
def test_frontier_push_matches_reference(hub_split_degree, threshold):
    r = np.random.default_rng(1)
    g = jsyn.erdos_renyi(60, 4.0, seed=11)
    fv = r.random((5, 6)).astype(np.float32)
    fi = r.integers(0, g.n, (5, 6)).astype(np.int32)
    srcs = r.integers(0, g.n, 5).astype(np.int32)
    _push_both(g, fv, fi, srcs, k_out=12, threshold=threshold,
               hub_split_degree=hub_split_degree)


def test_frontier_push_k_out_wider_than_candidates():
    r = np.random.default_rng(2)
    g = jsyn.erdos_renyi(30, 3.0, seed=2)
    srcs = r.integers(0, g.n, 4).astype(np.int32)
    got = _push_both(g, np.ones((4, 1), np.float32), srcs[:, None], srcs,
                     k_out=g.n)
    tail = got.values.numpy() == 0
    assert (got.indices.numpy()[tail] == 0).all()


def test_frontier_push_empty_frontier():
    g = jsyn.erdos_renyi(40, 4.0, seed=3)
    srcs = np.arange(5, dtype=np.int32)
    got = _push_both(g, np.zeros((5, 6), np.float32),
                     np.zeros((5, 6), np.int32), srcs, k_out=8)
    assert float(got.values.abs().max()) == 0.0
    assert int(got.indices.abs().max()) == 0


def test_frontier_push_all_dangling_rows():
    r = np.random.default_rng(4)
    g = JGraph.from_edges(np.array([0, 0, 1, 2, 3]), np.array([1, 2, 3, 0, 1]),
                          n=10)
    srcs = np.array([4, 5, 6], np.int32)
    fv = r.random((3, 4)).astype(np.float32)
    fi = r.integers(4, 10, (3, 4)).astype(np.int32)
    got = _push_both(g, fv, fi, srcs, k_out=6)
    dense = densify_rows(got.values.numpy(), got.indices.numpy(), g.n)
    want = np.zeros_like(dense)
    want[np.arange(3), srcs] = 0.85 * fv.sum(axis=1)
    np.testing.assert_allclose(dense, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hub_split_degree", [0, 3])
def test_frontier_push_window_clip_at_csr_end(hub_split_degree):
    """A hub row closing col_idx shifts the last gather window down."""
    r = np.random.default_rng(5)
    n, hub_deg = 12, 7
    g = JGraph.from_edges(
        np.concatenate([[0, 1, 2, 3], np.full(hub_deg, n - 1)]),
        np.concatenate([[1, 2, 3, 0], np.arange(hub_deg)]), n=n)
    fv = r.random((3, 2)).astype(np.float32)
    fi = np.array([[n - 1, 0], [1, n - 1], [n - 1, n - 1]], np.int32)
    _push_both(g, fv, fi, r.integers(0, n, 3).astype(np.int32), k_out=n,
               hub_split_degree=hub_split_degree)


def test_frontier_push_plain_streamed_folds_match_core():
    """The wrapper's chunked fold (running state first) is the reference's
    streamed ``sparse_push_compact`` loop, fold for fold."""
    r = np.random.default_rng(6)
    g = jsyn.rmat(8, avg_deg=6.0, seed=1)
    cap = jverd.resolve_degree_cap(g)
    q, k, k_out = 4, 12, 10
    fv = r.random((q, k)).astype(np.float32)
    fi = r.integers(0, g.n, (q, k)).astype(np.int32)
    srcs = r.integers(0, g.n, q).astype(np.int32)
    want = jverd.sparse_push_compact(
        g, jnp.asarray(fv), jnp.asarray(fi), jnp.asarray(srcs), c=0.15,
        degree_cap=cap, k_out=k_out, stream_width=3 * cap)
    tg = _port_graph(g)
    got = tverd.sparse_push_compact(
        tg, _t(fv), _t(fi), _t(srcs), c=0.15, degree_cap=cap, k_out=k_out,
        stream_width=3 * cap)
    assert _l1(got.values, got.indices, want.values, want.indices, g.n) \
        <= 1e-5


def test_column_sorted_view_matches_lexsort():
    """``Graph.col_sorted``: each CSR row in (column, offset) order, as
    numpy's lexsort of (row, column, offset) gives it, on rows stored out
    of column order; the repeat flag set exactly on rows that hold a
    column twice."""
    from repro_torch.core.graph import Graph

    r = np.random.default_rng(21)
    n = 300
    degs = r.integers(0, 30, n)
    degs[:3] = [0, 200, 1]
    src = np.repeat(np.arange(n), degs)
    dst = np.concatenate([r.integers(0, n, d) if v % 3 else
                          r.permutation(n)[:d] for v, d in enumerate(degs)])
    perm = r.permutation(src.shape[0])             # edges in any order
    g = Graph.from_edges(src[perm], dst[perm], n=n, device="cpu")
    view = g.col_sorted()
    assert view is g.col_sorted()                   # cached on the graph
    row = g.src.numpy()
    col = g.col_idx.numpy()
    order = np.lexsort((np.arange(col.shape[0]), col, row))
    np.testing.assert_array_equal(view.col_idx.numpy(), col[order])
    dup = np.zeros(n, bool)
    same = (row[order][1:] == row[order][:-1]) & (col[order][1:]
                                                  == col[order][:-1])
    dup[row[order][1:][same]] = True
    np.testing.assert_array_equal(view.repeats.numpy(), dup)
    assert dup.any() and not dup.all()


def _columns_oracle(vals, idx, n, seg):
    """The transposed view in numpy: per column, (v, vals[v, j]) of the
    kept entries in ascending (v, j); the runs of seg entries after a
    column's first as tasks."""
    nv, l = vals.shape
    per_col = [[] for _ in range(n)]
    for v in range(nv):
        for j in range(l):
            c = int(idx[v, j])
            if vals[v, j] != 0 and 0 <= c < n:
                per_col[c].append((v, vals[v, j]))
    col_ptr = np.cumsum([0] + [len(e) for e in per_col])
    tasks, heavy = [], []
    for c, ents in enumerate(per_col):
        runs = [(col_ptr[c] + a, col_ptr[c] + min(a + seg, len(ents)))
                for a in range(seg, len(ents), seg)]
        if runs:
            heavy.append((c, len(tasks), len(runs)))
            tasks += [(c, a, b) for a, b in runs]
    flat = [e for ents in per_col for e in ents]
    return (col_ptr, np.array([v for v, _ in flat], np.int32),
            np.array([w for _, w in flat], np.float32),
            np.array(tasks, np.int64).reshape(-1, 3),
            np.array(heavy, np.int64).reshape(-1, 3))


def test_index_columns_match_numpy():
    """The dense combine's transposed index view against a numpy oracle,
    on an index with zero entries, zero-padded rows and columns outside
    ``[0, n)``; ``PPRIndex.columns`` caches it per ``(nv, n)``."""
    from repro_torch.core.index import PPRIndex
    from repro_torch.kernels import index_combine as comb_k

    r = np.random.default_rng(22)
    nv, l, n = 90, 7, 80
    vals = r.random((nv, l)).astype(np.float32)
    vals[r.random((nv, l)) < 0.25] = 0.0
    vals[5:9, 3:] = 0.0
    idx = r.integers(-4, n + 4, (nv, l)).astype(np.int32)
    idx[20:70, 1] = 3                                 # a column of 50+
    got = comb_k.index_columns(_t(vals), _t(idx), n, seg=16)
    want = _columns_oracle(vals, idx, n, 16)
    np.testing.assert_array_equal(got.col_ptr.numpy(), want[0])
    np.testing.assert_array_equal(got.ent_v.numpy(), want[1])
    np.testing.assert_array_equal(got.ent_w.numpy(), want[2])
    np.testing.assert_array_equal(got.tasks.numpy(), want[3])
    np.testing.assert_array_equal(got.heavy.numpy(), want[4])
    assert (got.nv, got.n, got.seg) == (nv, n, 16) and len(want[4]) >= 1
    index = PPRIndex(values=_t(vals), indices=_t(idx), l=l, n=n)
    view = index.columns(60, n)
    assert view is index.columns(60, n) and view.nv == 60
    np.testing.assert_array_equal(
        view.ent_v.numpy(), comb_k.index_columns(
            _t(vals[:60]), _t(idx[:60]), n).ent_v.numpy())


def test_index_columns_order_is_the_plain_scatter_order():
    """Summing each output entry as the dense kernel does -- ``s`` first,
    then each column's entries in the view's order, rounded products of
    the nonzero ``f`` added one by one, a split column's task partials
    added after its first run -- gives the plain version's CPU bits on
    every column of at most ``seg`` entries, and agrees within f32
    rounding on the split ones."""
    from repro_torch.kernels import index_combine as comb_k

    r = np.random.default_rng(23)
    q, nv, n, l, seg = 5, 120, 100, 9, 32
    vals = r.random((nv, l)).astype(np.float32)
    vals[r.random((nv, l)) < 0.2] = 0.0
    idx = r.integers(-2, n + 2, (nv, l)).astype(np.int32)
    idx[:80, :2] = 4                                  # 160 entries: split
    s = r.random((q, n)).astype(np.float32)
    f = r.random((q, nv)).astype(np.float32)
    f[r.random((q, nv)) < 0.5] = 0.0
    view = comb_k.index_columns(_t(vals), _t(idx), n, seg=seg)
    cp, ev, ew = (x.numpy() for x in (view.col_ptr, view.ent_v, view.ent_w))
    got = s.copy()
    for c in range(n):
        runs = [(a, min(a + seg, cp[c + 1])) for a in range(cp[c], cp[c + 1],
                                                             seg)] or [(0, 0)]
        for qi in range(q):
            parts = []
            for k, (a, b) in enumerate(runs):
                acc = got[qi, c] if k == 0 else np.float32(0.0)
                for e in range(a, b):
                    if f[qi, ev[e]] != 0:
                        acc = np.float32(acc + np.float32(f[qi, ev[e]] * ew[e]))
                parts.append(acc)
            total = parts[0]
            for p in parts[1:]:
                total = np.float32(total + p)
            got[qi, c] = total
    want = comb_k.index_combine_plain(_t(s), _t(f), _t(vals), _t(idx),
                                      columns=view).numpy()
    one_run = np.diff(cp) <= seg
    assert not one_run.all()
    np.testing.assert_array_equal(got[:, one_run].view(np.int32),
                                  want[:, one_run].view(np.int32))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- index_combine_sparse ------------------------------------------------------

@pytest.mark.parametrize("q,k_out", [(3, 40), (1, 5), (6, 7)])
def test_index_combine_sparse_matches_reference(q, k_out):
    r = np.random.default_rng(q)
    n, l, k, s_w = 30, 6, 4, 5
    vals = r.random((n, l)).astype(np.float32)
    idx = r.integers(0, n, (n, l)).astype(np.int32)
    sv = r.random((q, s_w)).astype(np.float32)
    si = r.integers(0, n, (q, s_w)).astype(np.int32)
    fv = r.random((q, k)).astype(np.float32)
    fv[0, 1] = 0.0
    fi = r.integers(0, n, (q, k)).astype(np.int32)
    got = tops.index_combine_sparse(*(_t(x) for x in (sv, si, fv, fi, vals,
                                                      idx)), k_out=k_out)
    s = JF.SparseFrontier(values=jnp.asarray(sv), indices=jnp.asarray(si),
                          k=s_w, n=n)
    f = JF.SparseFrontier(values=jnp.asarray(fv), indices=jnp.asarray(fi),
                          k=k, n=n)
    want = jops.index_combine_sparse(s, f, jnp.asarray(vals),
                                     jnp.asarray(idx), k_out=k_out,
                                     q_tile=4, interpret=True)
    assert tuple(got[0].shape) == (q, k_out)
    assert _l1(*got, want.values, want.indices, n) <= 1e-5
    rv, ri = jref.index_combine_sparse_ref(
        *(jnp.asarray(x) for x in (sv, si, fv, fi, vals, idx)), k_out=k_out)
    ov, oi = tref.index_combine_sparse_ref(
        *(_t(x) for x in (sv, si, fv, fi, vals, idx)), k_out=k_out)
    assert _l1(ov, oi, rv, ri, n) <= 1e-5
    assert _l1(*got, ov, oi, n) <= 1e-5


def _dyadic(r, shape, top=256):
    return r.integers(1, top, shape).astype(np.float32) / 1024.0


def _combine_case(case):
    """Dyadic inputs (every f32 sum exact) for the sparse combine's edge
    cases: a column in every live slot, ties at the ``k_out`` edge, and
    ``k_out`` above the distinct columns."""
    r = np.random.default_rng(17)
    n, l, q, k, s_w = 64, 8, 5, 6, 4
    vals = _dyadic(r, (n, l))
    vals[:, l - 2:] = 0.0                          # zero-padded rows
    idx = r.integers(0, n, (n, l)).astype(np.int32)
    idx[vals == 0] = 0
    sv, si = _dyadic(r, (q, s_w)), r.integers(0, n, (q, s_w)).astype(np.int32)
    fv = _dyadic(r, (q, k))
    fv[1, 2] = 0.0                                 # a zero-mass slot
    fi = r.integers(0, n, (q, k)).astype(np.int32)
    k_out = 12
    if case == "column in every slot":
        idx[:, 0], vals[:, 0] = 5, 1.0 / 64.0
    elif case == "ties at the edge":
        vals[vals > 0] = 1.0 / 64.0
        fv[:], sv[:] = 1.0 / 8.0, 1.0 / 512.0
        k_out = 7
    else:                                          # k_out above d
        fv[:, 1:] = 0.0
        k_out = 40
    return (sv, si, fv, fi, vals, idx), n, k_out


@pytest.mark.parametrize("case", ["column in every slot", "ties at the edge",
                                  "k_out above d"])
def test_index_combine_sparse_edge_cases_match_reference(case):
    """Bit for bit against the reference's kernel (interpret mode), ties
    broken by column ascending as ``lax.top_k`` does."""
    arrays, n, k_out = _combine_case(case)
    sv, si, fv, fi, vals, idx = arrays
    got = tops.index_combine_sparse(*(_t(x) for x in arrays), k_out=k_out)
    s = JF.SparseFrontier(values=jnp.asarray(sv), indices=jnp.asarray(si),
                          k=sv.shape[1], n=n)
    f = JF.SparseFrontier(values=jnp.asarray(fv), indices=jnp.asarray(fi),
                          k=fv.shape[1], n=n)
    want = jops.index_combine_sparse(s, f, jnp.asarray(vals),
                                     jnp.asarray(idx), k_out=k_out,
                                     q_tile=4, interpret=True)
    wv, wi = np.asarray(want.values), np.asarray(want.indices)
    if case == "ties at the edge":
        assert (wv[:, k_out - 1] == np.sort(wv, axis=1)[:, 0]).any()
    if case == "k_out above d":
        assert (wv == 0).any(axis=1).all()
    np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                  wv.view(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), wi)


def test_combine_plan_spreads_the_main_path_over_parts():
    """At the main path's shape (S = 257, K = L = 256, k_out = 50) the hash
    path spreads a row over 12 blocks of 8,192-slot tables; a row of few
    live slots takes fewer; a k_out the hash path does not take (the
    kernel's shared-memory size -1) or a block too large for the card goes
    the sort path, and forced paths.  The kernel's size is stood in for."""
    from repro_torch.kernels import index_combine as comb_k

    def smem(t_log2, k, k_out):
        return -1 if k_out > 1024 else 8 * (1 << t_log2) + 8 * k

    plan = comb_k.combine_plan(257, 256, 256, 50, smem)
    assert (plan.path, plan.parts, 1 << plan.t_log2) == ("hash", 12, 8192)
    assert plan.d_max == 3 * 8192 // 4 - comb_k.HASH_THREADS
    assert plan.parts * plan.d_max >= 257 + 256 * 256
    assert plan.smem == smem(13, 256, 50)
    live = torch.tensor([0, 1, 104, 256])
    parts = comb_k.row_parts(plan, 257, live, 256).tolist()
    assert parts == [1, 1, 5, 12]
    assert comb_k.combine_plan(257, 256, 256, 2048, smem).path == "sort"
    assert comb_k.combine_plan(257, 1 << 15, 256, 50, smem).path == "sort"
    assert comb_k.combine_plan(257, 256, 256, 50, smem,
                               "sort").path == "sort"
    small = comb_k.combine_plan(5, 4, 6, 40, smem)
    assert (small.parts, 1 << small.t_log2) == (1, comb_k.HASH_MIN_SLOTS)
    with pytest.raises(ValueError):
        comb_k.combine_plan(257, 256, 256, 2048, smem, "hash")
    with pytest.raises(ValueError):
        comb_k.combine_plan(257, 256, 256, 50, smem, "bitonic")


def test_hash_part_spreads_low_columns():
    """The partition hash of the kernel, against a numpy reference; R-MAT
    hubs crowd the low ids, and the multiplicative hash spreads them."""
    from repro_torch.kernels import index_combine as comb_k

    cols = np.arange(4096, dtype=np.int64)
    want = ((cols * comb_k.PART_MUL) % 2 ** 32 * 12) >> 32
    got = comb_k.hash_part(torch.from_numpy(cols), 12).numpy()
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got[:256], minlength=12)
    assert counts.min() >= 256 // 12 - 4 and counts.max() <= 256 // 12 + 4


def test_index_combine_sparse_empty_frontier():
    r = np.random.default_rng(9)
    n, l, q, k = 20, 4, 4, 3
    sv = r.random((q, 5)).astype(np.float32)
    si = r.integers(0, n, (q, 5)).astype(np.int32)
    got = tops.index_combine_sparse(
        _t(sv), _t(si), torch.zeros((q, k)), torch.zeros((q, k), dtype=torch.int32),
        _t(r.random((n, l)).astype(np.float32)),
        _t(r.integers(0, n, (n, l)).astype(np.int32)), k_out=8)
    want = JF.compact(jnp.asarray(sv), jnp.asarray(si), 8, n)
    assert np.array_equal(got[0].numpy(), np.asarray(want.values))
    assert np.array_equal(got[1].numpy(), np.asarray(want.indices))


# -- launch counters and routing ----------------------------------------------

def test_launch_counters_start_at_zero_and_reset():
    tops.reset_launch_counts()
    assert tops.launch_counts() == {
        "walk_step": 0, "frontier_push": 0, "index_combine_sparse": 0,
        "ell_spmm": 0, "index_combine": 0, "sharded_frontier_push": 0,
        "embedding_bag": 0, "embedding_bag_backward": 0}


def test_wrappers_refuse_unsupported_devices():
    t = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):
        tops.walk_step(t.int(), t.int(), t, t.int(), t.int(), t.int())
    with pytest.raises(ValueError):
        tops.index_combine(t[None], t[None], t[:, None], t[:, None].int())
    ell = tsyn.cycle(3, device="cpu").ell()
    with pytest.raises(ValueError):
        tops.ell_push(torch.zeros((1, 3), device="meta"), ell)
    with pytest.raises(ValueError):
        tops.sharded_frontier_push(
            t[None], t[None].int(), t.int(), t.int(), c=0.15, degree_cap=1,
            ep=1, n_shard=1, wire_k=1)
    with pytest.raises(ValueError):
        tops.embedding_bag(t[:, None].int(), t[:, None], t[:, None])
    with pytest.raises(ValueError):
        tops.embedding_bag_backward(t[:, None].int(), None, t[:, None], 2)


# -- the kernel build ---------------------------------------------------------

def test_library_name_changes_with_any_header(tmp_path, monkeypatch):
    """A library is named by a hash of its source, every ``csrc/*.cuh`` and
    the flags: an edit to any header, used by the kernel or not, names a
    new library, so no stale build is loaded."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    extra = csrc / "extra.cuh"
    extra.write_text("// a header no kernel includes yet\n")
    after_new = {name: build.library_path(name) for name in build.SOURCES}
    assert all(after_new[k] != before[k] for k in build.SOURCES)
    extra.write_text("// the same header, edited\n")
    after_edit = {name: build.library_path(name) for name in build.SOURCES}
    assert all(after_edit[k] != after_new[k] for k in build.SOURCES)
    extra.unlink()
    assert {name: build.library_path(name)
            for name in build.SOURCES} == before


def test_capture_last_keeps_each_variants_last_launch():
    """``capture_first_launches(last=True)`` keeps each variant's last
    launch (how the smoke run takes a late power iteration's push); the
    default keeps the first."""
    try:
        for last, want in ((False, 1), (True, 3)):
            tops.reset_launch_counts()
            tops.capture_first_launches(True, last=last)
            for i in (1, 2, 3):
                tops._launched("ell_spmm", (i,), {}, "later")
            assert tops.captured_launches()["ell_spmm/later"] == ((want,), {})
            assert tops.launch_counts()["ell_spmm"] == 3
    finally:
        tops.capture_first_launches(False)
        tops.reset_launch_counts()


def test_redesigned_wrappers_refuse_what_their_kernels_cannot_index():
    """The sharded push keys a candidate by a 32-bit position in its row,
    so a row of ``K * degree_cap >= 2**31`` candidates is refused; an ELL
    view of width 0 with rows in use is refused; both before any launch."""
    from repro_torch.kernels import ell_spmm as ell_k
    from repro_torch.kernels import frontier_push as push_k

    k = 2 ** 20                                 # k * 2048 = 2**31
    fv = torch.ones((1, k))
    fi = torch.zeros((1, k), dtype=torch.int32)
    row_ptr = torch.tensor([0, 2048, 2048], dtype=torch.int32)
    col_idx = torch.zeros(2048, dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        push_k.sharded_frontier_push_cuda(
            fv, fi, row_ptr, col_idx, c=0.15, degree_cap=2048, ep=1,
            n_shard=2, wire_k=4)
    nbr = torch.zeros((4, 0), dtype=torch.int32)
    r2v = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="k >= 1"):
        ell_k.ell_spmm_cuda(torch.ones((1, 4)), nbr, nbr.float(), r2v,
                            torch.arange(5, dtype=torch.int32), rows_used=4)
