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
        "embedding_bag": 0}


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
