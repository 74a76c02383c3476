"""The port's offline build against the reference, bit for bit.

Same graph (the same numpy generator), same PRNG key, same chunking: the
walk sketches, the ledgers and the built ``PPRIndex`` must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core import walks as jwalks
from repro.core.graph import graph_fingerprint as j_fingerprint
from repro.graphs import synthetic as jsyn
from repro_torch import convert, rng
from repro_torch.core import index as tindex
from repro_torch.core import walks as twalks
from repro_torch.core.graph import graph_fingerprint as t_fingerprint
from repro_torch.graphs import synthetic as tsyn

torch.set_num_threads(1)


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _equal(got, want):
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.fixture(scope="module")
def graphs():
    return (jsyn.rmat(10, avg_deg=6.0, seed=3),
            tsyn.rmat(10, avg_deg=6.0, seed=3, device="cpu"))


@pytest.mark.parametrize("make", [
    lambda m, d: m.rmat(9, avg_deg=5.0, seed=1, **d),
    lambda m, d: m.erdos_renyi(300, 3.0, seed=2, **d),
    lambda m, d: m.star(17, **d),
    lambda m, d: m.cycle(9, **d),
])
def test_synthetic_graphs_identical(make):
    jg = make(jsyn, {})
    tg = make(tsyn, {"device": "cpu"})
    assert (tg.n, tg.m) == (jg.n, jg.m)
    for name in ("row_ptr", "col_idx", "src", "out_deg"):
        _equal(getattr(tg, name), getattr(jg, name))
    assert t_fingerprint(tg) == j_fingerprint(jg)


@pytest.mark.parametrize("r", [1, 7, 64, 300])
def test_compaction_schedule_matches(r):
    assert twalks.compaction_schedule(r) == jwalks.compaction_schedule(r)
    assert twalks.compaction_schedule(r, max_steps=20, compact_every=6) == \
        jwalks.compaction_schedule(r, max_steps=20, compact_every=6)


def test_sample_edge_offsets_and_compact_slots_bitwise():
    r = np.random.default_rng(0)
    u = r.random(500).astype(np.float32)
    u[:3] = [0.0, np.float32(1.0) - np.float32(2.0 ** -24), 0.5]
    deg = r.integers(0, 9, 500).astype(np.int32)
    _equal(twalks.sample_edge_offsets(torch.from_numpy(u),
                                      torch.from_numpy(deg)),
           jwalks.sample_edge_offsets(jnp.asarray(u), jnp.asarray(deg)))
    cur = r.integers(0, 50, (6, 16)).astype(np.int32)
    alive = r.random((6, 16)) < 0.6
    for w_new in (4, 8, 16):
        got = twalks._compact_slots(torch.from_numpy(cur),
                                    torch.from_numpy(alive), w_new)
        want = jwalks._compact_slots(jnp.asarray(cur), jnp.asarray(alive),
                                     w_new)
        for a, b in zip(got, want):
            _equal(a, b)


@pytest.mark.parametrize("l,ep_l", [(24, None), (64, 0), (0, 16)])
def test_simulate_walks_sparse_bitwise(graphs, l, ep_l):
    jg, tg = graphs
    sources = np.arange(0, 64, 2, dtype=np.int32)
    key = jax.random.PRNGKey(11)
    want = jwalks.simulate_walks_sparse(jg, jnp.asarray(sources), 40, key,
                                        l=l, ep_l=ep_l)
    got = twalks.simulate_walks_sparse(
        tg, torch.from_numpy(sources), 40,
        convert.key_from_array(jax.random.key_data(key)), l=l, ep_l=ep_l)
    for name in ("moves", "walks", "truncated", "fp_dropped", "ep_dropped"):
        _equal(getattr(got, name), getattr(want, name))
    for sk in ("fp", "ep"):
        _equal(getattr(got, sk).values, getattr(want, sk).values)
        _equal(getattr(got, sk).indices, getattr(want, sk).indices)
    # conservation closes exactly, as in the reference
    assert torch.equal(got.fp.mass() + got.fp_dropped, got.moves)
    assert torch.all(got.walks == 40)


@pytest.mark.parametrize("source_batch,subset", [(128, False), (96, False),
                                                 (64, True)])
def test_build_index_bitwise(graphs, source_batch, subset):
    jg, tg = graphs
    key = jax.random.PRNGKey(7)
    sources = None
    if subset:   # duplicates are deduplicated up front in both packages
        sources = np.random.default_rng(1).integers(0, jg.n, 300)
    want, wstats = jindex.build_index(jg, r=16, l=32, key=key,
                                      source_batch=source_batch,
                                      sources=sources)
    got, gstats = tindex.build_index(
        tg, r=16, l=32, key=convert.key_from_array(jax.random.key_data(key)),
        source_batch=source_batch, sources=sources, device="cpu")
    _equal(got.values, want.values)
    _equal(got.indices, want.indices)
    assert (got.n, got.l) == (want.n, want.l)
    for k in ("sketch_l", "pad_rows", "pad_fraction", "duplicate_sources",
              "nbytes"):
        assert gstats[k] == wstats[k], k
    # the mass totals are f32 reductions over bit-equal rows: XLA and
    # PyTorch add in different orders, so they agree to f32 rounding
    for k in ("kept_mass", "dropped_mass", "drop_fraction"):
        assert gstats[k] == pytest.approx(wstats[k], rel=1e-6, abs=1e-9), k


def test_build_index_port_key_equals_reference_key(graphs):
    """``rng.prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: a build from
    either spelling of the key is the same index."""
    _, tg = graphs
    a, _ = tindex.build_index(tg, r=8, l=16, key=rng.prng_key(3),
                              source_batch=256, device="cpu")
    b, _ = tindex.build_index(
        tg, r=8, l=16,
        key=convert.key_from_array(jax.random.key_data(jax.random.PRNGKey(3))),
        source_batch=256, device="cpu")
    assert torch.equal(a.values, b.values) and torch.equal(a.indices,
                                                           b.indices)


def test_build_index_rejects_what_is_not_ported(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="unknown engine"):
        tindex.build_index(tg, r=4, l=8, key=rng.prng_key(0),
                           engine="dense", device="cpu")
    with pytest.raises(ValueError, match="sparse engine"):
        tindex.build_index(tg, r=4, l=8, key=rng.prng_key(0),
                           engine="legacy", respawn=True, device="cpu")
    with pytest.raises(ValueError, match="sparse engine"):
        tindex.build_index(tg, r=4, l=8, key=rng.prng_key(0),
                           engine="legacy", touch_bits=16, device="cpu")
    with pytest.raises(ValueError, match="requires engine='sparse'"):
        tindex.build_index(tg, r=4, l=8, key=rng.prng_key(0),
                           engine="legacy", checkpoint_dir="unused",
                           device="cpu")
