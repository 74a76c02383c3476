"""The port's distributed engine against the reference's, on the CPU.

Shards are stacked on one device (``repro_torch.distributed.ShardMesh``);
the reference runs its one-shard steps in process and its four-shard step
in a subprocess with four fake host devices (this file, run as a script).
Its Pallas kernel runs in interpret mode, as ``tests/test_kernels.py``
runs it.  Inputs are made by numpy from a seed and fed to both packages
through ``repro_torch.convert``.

* ``bucket_by_owner``: indices equal, values bit-equal;
* ``sharded_frontier_push`` (plain version): indices equal, values within
  1e-6 relative (bit-equal on dyadic inputs);
* the tile step: within 1e-5 L1 on densified rows of its oracles, the
  dense exchange within 1e-4 (the reference's own bars);
* the build: respawn-mode walks, ``build_index(r_splits=2,
  respawn=True)`` and ``build_index_sharded`` bit-equal to the reference.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed_engine as jde
from repro.core import frontier as JF
from repro.core import verd as jverd
from repro.core import walks as jwalks
from repro.core.graph import Graph as JGraph
from repro.core.index import build_index as jbuild_index
from repro.core.index import index_from_dense
from repro.core.power_iteration import exact_ppr_dense
from repro.graphs import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import distributed_engine as tde
from repro_torch.core import frontier as TF
from repro_torch.core import index as tindex
from repro_torch.core import walks as twalks
from repro_torch.distributed import ShardMesh
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

N_PAD = 128        # the tile-step graph: erdos_renyi(120) padded
INDEX_L = 16
SOURCES = np.array([0, 3, 7, 11, 19, 23, 31, 42], np.int32)
TRUNCATED = dict(frontier_k=4, wire_k=4, combine_wire_k=8)


def densify(values, indices, n):
    values = np.asarray(values)
    out = np.zeros((values.shape[0], n), np.float32)
    np.add.at(out, (np.arange(values.shape[0])[:, None], np.asarray(indices)),
              values)
    return out


def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _port_graph(g):
    return convert.graph_from_arrays(
        g.row_ptr, g.col_idx, g.src, g.out_deg, g.n, g.m, device="cpu")


def _key():
    key = jax.random.PRNGKey(3)
    return key, convert.key_from_array(jax.random.key_data(key))


def tile_case():
    """The graph, padded exact-PPR index and config base of the tile-step
    tests (``tests/parity_check.py``'s)."""
    g = jsyn.erdos_renyi(120, 4.0, seed=3)
    dense = np.zeros((N_PAD, N_PAD), np.float32)
    dense[: g.n, : g.n] = exact_ppr_dense(g)
    index = index_from_dense(jnp.asarray(dense), l=INDEX_L)
    base = dict(n=N_PAD, q_tile=len(SOURCES), t_iterations=2,
                index_l=INDEX_L, top_k=N_PAD,
                degree_cap=jverd.resolve_degree_cap(g))
    return g, dense, index, base


def run_port_step(g, index, ep, exchange="sparse", **kw):
    cfg = tde.DistConfig(ep=ep, exchange=exchange, **kw)
    slabs = tde.build_sharded_graph(_port_graph(g), cfg, device="cpu")
    iv, ii = convert.sharded_index_from_arrays(
        np.asarray(index.values), np.asarray(index.indices), ep, device="cpu")
    v, i = tde.make_verd_tile_step(cfg, ShardMesh(1, ep, device="cpu"))(
        slabs, _t(SOURCES), iv, ii)
    return v.numpy(), i.numpy()


def run_reference_step(g, index, ep, mesh, exchange="sparse", **kw):
    cfg = jde.DistConfig(ep=ep, exchange=exchange, **kw)
    slabs = jde.build_sharded_graph(g, cfg)
    ns = cfg.n_shard
    step = jde.make_verd_tile_step(cfg, mesh)
    with mesh:
        v, i = jax.jit(step)(slabs, jnp.asarray(SOURCES),
                             index.values.reshape(ep, ns, INDEX_L),
                             index.indices.reshape(ep, ns, INDEX_L))
    return np.asarray(v), np.asarray(i)


def _l1(a, b, n=N_PAD):
    return float(np.abs(densify(*a, n) - densify(*b, n)).sum(axis=1).max())


# -- bucket_by_owner -----------------------------------------------------------

@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("k", [3, 12])     # n_shard = 8: truncating, covering
def test_bucket_by_owner_matches_reference(ep, k):
    r = np.random.default_rng(ep * 10 + k)
    ns = 8
    vals = (r.integers(0, 6, (6, 40)) / 8).astype(np.float32)  # ties, zeros
    idx = r.integers(0, ep * ns, (6, 40)).astype(np.int32)     # duplicates
    want = JF.bucket_by_owner(jnp.asarray(vals), jnp.asarray(idx), ep, ns, k)
    got = TF.bucket_by_owner(_t(vals), _t(idx), ep, ns, k)
    assert got[0].shape == (6, ep, k) and got[1].dtype == torch.int32
    assert np.array_equal(_bits(got[0].numpy()), _bits(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_bucket_by_owner_global_indices():
    r = np.random.default_rng(5)
    vals = (r.integers(1, 6, (3, 20)) / 4).astype(np.float32)
    idx = r.integers(0, 24, (3, 20)).astype(np.int32)
    want = JF.bucket_by_owner(jnp.asarray(vals), jnp.asarray(idx), 3, 8, 5,
                              to_local=False)
    got = TF.bucket_by_owner(_t(vals), _t(idx), 3, 8, 5, to_local=False)
    assert np.array_equal(_bits(got[0].numpy()), _bits(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


# -- sharded_frontier_push -----------------------------------------------------

def _push_graph(kind):
    """``erdos_renyi`` or a graph whose hub spans many sub-slots, each with
    dangling vertices; padded to ``(n_pad, ep)``."""
    if kind == "er":
        return jsyn.erdos_renyi(60, 4.0, seed=11), 64, 2
    r = np.random.default_rng(3)
    n = 40
    src = np.concatenate([np.zeros(22, np.int64), r.integers(1, 30, 70)])
    dst = np.concatenate([r.integers(0, n, 22), r.integers(0, n, 70)])
    return JGraph.from_edges(src, dst, n=n), 48, 2


def _push_inputs(r, q, k, ns, dyadic=False):
    fv = (r.integers(1, 64, (q, k)) / 64.0 if dyadic
          else r.random((q, k))).astype(np.float32)
    fv[:, 1] = 0.0                 # zero slots
    fv[2] = 0.0                    # an empty row
    fi = r.integers(0, ns, (q, k)).astype(np.int32)
    fi[:, 0] = ns - 1              # a pad row or a dangling vertex
    return fv, fi


@pytest.mark.parametrize("kind", ["er", "hub"])
@pytest.mark.parametrize("hub_split_degree", [0, 2])
@pytest.mark.parametrize("covering", [True, False])
def test_sharded_push_plain_matches_reference(kind, hub_split_degree,
                                              covering):
    g, n_pad, ep = _push_graph(kind)
    cap = jverd.resolve_degree_cap(g)
    jcfg = jde.DistConfig(n=n_pad, ep=ep, degree_cap=cap)
    jslabs = jde.build_sharded_graph(g, jcfg)
    slabs = convert.sharded_graph_from_arrays(
        jslabs.row_ptr, jslabs.col_idx, jslabs.edge_w, jslabs.dangling,
        device="cpu")
    ns = jcfg.n_shard
    wire_k = ns if covering else 3
    fv, fi = _push_inputs(np.random.default_rng(hub_split_degree), 5, 8, ns)
    kw = dict(c=0.15, degree_cap=cap, ep=ep, n_shard=ns, wire_k=wire_k)
    for s in range(ep):
        got = tops.sharded_frontier_push(
            _t(fv), _t(fi), slabs.row_ptr[s], slabs.col_idx[s],
            hub_split_degree=hub_split_degree, **kw)
        want = jops.sharded_frontier_push(
            jnp.asarray(fv), jnp.asarray(fi), jslabs.row_ptr[s],
            jslabs.col_idx[s], hub_split_degree=hub_split_degree, q_tile=1,
            interpret=True, **kw)
        assert got[0].shape == (5, ep, wire_k)
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=0)
        assert float(got[0][2].abs().max()) == 0.0     # empty row
        if covering:
            rkw = dict(c=0.15, ep=ep, n_shard=ns, wire_k=wire_k)
            oracle = jref.sharded_push_ref(
                jnp.asarray(fv), jnp.asarray(fi), jslabs.row_ptr[s],
                jslabs.col_idx[s], **rkw)
            port_oracle = tref.sharded_push_ref(
                _t(fv), _t(fi), slabs.row_ptr[s], slabs.col_idx[s], **rkw)
            for a in (oracle, got):
                assert np.array_equal(port_oracle[1].numpy(), np.asarray(a[1]))
                np.testing.assert_allclose(port_oracle[0].numpy(),
                                           np.asarray(a[0]), rtol=1e-6,
                                           atol=1e-12)


def test_sharded_push_plain_bitwise_on_dyadic_inputs():
    """Power-of-two degrees at c = 0.5 and masses j/64: every sum is exact,
    so the port equals the reference bit for bit."""
    r = np.random.default_rng(7)
    n = 32
    degs = r.choice([0, 1, 2, 4, 8], n)
    src = np.repeat(np.arange(n), degs)
    g = JGraph.from_edges(src, r.integers(0, n, src.shape[0]), n=n)
    cap = jverd.resolve_degree_cap(g)
    jcfg = jde.DistConfig(n=n, ep=4, degree_cap=cap)
    jslabs = jde.build_sharded_graph(g, jcfg)
    slabs = convert.sharded_graph_from_arrays(
        jslabs.row_ptr, jslabs.col_idx, jslabs.edge_w, jslabs.dangling,
        device="cpu")
    fv, fi = _push_inputs(r, 6, 6, jcfg.n_shard, dyadic=True)
    kw = dict(c=0.5, degree_cap=cap, ep=4, n_shard=8, wire_k=3)
    for s in range(4):
        got = tops.sharded_frontier_push(
            _t(fv), _t(fi), slabs.row_ptr[s], slabs.col_idx[s], **kw)
        want = jops.sharded_frontier_push(
            jnp.asarray(fv), jnp.asarray(fi), jslabs.row_ptr[s],
            jslabs.col_idx[s], q_tile=2, interpret=True, **kw)
        assert np.array_equal(_bits(got[0].numpy()), _bits(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_sharded_push_plain_blocks_rows(monkeypatch):
    """The plain version's row blocks do not change its answer."""
    from repro_torch.kernels import frontier_push as push_k

    g, n_pad, ep = _push_graph("hub")
    cfg = tde.DistConfig(n=n_pad, ep=ep, degree_cap=22)
    slabs = tde.build_sharded_graph(_port_graph(g), cfg, device="cpu")
    fv, fi = _push_inputs(np.random.default_rng(1), 7, 5, cfg.n_shard)
    kw = dict(c=0.15, degree_cap=22, ep=ep, n_shard=cfg.n_shard, wire_k=6,
              hub_split_degree=4)
    args = (_t(fv), _t(fi), slabs.row_ptr[0], slabs.col_idx[0])
    whole = push_k.sharded_frontier_push_plain(*args, **kw)
    monkeypatch.setattr(push_k, "PLAIN_BLOCK_ELEMS", 1)
    blocked = push_k.sharded_frontier_push_plain(*args, **kw)
    assert torch.equal(whole[0], blocked[0])
    assert torch.equal(whole[1], blocked[1])


# -- the tile step -------------------------------------------------------------

@pytest.fixture(scope="module")
def tile():
    return tile_case()


@pytest.mark.parametrize("widths", [dict(frontier_k=N_PAD), TRUNCATED, {}])
def test_tile_step_one_shard_matches_reference(tile, widths):
    g, _, index, base = tile
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = run_reference_step(g, index, 1, mesh, **base, **widths)
    got = run_port_step(g, index, 1, **base, **widths)
    assert _l1(got, want) <= 1e-5
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("hub_split_degree", [0, 3])
def test_tile_step_four_shards_covering_matches_single_device(
        tile, hub_split_degree):
    """``tests/parity_check.py``'s closure: at covering widths the 4-shard
    sparse exchange equals the single-device sparse and dense queries."""
    g, dense, index, base = tile
    small = index_from_dense(jnp.asarray(dense[: g.n, : g.n]), l=INDEX_L)
    got = densify(*run_port_step(g, index, 4, frontier_k=N_PAD,
                                 hub_split_degree=hub_split_degree, **base),
                  N_PAD)
    single = np.zeros_like(got)
    single[:, : g.n] = np.asarray(jverd.verd_query_sparse(
        g, jnp.asarray(SOURCES), small, t=2, k=g.n, out_k=N_PAD).densify())
    oracle = np.zeros_like(got)
    oracle[:, : g.n] = np.asarray(jverd.verd_query(
        g, jnp.asarray(SOURCES), small, t=2))
    assert np.abs(got - single).sum(axis=1).max() <= 1e-5
    assert np.abs(got - oracle).sum(axis=1).max() <= 1e-5


def test_tile_step_four_shards_truncated_matches_reference_four_shards(
        tile, tmp_path):
    """The truncated exchange has no single-device oracle: the reference's
    own 4-shard step runs in a subprocess with four fake host devices."""
    out = tmp_path / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    want = np.load(out)
    g, _, index, base = tile
    got = run_port_step(g, index, 4, **base, **TRUNCATED)
    assert _l1(got, (want["values"], want["indices"])) <= 1e-5


def test_dense_exchange_matches_dense_oracle(tile):
    g, dense, index, base = tile
    small = index_from_dense(jnp.asarray(dense[: g.n, : g.n]), l=INDEX_L)
    got = densify(*run_port_step(g, index, 4, exchange="dense",
                                 **dict(base, edge_chunk=100)), N_PAD)
    want = np.zeros_like(got)
    want[:, : g.n] = np.asarray(jverd.verd_query(
        g, jnp.asarray(SOURCES), small, t=2))
    assert np.abs(got - want).sum(axis=1).max() <= 1e-4


def test_dense_exchange_compress_k_matches_reference(tile):
    """The deprecated top-k'd slab exchange against the reference's own."""
    g, _, index, base = tile
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with pytest.warns(DeprecationWarning, match="compress_k"):
        want = run_reference_step(g, index, 1, mesh, exchange="dense",
                                  compress_k=8, **base)
    with pytest.warns(DeprecationWarning, match="compress_k"):
        got = run_port_step(g, index, 1, exchange="dense", compress_k=8,
                            **base)
    assert _l1(got, want) <= 1e-5


def test_tile_step_pushes_once_per_shard_and_iteration(tile, monkeypatch):
    """The sparse step goes through the kernel wrapper ``t * ep`` times per
    tile (on the card each call is one launch: ``tests/test_torch_cuda.py``
    counts them there)."""
    calls = []
    real = tops.sharded_frontier_push

    def spy(*args, **kwargs):
        calls.append(kwargs["ep"])
        return real(*args, **kwargs)

    monkeypatch.setattr(tops, "sharded_frontier_push", spy)
    g, _, index, base = tile
    run_port_step(g, index, 4, **dict(base, t_iterations=3))
    assert calls == [4] * (3 * 4)


@pytest.mark.parametrize("cfg", [
    dict(n=100_000, ep=4, q_tile=256, frontier_k=512, wire_k=512,
         degree_cap=1),
    dict(n=64, ep=2, q_tile=8),
    dict(n=1 << 20, ep=4, q_tile=256, top_k=50, degree_cap=27948,
         hub_split_degree=64),
    dict(n=64, ep=4, q_tile=8, wire_k=3, combine_wire_k=40, top_k=30),
])
@pytest.mark.parametrize("bf16", [False, True])
def test_config_and_wire_bytes_match_reference(cfg, bf16):
    if bf16:
        jc = jde.DistConfig(**cfg, wire_dtype=jnp.bfloat16)
        tc = tde.DistConfig(**cfg, wire_dtype=torch.bfloat16)
    else:
        jc, tc = jde.DistConfig(**cfg), tde.DistConfig(**cfg)
    for name in ("n_shard", "resolved_frontier_k", "resolved_wire_k",
                 "resolved_combine_wire_k"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert tde.exchange_bytes_per_iteration(tc) == \
        jde.exchange_bytes_per_iteration(jc)


def test_config_rejects_and_warns():
    with pytest.warns(DeprecationWarning, match="compress_k"):
        cfg = tde.DistConfig(n=64, ep=2, compress_k=16)
    assert cfg.resolved_wire_k == 16
    with pytest.raises(ValueError, match="exchange"):
        tde.DistConfig(n=64, ep=2, exchange="bogus")
    mesh = ShardMesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="degree_cap"):
        tde.make_verd_tile_step(tde.DistConfig(n=64, ep=2), mesh)
    with pytest.raises(ValueError, match="shards"):
        tde.make_verd_tile_step(tde.DistConfig(n=64, ep=4, degree_cap=3),
                                mesh)


def test_mesh_collectives_match_their_definitions():
    r = np.random.default_rng(0)
    mesh = ShardMesh(data=1, model=3, device="cpu")
    assert mesh.shape == {"data": 1, "model": 3} and mesh.size == 3
    sent = _t(r.random((3, 2, 3, 4)).astype(np.float32))  # [from, Q, to, k]
    recv = mesh.all_to_all(sent)
    for src in range(3):
        for dst in range(3):
            assert torch.equal(recv[dst, :, src], sent[src, :, dst])
    x = _t(r.random((3, 2, 5)).astype(np.float32))
    assert torch.equal(mesh.all_gather(x), torch.cat(list(x), dim=1))
    assert torch.allclose(mesh.psum(x), x[0] + x[1] + x[2])
    with pytest.raises(ValueError):
        ShardMesh(0, 1, device="cpu")


def test_sharded_graph_matches_reference_slabs():
    g = jsyn.erdos_renyi(60, 4.0, seed=11)
    for exchange in ("sparse", "dense"):
        jc = jde.DistConfig(n=64, ep=4, exchange=exchange)
        want = jde.build_sharded_graph(g, jc)
        got = tde.build_sharded_graph(
            _port_graph(g), tde.DistConfig(n=64, ep=4, exchange=exchange),
            device="cpu")
        for name in ("row_ptr", "col_idx", "edge_w", "dangling"):
            assert np.array_equal(_bits(getattr(got, name).numpy()),
                                  _bits(getattr(want, name))), name


# -- the offline half ------------------------------------------------------------

@pytest.mark.parametrize("r,width", [(64, 0), (10, 0), (32, 4), (300, 0)])
def test_respawn_schedule_matches_reference(r, width):
    want = jwalks.respawn_schedule(r, width=width)
    assert twalks.respawn_schedule(r, width=width) == want
    assert twalks.schedule_slot_area(*want) == \
        jwalks.schedule_slot_area(*want)
    assert twalks.respawn_schedule(r, c=0.3, max_steps=20, width=width) == \
        jwalks.respawn_schedule(r, c=0.3, max_steps=20, width=width)


@pytest.mark.parametrize("r,width", [(64, 0), (10, 0), (32, 4)])
def test_respawn_walks_bitwise(r, width):
    g = jsyn.erdos_renyi(64, 4.0, seed=21)
    key, tkey = _key()
    src = np.arange(3, 19, dtype=np.int32)
    want = jwalks.simulate_walks_sparse(g, jnp.asarray(src), r, key, l=24,
                                        respawn=True, respawn_width=width)
    got = twalks.simulate_walks_sparse(_port_graph(g), _t(src), r, tkey,
                                       l=24, respawn=True,
                                       respawn_width=width)
    for a, b in [(got.fp.values, want.fp.values),
                 (got.fp.indices, want.fp.indices),
                 (got.ep.values, want.ep.values),
                 (got.ep.indices, want.ep.indices), (got.moves, want.moves),
                 (got.walks, want.walks), (got.truncated, want.truncated),
                 (got.fp_dropped, want.fp_dropped),
                 (got.ep_dropped, want.ep_dropped)]:
        assert np.array_equal(_bits(a.numpy()), _bits(b))
    assert np.all(got.walks.numpy() == r)


@pytest.fixture(scope="module")
def build_graph():
    return jsyn.erdos_renyi(64, 4.0, seed=21)


@pytest.mark.parametrize("l", [64, 6])          # covering, truncating
def test_build_index_r_splits_respawn_bitwise(build_graph, l):
    key, tkey = _key()
    want, wstats = jbuild_index(build_graph, r=64, l=l, key=key,
                                source_batch=16, r_splits=2, respawn=True)
    got, stats = tindex.build_index(_port_graph(build_graph), r=64, l=l,
                                    key=tkey, source_batch=16, r_splits=2,
                                    respawn=True, device="cpu")
    assert np.array_equal(_bits(got.values.numpy()), _bits(want.values))
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert stats["respawn"] and stats["r_splits"] == 2
    assert abs(stats["drop_fraction"] - wstats["drop_fraction"]) <= 1e-6


@pytest.mark.parametrize("l", [64, 6])
def test_build_index_sharded_equals_single_device_reference(build_graph, l):
    """``tests/dist_engine_check.py``'s gate: the sharded build on a 2 x 2
    mesh equals the reference's single-device build at ``r_splits=2``."""
    key, tkey = _key()
    want, wstats = jbuild_index(build_graph, r=64, l=l, key=key,
                                source_batch=16, r_splits=2, respawn=True)
    got, stats = tindex.build_index_sharded(
        _port_graph(build_graph), r=64, l=l, key=tkey,
        mesh=ShardMesh(data=2, model=2, device="cpu"), source_batch=16)
    assert (got.n, stats["n_pad"], stats["shards"], stats["r_splits"]) == \
        (64, 64, 2, 2)
    assert np.array_equal(_bits(got.values.numpy()), _bits(want.values))
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert abs(stats["drop_fraction"] - wstats["drop_fraction"]) <= 1e-6


def test_build_index_sharded_pads_and_zeroes_pad_rows():
    g = jsyn.erdos_renyi(60, 4.0, seed=11)     # n = 60 -> n_pad = 64
    key, tkey = _key()
    got, stats = tindex.build_index_sharded(
        _port_graph(g), r=32, l=8, key=tkey,
        mesh=ShardMesh(data=2, model=2, device="cpu"), source_batch=16)
    assert got.n == 64 and stats["pad_rows"] == 4
    assert float(got.values[g.n:].abs().sum()) == 0.0
    assert int(got.indices[g.n:].abs().sum()) == 0
    want, _ = jbuild_index(g, r=32, l=8, key=key, source_batch=16,
                           r_splits=2, respawn=True)
    assert np.array_equal(_bits(got.values[: g.n].numpy()),
                          _bits(want.values))
    assert np.array_equal(got.indices[: g.n].numpy(),
                          np.asarray(want.indices))


def test_build_index_sharded_one_replica_schedule_mode(build_graph):
    """``data=1`` without respawn is the single-device build itself."""
    _, tkey = _key()
    tg = _port_graph(build_graph)
    got, _ = tindex.build_index_sharded(
        tg, r=16, l=8, key=tkey, mesh=ShardMesh(1, 4, device="cpu"),
        source_batch=16, respawn=False)
    want, _ = tindex.build_index(tg, r=16, l=8, key=tkey, source_batch=16,
                                 device="cpu")
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.indices, want.indices)


def test_build_index_sharded_clamps_source_batch(build_graph):
    _, tkey = _key()
    with pytest.warns(UserWarning, match="clamped"):
        _, stats = tindex.build_index_sharded(
            _port_graph(build_graph), r=4, l=4, key=tkey,
            mesh=ShardMesh(1, 4, device="cpu"), source_batch=64)
    assert stats["source_batch"] == 16


def test_sparse_walk_counts_step_conserves_and_matches_one_shard():
    g = jsyn.erdos_renyi(64, 4.0, seed=21)
    key, tkey = _key()
    tg = _port_graph(g)
    src = np.arange(8, dtype=np.int32)
    cfg = tde.DistConfig(n=64, ep=2)
    fn = tde.make_sparse_walk_counts_step(cfg, ShardMesh(2, 2, device="cpu"),
                                          r=32, l=12)
    fp_v, _, moves, walks, dropped = fn(tg.row_ptr, tg.col_idx, tg.out_deg,
                                        _t(src), tkey)
    assert np.all(walks.numpy() == 32)
    assert torch.equal(fp_v.sum(dim=1) + dropped, moves)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jcfg = jde.DistConfig(n=64, ep=1)
    jfn = jde.make_sparse_walk_counts_step(jcfg, jmesh, r=8, l=12)
    with jmesh:
        want = jax.jit(jfn)(g.row_ptr, g.col_idx, g.out_deg,
                            jnp.asarray(src), key)
    got = tde.make_sparse_walk_counts_step(
        tde.DistConfig(n=64, ep=1), ShardMesh(1, 1, device="cpu"), r=8,
        l=12)(tg.row_ptr, tg.col_idx, tg.out_deg, _t(src), tkey)
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a.numpy()), _bits(b))


def test_unported_build_options_raise(build_graph):
    _, tkey = _key()
    tg = _port_graph(build_graph)
    mesh = ShardMesh(1, 2, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_every"):
        tindex.build_index_sharded(tg, r=4, l=4, key=tkey, mesh=mesh,
                                   checkpoint_dir="unused",
                                   checkpoint_every=0)
    with pytest.raises(ValueError, match="divide"):
        tindex.build_index_sharded(tg, r=5, l=4, key=tkey,
                                   mesh=ShardMesh(2, 2, device="cpu"))


@pytest.fixture()
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_distributed_entry_points_default_to_cuda(no_gpu, build_graph):
    tg = _port_graph(build_graph)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardMesh(data=1, model=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tde.build_sharded_graph(tg, tde.DistConfig(n=64, ep=2))
    with pytest.raises(RuntimeError, match="cuda"):
        convert.sharded_index_from_arrays(np.zeros((4, 2), np.float32),
                                          np.zeros((4, 2), np.int32), 2)


def _reference_four_shard_step(out_path):
    """Subprocess body: the reference's truncated 4-shard step on four fake
    host devices (the environment sets ``XLA_FLAGS``)."""
    assert jax.device_count() == 4, jax.devices()
    g, _, index, base = tile_case()
    mesh = jax.make_mesh((1, 4), ("data", "model"))
    v, i = run_reference_step(g, index, 4, mesh, **base, **TRUNCATED)
    np.savez(out_path, values=v, indices=i)


if __name__ == "__main__":
    _reference_four_shard_step(sys.argv[1])
