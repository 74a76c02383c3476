"""The distributed engine one shard a process (``RankMesh``) against the
stacked ``ShardMesh`` and the reference, on the CPU.

One module fixture spawns four gloo ranks (``tests/torch_rank_mesh_worker
.py``), which join through a ``file://`` store and run every scenario on
2 x 2, 1 x 4 and 4 x 1 meshes, each writing what it got.  The tests hold
each rank's outputs against the stacked mesh's for the same shard, bit for
bit, and the truncated 1 x 4 tile step against the reference's own
4-device ``shard_map`` step (``tests/test_torch_distributed.py`` run as a
script on four fake host devices, at the same time as the ranks) within
its 1e-5 L1 bar.  A rank that raises must fail the run within 60 s.
"""

import datetime
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_rank_mesh_worker as worker
from repro.core import frontier as JF
from repro.core import verd as jverd
from repro.core.index import build_index as jbuild_index
from repro.core.index import index_from_dense
from repro.core.power_iteration import exact_ppr_dense
from repro.graphs import synthetic as jsyn
from repro_torch import convert, rng
from repro_torch.core import frontier as TF
from repro_torch.distributed import RankMesh, ShardMesh
from repro_torch.distributed.mesh import fail_together
from repro_torch.launch import mesh as launch_mesh

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
INDEX_L = 16
SCENARIOS = ("collectives", "tile", "walk_counts", "sparse_walk_counts",
             "build", "refusals")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        _bits(a), _bits(b))


def _tile_inputs():
    """``tests/test_torch_distributed.py``'s tile case: erdos_renyi(120)
    padded to 128, its exact-PPR index at L = 16."""
    g = jsyn.erdos_renyi(120, 4.0, seed=3)
    dense = np.zeros((worker.N_PAD, worker.N_PAD), np.float32)
    dense[: g.n, : g.n] = exact_ppr_dense(g)
    index = index_from_dense(jnp.asarray(dense), l=INDEX_L)
    return dict(index_values=np.asarray(index.values),
                index_indices=np.asarray(index.indices),
                index_l=np.int64(INDEX_L),
                degree_cap=np.int64(jverd.resolve_degree_cap(g)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("rank_mesh")
    inputs = _tile_inputs()
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(HERE, "..", "src"))
    reference = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "test_torch_distributed.py"),
         str(out / "reference.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        got, seconds = worker.run_ranks(out, SCENARIOS, timeout_s=120.0,
                                        join_timeout_s=300.0)
        yield dict(ranks=got, inputs=inputs, seconds=seconds,
                   reference=reference, out=out)
    finally:
        if reference.poll() is None:
            reference.kill()
        reference.communicate()


def _shard(r, shape):
    return divmod(r, shape[1])


# -- collectives --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (1, 2)])
def test_rank_collectives_match_stacked(ranks, shape):
    """(1, 2) is a mesh over ranks 0 and 1 of the four."""
    want = worker.stacked_collectives(*shape)
    prefix = f"collectives/{shape[0]}x{shape[1]}/"
    for r, got in enumerate(ranks["ranks"][:shape[0] * shape[1]]):
        mine = want[_shard(r, shape)]
        for name, value in mine.items():
            assert _equal(got[prefix + name], value), (r, name)


# -- the tile step ------------------------------------------------------------

@pytest.mark.parametrize("label", sorted(worker.TILE_CASES))
def test_rank_tile_step_matches_stacked(ranks, label):
    if "compress_k" in worker.TILE_CASES[label]:
        with pytest.warns(DeprecationWarning, match="compress_k"):
            worker.tile_config(ranks["inputs"],
                               **worker.TILE_CASES[label])
    want = worker.stacked_tile(ranks["inputs"], label)
    for r, got in enumerate(ranks["ranks"]):
        assert _equal(got[f"tile/{label}/values"], want[0]), r
        assert _equal(got[f"tile/{label}/indices"], want[1]), r
        assert bool(got[f"tile/{label}/deprecation"]) == (
            "compress_k" in worker.TILE_CASES[label])


def test_rank_truncated_tile_matches_reference_four_devices(ranks):
    proc = ranks["reference"]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    want = np.load(ranks["out"] / "reference.npz")
    n = worker.N_PAD
    for got in ranks["ranks"]:
        diff = np.zeros((len(worker.SOURCES), n), np.float32)
        rows = np.arange(len(worker.SOURCES))[:, None]
        np.add.at(diff, (rows, got["tile/truncated_hub0/indices"]),
                  got["tile/truncated_hub0/values"])
        np.add.at(diff, (rows, want["indices"]), -want["values"])
        assert float(np.abs(diff).sum(axis=1).max()) <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dyadic", [True, False])
def test_ordered_dedup_matches_reference(seed, dyadic):
    """The tile step's ``ordered`` dedup (float64 prefix sums, a run's sum
    rounded once, no atomics): the reference's bits where every sum is
    exact (masses j / 1024), within one rounding of its f32 sums
    otherwise; its columns always the reference's."""
    r = np.random.default_rng(seed)
    vals = (r.integers(0, 1024, (6, 48)) / 1024.0 if dyadic
            else r.random((6, 48))).astype(np.float32)
    vals[:, 3] = 0.0
    idx = r.integers(0, 7, (6, 48)).astype(np.int32)
    for name, args in (("merge_duplicates", ()),
                       ("bucket_by_owner", (2, 4, 3))):
        want = getattr(JF, name)(jnp.asarray(vals), jnp.asarray(idx), *args)
        got = getattr(TF, name)(torch.from_numpy(vals),
                                torch.from_numpy(idx), *args, ordered=True)
        assert _equal(got[1].numpy(), np.asarray(want[1])), name
        if dyadic:
            assert _equal(got[0].numpy(), np.asarray(want[0])), name
        else:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                       rtol=3e-7, atol=0)


# -- the walk-counts steps ----------------------------------------------------

def test_rank_walk_counts_match_stacked(ranks):
    fp, moves = worker.stacked_walk_counts()
    ns = 32
    for r, got in enumerate(ranks["ranks"]):
        _, m = _shard(r, (2, 2))
        assert _equal(got["walk_counts/fp"], fp[:, m * ns:(m + 1) * ns]), r
        assert _equal(got["walk_counts/moves"], moves), r


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_rank_sparse_walk_counts_match_stacked(ranks, shape):
    want = worker.stacked_sparse_walk_counts(shape)
    prefix = f"sparse_walk_counts/{shape[0]}x{shape[1]}/"
    for r, got in enumerate(ranks["ranks"]):
        for name, value in zip(("fp_v", "fp_i", "moves", "walks",
                                "dropped"), want):
            assert _equal(got[prefix + name], value), (r, name)
    assert np.all(want[3] == 32)


# -- the sharded build --------------------------------------------------------

@pytest.mark.parametrize("label", sorted(worker.BUILD_CASES))
def test_rank_build_matches_stacked(ranks, label):
    shape, n, kw = worker.BUILD_CASES[label]
    index, stats = worker.stacked_build(label)
    ns = stats["n_pad"] // shape[1]
    for r, got in enumerate(ranks["ranks"]):
        _, m = _shard(r, shape)
        rows = slice(m * ns, (m + 1) * ns)
        key = f"build/{label}/"
        assert int(got[key + "row_offset"]) == m * ns
        assert _equal(got[key + "values"], index.values[rows].numpy()), r
        assert _equal(got[key + "indices"], index.indices[rows].numpy()), r
        if kw["touch_bits"]:
            assert _equal(got[key + "touch"], stats["touch"][rows].numpy())
        for total in ("kept", "dropped"):
            assert abs(float(got[key + total]) - stats[f"{total}_mass"]) <= \
                1e-6 * max(abs(stats[f"{total}_mass"]), 1.0)
    if n < stats["n_pad"]:
        assert float(index.values[n:].abs().sum()) == 0.0


def test_rank_build_matches_reference_single_device(ranks):
    """The 2 x 2 ranks' rows are the reference's single-device build at
    ``r_splits = 2`` over the same chunk grid."""
    key = jax.random.PRNGKey(3)
    assert torch.equal(convert.key_from_array(jax.random.key_data(key)),
                       rng.prng_key(3))
    _, n, kw = worker.BUILD_CASES["2x2_respawn"]
    want, _ = jbuild_index(jsyn.erdos_renyi(n, 4.0, seed=21), r=kw["r"],
                           l=kw["l"], key=key, source_batch=kw["source_batch"],
                           r_splits=2, respawn=True)
    values, indices = np.asarray(want.values), np.asarray(want.indices)
    for r, got in enumerate(ranks["ranks"]):
        _, m = _shard(r, (2, 2))
        rows = slice(m * 32, (m + 1) * 32)
        assert _equal(got["build/2x2_respawn/values"], values[rows]), r
        assert _equal(got["build/2x2_respawn/indices"], indices[rows]), r


# -- refusals and failure modes -----------------------------------------------

def test_rank_mesh_refusals_on_ranks(ranks):
    for got in ranks["ranks"]:
        for name in ("size", "meta", "data_mesh"):
            assert bool(got[f"refusals/{name}"]), name


def test_ranks_run_inside_their_budget(ranks):
    assert ranks["seconds"] < 120.0


@pytest.mark.parametrize("case", ["world_size", "meta", "nccl_missing",
                                  "nccl_two_ranks_one_device", "nccl_cpu",
                                  "no_group"])
def test_make_rank_mesh_refuses_before_joining(monkeypatch, tmp_path, case):
    store = "file://" + str(tmp_path / "store")
    kw = dict(init_method=store, rank=0, world_size=1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    if case == "world_size":
        call, err, match = (lambda: launch_mesh.make_rank_mesh(
            2, 2, device="cpu", **kw)), ValueError, "needs 4 ranks"
    elif case == "meta":
        call, err, match = (lambda: launch_mesh.make_rank_mesh(
            1, 1, device="meta", **kw)), ValueError, "meta"
    elif case == "nccl_missing":
        monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
        call, err, match = (lambda: launch_mesh.make_rank_mesh(
            1, 1, backend="nccl", **kw)), RuntimeError, "NCCL is not"
    elif case == "nccl_two_ranks_one_device":
        monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
        call, err, match = (lambda: launch_mesh.make_rank_mesh(
            1, 2, init_method=store, rank=1, world_size=2)), ValueError, \
            "one rank a device"
    elif case == "nccl_cpu":
        call, err, match = (lambda: launch_mesh.make_rank_mesh(
            1, 1, backend="nccl", device="cpu", **kw)), ValueError, "CUDA"
    else:
        call, err, match = (lambda: RankMesh(1, 1, "cpu")), RuntimeError, \
            "process group"
    with pytest.raises(err, match=match):
        call()
    assert not dist.is_initialized()


@pytest.mark.parametrize("failed", [False, True])
def test_stacked_mesh_broadcast_gather_and_vote_are_identities(failed):
    """``ShardMesh``'s ``broadcast`` and ``gather_blocks`` take
    ``RankMesh``'s call shapes, so ``fail_together`` votes on either."""
    mesh = ShardMesh(1, 4, "cpu")
    x = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    assert mesh.broadcast(x, src=0) is x
    assert [b is x for b in mesh.gather_blocks(x, "model", dst=None)] == [
        True]
    err = ValueError("this shard failed") if failed else None
    if failed:
        with pytest.raises(ValueError, match="this shard failed"):
            fail_together(mesh, err, "the step")
    else:
        fail_together(mesh, err, "the step")


@pytest.mark.parametrize("indices,clash", [((0, 1), False), ((0, 0), True)])
def test_named_nccl_devices_must_differ(indices, clash):
    """The store exchange ``make_rank_mesh`` runs before joining a NCCL
    group, by two ranks (threads here) on named devices of one host."""
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=30))
    errors = [None, None]

    def rank(r):
        try:
            launch_mesh.check_one_device_a_rank(
                store, r, 2, torch.device("cuda", indices[r]))
        except ValueError as e:
            errors[r] = e

    other = threading.Thread(target=rank, args=(1,))
    other.start()
    rank(0)
    other.join()
    for e in errors:
        assert (e is not None and "one rank a device" in str(e)) == clash


def test_failing_rank_fails_the_run_within_a_minute(ranks, tmp_path):
    """Rank 2 raises before the tile step's first collective; its peers
    wait there.  The run must fail, not hang."""
    np.savez(tmp_path / "inputs.npz", **ranks["inputs"])
    t0 = time.monotonic()
    with pytest.raises(Exception, match="fails on purpose"):
        worker.run_ranks(tmp_path, ["fail"], timeout_s=10.0,
                         join_timeout_s=60.0)
    assert time.monotonic() - t0 < 60.0


def test_ranks_cli_stacked_run_prints_its_digest(capsys):
    """``python -m repro_torch.launch.ranks --stacked``: the digest that a
    ``torchrun`` of the same sizes must print on every rank."""
    from repro_torch.launch import ranks as ranks_cli

    args = ["--stacked", "--device", "cpu", "--model", "2", "--n-log2", "8",
            "--walks", "4", "--index-l", "8", "--source-batch", "32",
            "--requests", "16", "--q-tile", "8", "--serve", "16"]
    assert ranks_cli.main(args) == 0
    first = capsys.readouterr().out
    assert '"digest": "' in first and "2 tiles of 8" in first
    assert '"service": "stacked", "served": 16' in first
    assert '"service_digest": "' in first
    assert ranks_cli.main(args) == 0
    again = capsys.readouterr().out
    for line in (0, 2):     # the tiles' digest, the service's
        assert again.split("\n")[line].split('digest"')[1] == \
            first.split("\n")[line].split('digest"')[1]
