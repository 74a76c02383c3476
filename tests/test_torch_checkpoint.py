"""Crash-safe builds of the port: a resumed build equals an uninterrupted
one bit for bit (values, indices, touch filters and ledger totals), on
one device and on a sharded mesh, with ``.tmp`` dirs and corrupt steps
never restored and a foreign build refused.  Checkpoints cross-load: the
port resumes and loads the JAX package's build checkpoints and the JAX
package the port's.  ``PPRService.from_checkpoint`` boots plain and
maintainable builds.

In-process tests inject clean Python faults
(:mod:`repro_torch.testing.faults`); one test SIGKILLs builds for real by
running this file as a script in a subprocess:

    PYTHONPATH=src python tests/test_torch_checkpoint.py build DIR [--kill-chunk N] [--kill-commit N] [--resume]
"""

import concurrent.futures
import hashlib
import os
import signal
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.core import index as jindex
from repro.core import updates as jupdates
from repro.distributed import checkpoint as jckpt
from repro.graphs import synthetic as jsyn
from repro.testing import FaultPlan as JFaultPlan
from repro.testing import InjectedFault as JInjectedFault
from repro_torch import convert, rng
from repro_torch.core.graph import Graph
from repro_torch.core.index import (build_index, build_index_sharded,
                                    load_index_checkpoint)
from repro_torch.core.updates import (apply_updates, build_maintainable_index,
                                      load_maintainable_index)
from repro_torch.distributed import ShardMesh
from repro_torch.distributed.checkpoint import (CheckpointCorruptionError,
                                                Checkpointer,
                                                deserialize_key,
                                                serialize_key)
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving import PPRService
from repro_torch.testing import FaultPlan, InjectedFault

torch.set_num_threads(1)

# rmat(10) at source_batch 128: 8 chunks
BUILD = dict(c=0.25, max_steps=24, source_batch=128, touch_bits=64)
R, L = 4, 8
KEY = 5


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return dict(vals=torch.from_numpy(r.normal(size=(6, 4)).astype(np.float32)),
                idxs=r.integers(0, 100, (6, 4)).astype(np.int32),
                mask=torch.from_numpy(r.integers(0, 2, 6).astype(bool)))


@pytest.fixture(scope="module")
def graphs():
    return (jsyn.rmat(10, avg_deg=6.0, seed=7),
            tsyn.rmat(10, avg_deg=6.0, seed=7, device="cpu"))


@pytest.fixture(scope="module")
def reference(graphs):
    """Uninterrupted, checkpoint-free single-device port build."""
    return build_index(graphs[1], R, L, rng.prng_key(KEY), device="cpu",
                       **BUILD)


def _build(g, ckpt_dir, **kw):
    return build_index(g, R, L, rng.prng_key(KEY), device="cpu",
                       checkpoint_dir=str(ckpt_dir), **{**BUILD, **kw})


def _assert_index_equal(index, stats, ref_index, ref_stats):
    assert torch.equal(index.values, ref_index.values)
    assert torch.equal(index.indices, ref_index.indices)
    assert torch.equal(stats["touch"], ref_stats["touch"])
    assert stats["kept_mass"] == ref_stats["kept_mass"]
    assert stats["dropped_mass"] == ref_stats["dropped_mass"]


# -- the store -------------------------------------------------------------------

def test_save_restore_round_trip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(3, tree, dict(note="x"))
    got, extra = ck.restore(3)
    assert extra == dict(note="x") and sorted(got) == sorted(tree)
    for k, v in tree.items():
        want = v.numpy() if torch.is_tensor(v) else v
        assert got[k].dtype == want.dtype
        assert np.array_equal(got[k], want)
    meta = ck.read_meta(3)
    assert meta["keys"] == ["idxs", "mask", "vals"]
    assert meta["dtypes"] == ["int32", "bool", "float32"]


def test_tmp_dirs_invisible_and_keep_prunes(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        ck.save(step, _tree(step))
    os.makedirs(tmp_path / "step_9.tmp")
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3


@pytest.mark.parametrize("damage", ["bytes", "shape", "missing"])
def test_corruption_detected_and_restore_falls_back(tmp_path, damage):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1), dict(step=1))
    ck.save(2, _tree(2), dict(step=2))
    shard = tmp_path / "step_2" / "arr_0.npy"
    if damage == "bytes":
        raw = bytearray(shard.read_bytes())
        raw[-8:] = b"\xaa" * 8
        shard.write_bytes(bytes(raw))
    elif damage == "shape":
        np.save(shard, np.zeros((2, 2), np.int32))
    else:
        shard.unlink()
    assert not ck.verify_step(2) and ck.verify_step(1)
    with pytest.raises((CheckpointCorruptionError, OSError)):
        ck.restore(2)
    step, tree, extra = ck.restore_latest()
    assert step == 1 and extra == dict(step=1)
    assert np.array_equal(tree["idxs"], _tree(1)["idxs"])


def test_restore_latest_predicate_skips_steps(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1), dict(complete=True))
    ck.save(2, _tree(2), dict(complete=False))
    step, _, _ = ck.restore_latest(predicate=lambda e: e["complete"])
    assert step == 1
    assert ck.restore_latest(predicate=lambda e: False) is None


def test_async_save_commits_and_error_surfaces_at_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1), blocking=False)
    ck.wait()
    assert ck.all_steps() == [1]

    def fail(step):
        raise OSError(f"disk full at {step}")

    ck.pre_commit = fail
    ck.save(2, _tree(2), blocking=False)
    with pytest.raises(OSError, match="disk full at 2"):
        ck.wait()
    ck.wait()  # raised once
    assert ck.all_steps() == [1]


def test_key_serialization_matches_reference():
    for k in (jax.random.PRNGKey(5), jax.random.fold_in(
            jax.random.PRNGKey(3), 2**31 + 7)):
        want = jckpt.serialize_key(k)
        got = serialize_key(convert.key_from_array(k))
        assert got == want
        assert np.array_equal(deserialize_key(want).numpy(),
                              np.asarray(k).astype(np.int64))
        assert np.array_equal(np.asarray(jckpt.deserialize_key(got)),
                              np.asarray(k))
    typed = jckpt.serialize_key(jax.random.key(5))
    assert np.array_equal(deserialize_key(typed).numpy(), [0, 5])
    with pytest.raises(ValueError):
        deserialize_key(dict(impl="rbg", data=[1, 2, 3, 4]))


# -- crash-safe single-device builds ------------------------------------------------

def test_checkpointed_build_matches_plain_build(graphs, reference, tmp_path):
    index, stats = _build(graphs[1], tmp_path, checkpoint_every=3)
    _assert_index_equal(index, stats, *reference)
    assert stats["checkpoint_commits"] == 2      # partials at 3 and 6
    assert Checkpointer(str(tmp_path)).latest_step() == 8


@pytest.mark.parametrize("crash_chunk", [1, 4, 7])
def test_resume_after_crash_is_bitwise(graphs, reference, tmp_path,
                                       crash_chunk):
    with pytest.raises(InjectedFault):
        _build(graphs[1], tmp_path, checkpoint_every=1,
               fault_plan=FaultPlan(raise_at_chunks=(crash_chunk,)))
    index, stats = _build(graphs[1], tmp_path, checkpoint_every=1,
                          resume=True)
    assert stats["resumed_at_chunk"] == crash_chunk
    _assert_index_equal(index, stats, *reference)


def test_mid_commit_crash_leaves_only_tmp(graphs, reference, tmp_path):
    with pytest.raises(InjectedFault):
        _build(graphs[1], tmp_path, checkpoint_every=1,
               fault_plan=FaultPlan(raise_mid_commit=(3,)))
    names = sorted(os.listdir(tmp_path))
    assert "step_3.tmp" in names and "step_3" not in names
    index, stats = _build(graphs[1], tmp_path, checkpoint_every=1,
                          resume=True)
    assert stats["resumed_at_chunk"] == 2
    _assert_index_equal(index, stats, *reference)


def test_corrupted_step_is_never_restored(graphs, reference, tmp_path):
    with pytest.raises(InjectedFault):
        _build(graphs[1], tmp_path, checkpoint_every=1,
               fault_plan=FaultPlan(raise_at_chunks=(5,)))
    shard = tmp_path / "step_5" / "arr_0.npy"
    raw = bytearray(shard.read_bytes())
    raw[-16:] = b"\xaa" * 16
    shard.write_bytes(bytes(raw))
    assert not Checkpointer(str(tmp_path)).verify_step(5)
    index, stats = _build(graphs[1], tmp_path, checkpoint_every=1,
                          resume=True)
    assert stats["resumed_at_chunk"] == 4
    _assert_index_equal(index, stats, *reference)


def test_resume_refuses_foreign_signature(graphs, tmp_path):
    with pytest.raises(InjectedFault):
        _build(graphs[1], tmp_path, checkpoint_every=1,
               fault_plan=FaultPlan(raise_at_chunks=(2,)))
    with pytest.raises(ValueError, match="signature mismatch"):
        build_index(graphs[1], R, L, rng.prng_key(KEY + 1), device="cpu",
                    checkpoint_dir=str(tmp_path), resume=True, **BUILD)
    other = tsyn.rmat(10, avg_deg=6.0, seed=8, device="cpu")
    with pytest.raises(ValueError, match="signature mismatch"):
        _build(other, tmp_path, resume=True)
    with pytest.raises(ValueError, match="signature mismatch"):
        _build(graphs[1], tmp_path, resume=True, source_batch=64)


def test_resume_of_complete_build_and_load(graphs, reference, tmp_path):
    ref_index, ref_stats = reference
    _build(graphs[1], tmp_path, checkpoint_every=4)
    index, stats = _build(graphs[1], tmp_path, resume=True)
    assert stats["resumed_complete"] is True
    _assert_index_equal(index, stats, ref_index, ref_stats)
    lindex, lstats = load_index_checkpoint(str(tmp_path), device="cpu")
    assert torch.equal(lindex.values, ref_index.values)
    assert torch.equal(lstats["touch"], ref_stats["touch"])
    assert lstats["touch_bits"] == BUILD["touch_bits"]
    with pytest.raises(FileNotFoundError):
        load_index_checkpoint(str(tmp_path / "empty"), device="cpu")


def test_subset_build_resumes_bitwise(graphs, tmp_path):
    sources = np.random.default_rng(2).choice(1024, 300, replace=False)
    kw = dict(sources=sources, source_batch=64)
    want, wstats = build_index(graphs[1], R, L, rng.prng_key(KEY),
                               device="cpu", **{**BUILD, **kw})
    with pytest.raises(InjectedFault):
        _build(graphs[1], tmp_path, checkpoint_every=2,
               fault_plan=FaultPlan(raise_at_chunks=(3,)), **kw)
    got, gstats = _build(graphs[1], tmp_path, checkpoint_every=2,
                         resume=True, **kw)
    assert gstats["resumed_at_chunk"] == 2
    _assert_index_equal(got, gstats, want, wstats)


def test_checkpointing_requires_sparse_engine(graphs, tmp_path):
    with pytest.raises(ValueError, match="sparse"):
        build_index(graphs[1], R, L, rng.prng_key(KEY), engine="legacy",
                    device="cpu", checkpoint_dir=str(tmp_path))


# -- across the two packages ----------------------------------------------------

def _reference_build(jg, ckpt_dir=None, **kw):
    kw = {**BUILD, **kw}
    if ckpt_dir is not None:
        kw["checkpoint_dir"] = str(ckpt_dir)
    return jindex.build_index(jg, R, L, jax.random.PRNGKey(KEY),
                              engine="sparse", **kw)


def test_reference_checkpoints_resume_and_load_in_the_port(graphs, tmp_path):
    jg, tg = graphs
    want, wstats = _reference_build(jg)
    with pytest.raises(JInjectedFault):
        _reference_build(jg, tmp_path, checkpoint_every=1,
                         fault_plan=JFaultPlan(raise_at_chunks=(3,)))
    index, stats = _build(tg, tmp_path, checkpoint_every=1, resume=True)
    assert stats["resumed_at_chunk"] == 3
    assert np.array_equal(index.values.numpy(), np.asarray(want.values))
    assert np.array_equal(index.indices.numpy(), np.asarray(want.indices))
    assert np.array_equal(stats["touch"].numpy(), np.asarray(wstats["touch"]))
    # a complete reference build boots in the port, key and grid included
    ref_dir = tmp_path / "complete"
    jupdates.build_maintainable_index(
        jg, R, L, jax.random.PRNGKey(KEY), checkpoint_dir=str(ref_dir),
        **BUILD)
    m, _ = load_maintainable_index(str(ref_dir), device="cpu")
    assert np.array_equal(m.index.values.numpy(), np.asarray(want.values))
    assert np.array_equal(m.touch.bits.numpy(), np.asarray(wstats["touch"]))
    assert np.array_equal(m.key.numpy(), [0, KEY])
    assert (m.params.source_batch, m.params.r, m.real_n) == (128, R, 1024)


def test_port_checkpoints_resume_and_load_in_the_reference(graphs, reference,
                                                           tmp_path):
    jg, tg = graphs
    ref_index, ref_stats = reference
    with pytest.raises(InjectedFault):
        _build(tg, tmp_path, checkpoint_every=1,
               fault_plan=FaultPlan(raise_at_chunks=(5,)))
    index, stats = _reference_build(jg, tmp_path, checkpoint_every=1,
                                    resume=True)
    assert stats["resumed_at_chunk"] == 5
    assert np.array_equal(np.asarray(index.values), ref_index.values.numpy())
    assert np.array_equal(np.asarray(stats["touch"]),
                          ref_stats["touch"].numpy())
    port_dir = tmp_path / "complete"
    build_maintainable_index(tg, R, L, rng.prng_key(KEY), device="cpu",
                             checkpoint_dir=str(port_dir), **BUILD)
    jm, jstats = jupdates.load_maintainable_index(str(port_dir))
    assert np.array_equal(np.asarray(jm.index.values),
                          ref_index.values.numpy())
    assert np.array_equal(np.asarray(jm.key), [0, KEY])
    assert jstats["kept_mass"] == ref_stats["kept_mass"]


# -- sharded builds ----------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(graphs):
    """1,024 vertices over 3 shards of 384 rows: 128 pad rows, 3 chunks a
    shard, on a 2 x 3 stacked mesh."""
    mesh = ShardMesh(data=2, model=3, device="cpu")
    kw = dict(mesh=mesh, c=0.25, max_steps=24, source_batch=128,
              touch_bits=64)
    return kw, build_index_sharded(graphs[1], R, L, rng.prng_key(KEY), **kw)


def test_sharded_checkpointed_matches_plain(graphs, sharded, tmp_path):
    kw, (ref_index, ref_stats) = sharded
    index, stats = build_index_sharded(
        graphs[1], R, L, rng.prng_key(KEY), checkpoint_dir=str(tmp_path),
        checkpoint_every=2, **kw)
    assert index.n == ref_index.n == 1152
    _assert_index_equal(index, stats, ref_index, ref_stats)
    assert stats["checkpoint_commits"] == 1


def test_sharded_resume_is_bitwise(graphs, sharded, tmp_path):
    kw, (ref_index, ref_stats) = sharded
    run = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    with pytest.raises(InjectedFault):
        build_index_sharded(graphs[1], R, L, rng.prng_key(KEY),
                            fault_plan=FaultPlan(raise_mid_commit=(2,)), **run)
    assert "step_2.tmp" in os.listdir(tmp_path)
    index, stats = build_index_sharded(
        graphs[1], R, L, rng.prng_key(KEY), resume=True, **run)
    assert stats["resumed_at_chunk"] == 1
    _assert_index_equal(index, stats, ref_index, ref_stats)
    again, astats = build_index_sharded(
        graphs[1], R, L, rng.prng_key(KEY), resume=True, **run)
    assert astats["resumed_complete"] is True
    assert torch.equal(again.values, ref_index.values)


def test_sharded_checkpoints_resume_across_packages(graphs):
    """A one-shard sharded build crashed in either package resumes in the
    other to the reference's uninterrupted sharded build (same signature:
    mesh shape, axes, chunk grid)."""
    jg, tg = graphs
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    kw = dict(c=0.25, max_steps=24, source_batch=128, touch_bits=64,
              checkpoint_every=4)

    def reference(**extra):
        return jindex.build_index_sharded(jg, R, L, jax.random.PRNGKey(KEY),
                                          mesh=jmesh, **kw, **extra)

    def port(**extra):
        return build_index_sharded(tg, R, L, rng.prng_key(KEY),
                                   mesh=ShardMesh(device="cpu"), **kw,
                                   **extra)

    want, wstats = jindex.build_index_sharded(
        jg, R, L, jax.random.PRNGKey(KEY), mesh=jmesh,
        **{k: v for k, v in kw.items() if k != "checkpoint_every"})
    for crash, resume, fault in ((reference, port, JFaultPlan),
                                 (port, reference, FaultPlan)):
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises((InjectedFault, JInjectedFault)):
                crash(checkpoint_dir=d,
                      fault_plan=fault(raise_at_chunks=(4,)))
            got, gstats = resume(checkpoint_dir=d, resume=True)
        assert gstats["resumed_at_chunk"] == 4
        assert np.array_equal(np.asarray(got.values), np.asarray(want.values))
        assert np.array_equal(np.asarray(got.indices),
                              np.asarray(want.indices))
        assert np.array_equal(np.asarray(gstats["touch"]),
                              np.asarray(wstats["touch"]))


# -- maintainable builds and the service -------------------------------------------

def test_maintainable_resume_and_repair_parity(graphs, tmp_path):
    tg = graphs[1]
    kw = dict(c=0.25, max_steps=24, source_batch=128, touch_bits=256)
    key = rng.prng_key(13)
    ref_m, _ = build_maintainable_index(tg, R, L, key, device="cpu", **kw)
    ins = np.array([[1000, 5], [1017, 2]])
    _, ref_m2, _ = apply_updates(ref_m, tg, inserts=ins)
    with pytest.raises(InjectedFault):
        build_maintainable_index(
            tg, R, L, key, device="cpu", checkpoint_dir=str(tmp_path),
            checkpoint_every=1, fault_plan=FaultPlan(raise_at_chunks=(3,)),
            **kw)
    m, stats = build_maintainable_index(
        tg, R, L, key, device="cpu", checkpoint_dir=str(tmp_path),
        checkpoint_every=1, resume=True, **kw)
    assert stats["resumed_at_chunk"] == 3
    assert torch.equal(m.touch.bits, ref_m.touch.bits)
    for mm in (m, load_maintainable_index(str(tmp_path), device="cpu")[0]):
        assert mm.params == ref_m.params
        assert torch.equal(mm.key, ref_m.key)
        _, mm2, _ = apply_updates(mm, tg, inserts=ins)
        assert torch.equal(mm2.index.values, ref_m2.index.values)
        assert torch.equal(mm2.index.indices, ref_m2.index.indices)
        assert torch.equal(mm2.touch.bits, ref_m2.touch.bits)


def test_load_maintainable_requires_touch(graphs, tmp_path):
    build_index(graphs[1], R, L, rng.prng_key(KEY), device="cpu",
                checkpoint_dir=str(tmp_path), c=0.25, max_steps=24,
                source_batch=128)
    with pytest.raises(ValueError, match="touch"):
        load_maintainable_index(str(tmp_path), device="cpu")


@pytest.mark.parametrize("maintainable", [False, True])
def test_service_boots_from_checkpoint(graphs, reference, tmp_path,
                                       maintainable):
    tg = graphs[1]
    ref_index, _ = reference
    if maintainable:
        build_maintainable_index(tg, R, L, rng.prng_key(KEY), device="cpu",
                                 checkpoint_dir=str(tmp_path), **BUILD)
    else:
        _build(tg, tmp_path, touch_bits=0)
    svc = PPRService.from_checkpoint(tg, str(tmp_path), device="cpu")
    direct = PPRService(tg, ref_index, device="cpu")
    assert (svc.maintainer is not None) == maintainable
    assert torch.equal(svc.engine.index.values, ref_index.values)
    got, _ = svc.run_closed_loop([3, 17, 500])
    want, _ = direct.run_closed_loop([3, 17, 500])
    for a, b in zip(sorted(got, key=lambda a: a.request_id),
                    sorted(want, key=lambda a: a.request_id)):
        assert a.top_scores.tobytes() == b.top_scores.tobytes()
        assert a.top_vertices.tobytes() == b.top_vertices.tobytes()
    if maintainable:
        report = svc.apply_updates(inserts=np.array([[0, 5]]))
        assert report["dirty_rows"] >= 1
        assert svc.stats["updates_applied"] == 1
        with pytest.raises(ValueError, match="vertices"):
            PPRService.from_checkpoint(tsyn.rmat(9, seed=7, device="cpu"),
                                       str(tmp_path), device="cpu")
    else:
        with pytest.raises(ValueError, match="maintainer"):
            svc.apply_updates(inserts=np.array([[0, 5]]))


# -- real preemption: SIGKILL ------------------------------------------------------

KILL_N = 48
KILL_BUILD = dict(c=0.25, max_steps=24, compact_every=4, touch_bits=16,
                  source_batch=8)   # 6 chunks on one device and on 1 shard


def _kill_graph():
    r = np.random.default_rng(1234)
    m = 6 * KILL_N
    return Graph.from_edges(r.integers(0, KILL_N, m),
                            r.integers(0, KILL_N, m), n=KILL_N, device="cpu")


def _kill_build(sharded, ckpt_dir, fault_plan=None, resume=False):
    kw = dict(checkpoint_dir=ckpt_dir, checkpoint_every=1, resume=resume,
              fault_plan=fault_plan, **KILL_BUILD)
    if sharded:
        return build_index_sharded(_kill_graph(), 2, 4, rng.prng_key(99),
                                   mesh=ShardMesh(device="cpu"), **kw)
    return build_index(_kill_graph(), 2, 4, rng.prng_key(99), device="cpu",
                       **kw)


def _digest(index, stats) -> str:
    h = hashlib.sha256()
    for x in (index.values, index.indices, stats["touch"]):
        h.update(x.numpy().tobytes())
    h.update(np.float64([stats["kept_mass"], stats["dropped_mass"]]).tobytes())
    return h.hexdigest()


def _victim(argv):
    mode, ckpt_dir, args = argv[0], argv[1], list(argv[2:])
    plan, resume = None, False
    while args:
        flag = args.pop(0)
        if flag == "--kill-chunk":
            plan = FaultPlan(kill_at_chunks=(int(args.pop(0)),))
        elif flag == "--kill-commit":
            plan = FaultPlan(kill_mid_commit=(int(args.pop(0)),))
        elif flag == "--resume":
            resume = True
        else:
            raise SystemExit(f"unknown flag {flag}")
    index, stats = _kill_build(mode == "build-sharded", ckpt_dir, plan,
                               resume)
    print(f"DIGEST {_digest(index, stats)}")
    print(f"RESUMED_AT {stats.get('resumed_at_chunk', 0)}")


def _spawn(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _kill_and_resume(mode):
    with tempfile.TemporaryDirectory() as d:
        want = _digest(*_kill_build(mode == "build-sharded", d))
    with tempfile.TemporaryDirectory() as d:
        res = _spawn([mode, d, "--kill-chunk", "3"])
        assert res.returncode == -signal.SIGKILL, res.stderr
        assert max(Checkpointer(d).all_steps()) == 3
        res = _spawn([mode, d, "--resume", "--kill-commit", "4"])
        assert res.returncode == -signal.SIGKILL, res.stderr
        names = os.listdir(d)
        assert "step_4.tmp" in names and "step_4" not in names
        with open(os.path.join(d, "step_3", "arr_0.npy"), "r+b") as f:
            f.seek(120)
            f.write(b"\xff" * 32)
        assert not Checkpointer(d).verify_step(3)
        res = _spawn([mode, d, "--resume"])
        assert res.returncode == 0, res.stderr
        lines = dict(ln.split(" ", 1) for ln in res.stdout.splitlines()
                     if " " in ln)
        assert lines["DIGEST"] == want, mode
        assert int(lines["RESUMED_AT"]) == 2, mode


def test_sigkill_crash_resume_suite():
    """For each engine (the two side by side): SIGKILL a build before
    chunk 3, SIGKILL its resume mid-commit of step 4 (a ``.tmp`` is left),
    bit-rot step 3, and resume to completion: the ``.tmp`` and the corrupt
    step are passed over and the index, filters and totals equal the
    uninterrupted build's."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for done in [pool.submit(_kill_and_resume, mode)
                     for mode in ("build", "build-sharded")]:
            done.result(timeout=900)


if __name__ == "__main__":
    _victim(sys.argv[1:])
