"""The PPR service, its checkpointed build and its repair one model shard
a process (``RankMesh``), against the stacked ``ShardMesh`` and the
reference, on the CPU.

One module fixture spawns four gloo ranks (``tests/torch_rank_serving_worker
.py``), which build an rmat(12) index one shard a rank, serve it through
``PPRService`` in every mode and on both routes (rank 0 leads, the others
follow), repair it, and build,
crash, resume and boot from checkpoints, each rank writing what it got.
The tests hold the answers, rows, filters, reports and checkpoint files
against the stacked mesh's and the one-device service's, bit for bit, and
the answers against the reference's ``PPRService`` on the reference's own
sharded index within its 1e-5 L1 bar.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_rank_serving_worker as worker
from conftest import densify_rows
from repro.core import index as jindex
from repro.core import query as jquery
from repro.graphs import synthetic as jsyn
from repro.serving import PPRService as JService
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving.batching import BatchingConfig as JBatching
from repro.serving.pipeline import PipelineConfig as JPipeline
from repro_torch.core.updates import apply_updates
from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.serving import PPRService
from repro_torch.testing import FaultPlan, InjectedFault

torch.set_num_threads(1)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        _bits(a), _bits(b))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("rank_serving")
    with pytest.raises(InjectedFault):      # the ranks resume this crash
        worker.stacked_checkpoint(
            out / "stacked_crash",
            fault_plan=FaultPlan(raise_at_chunks=(worker.CRASH_CHUNK,)))
    got, seconds = worker.run_ranks(out)
    return dict(ranks=got, seconds=seconds, out=out)


@pytest.fixture(scope="module")
def stacked():
    """The stacked 1 x 4 maintainable build the ranks' rows must equal."""
    return worker.stacked_maintainer()


def _block(x, r, ep=4):
    ns = x.shape[0] // ep
    return x[r % ep * ns:(r % ep + 1) * ns]


def _same_answers(got, want, prefix=""):
    for k in ("scores", "vertices", "cached", "rejected"):
        assert _equal(got[prefix + k], want[k]), k


# -- the served index -------------------------------------------------------

def test_rank_rows_are_the_stacked_rows_and_no_rank_holds_more(ranks,
                                                              stacked):
    m, _ = stacked
    for r, got in enumerate(ranks["ranks"]):
        assert int(got["build/row_offset"]) == r * 1024
        assert _equal(got["build/values"], _block(m.index.values.numpy(), r))
        assert _equal(got["build/indices"], _block(m.index.indices.numpy(), r))
        assert _equal(got["build/touch"], _block(m.touch.bits.numpy(), r))
        # while serving, each rank's index holds its own [n_shard, L] rows
        for key, v in got.items():
            if key.endswith(("shard_rows", "n_shard")):
                two = key.startswith(("serve12", "ckpt"))
                assert int(v) == (2048 if two else 1024), key


@pytest.mark.parametrize("label", sorted(worker.SERVICE_CASES))
def test_rank_service_matches_stacked_service(ranks, stacked, label):
    """Every mode and route, the same bytes as the one-device service on
    the assembled index.  The modes that read the index gather rows and
    run eagerly; the others send no command and capture as on one
    device."""
    m, _ = stacked
    svc = worker.stacked_service(m.index, label)
    want = worker.run_script(svc, worker.SERVICE_CASES[label][2])
    leader = ranks["ranks"][0]
    prefix = f"serve14/{label}/"
    _same_answers(leader, want, prefix)
    assert bool(leader[prefix + "index_sharded"])
    assert int(leader[prefix + "index_rows"]) == 4096
    stats = svc.snapshot_stats()
    assert not stats["index_sharded"]
    assert str(leader[prefix + "frontier_path"]) == stats["frontier_path"]
    for k in ("shed", "cache_served"):
        assert int(leader[prefix + k]) == stats[k], k
    if not worker.reads_index(label):
        assert int(leader[prefix + "graphs_captured"]) == \
            stats["graphs_captured"]
        assert int(leader[prefix + "exchange_rows"]) == 0
        for got in ranks["ranks"][1:]:
            assert int(got[prefix + "row_requests"]) == 0
        return
    assert int(leader[prefix + "graphs_captured"]) == 0
    # rows crossed: the 3 followers' touched rows, each batch's blocks
    # padded to its longest; the leader's own rows stay local
    row_bytes = worker.BUILD["l"] * 8
    crossed = int(leader[prefix + "exchange_rows_crossed"])
    assert 0 < crossed < int(leader[prefix + "exchange_rows"])
    assert crossed * row_bytes <= int(
        leader[prefix + "exchange_bytes"]) <= 3 * crossed * row_bytes
    for got in ranks["ranks"][1:]:
        assert int(got[prefix + "row_requests"]) > 0


@pytest.mark.parametrize("label", worker.PAIR_CASES)
def test_two_rank_service_matches_stacked_service(ranks, label):
    """A 1 x 2 mesh over ranks 0 and 1 of the four."""
    m, _ = worker.stacked_maintainer(shape=(1, 2))
    want = worker.run_script(worker.stacked_service(m.index, label),
                             worker.SERVICE_CASES[label][2])
    _same_answers(ranks["ranks"][0], want, f"serve12/{label}/")
    assert int(ranks["ranks"][1][f"serve12/{label}/shard_rows"]) == 2048


@pytest.fixture(scope="module")
def reference_index():
    """The reference's sharded build's rows (a 1 x 1 mesh: the same chunk
    grid, so the same rows), as plain arrays: under jax 0.9.0 the
    reference's service raises ``ShardingTypeError`` on arrays still
    sharded over ``model`` (its gather, as ROADMAP queue 3 lists for its
    sharded repair)."""
    jg = jsyn.rmat(worker.N_LOG2, avg_deg=8.0, seed=0)
    jidx, _ = jindex.build_index_sharded(
        jg, worker.BUILD["r"], worker.BUILD["l"], jax.random.PRNGKey(
            worker.KEY), mesh=jax.make_mesh((1, 1), ("data", "model")),
        source_batch=worker.BUILD["source_batch"], respawn=False)
    return jg, dataclasses.replace(
        jidx, values=jax.numpy.asarray(np.asarray(jidx.values)),
        indices=jax.numpy.asarray(np.asarray(jidx.indices)))


@pytest.mark.parametrize("label", ["scatter_d4", "sparse_d4_seeds",
                                   "dense_d4", "fppr_d2_seeds", "mcfp_d4"])
def test_rank_service_matches_reference_sharded_service(
        ranks, reference_index, label):
    """The reference's PPRService on the reference's sharded build's rows
    within 1e-5 L1, on a clock that stands still, so both services close
    the same batches (the ``mcfp`` mode's draws follow the dispatch
    order)."""
    query, depth, script = worker.SERVICE_CASES[label]
    jg, jidx = reference_index
    js = JService(jg, jidx, JServiceConfig(
        query=jquery.QueryConfig(**dict(worker.QKW, **query)),
        batching=JBatching(max_batch=8), pipeline=JPipeline(depth=depth)),
        clock=worker.still)
    answers, _ = js.run_closed_loop(worker.work(script == "seeds"))
    answers = sorted(answers, key=lambda a: a.request_id)
    want = densify_rows(np.stack([a.top_scores for a in answers]),
                        np.stack([a.top_vertices for a in answers]), jg.n)
    leader = ranks["ranks"][0]
    got = densify_rows(leader[f"serve14/{label}/scores"],
                       leader[f"serve14/{label}/vertices"], jg.n)
    assert float(np.abs(got - want).sum(axis=1).max()) <= 1e-5


# -- repair and updates -------------------------------------------------------

def _stacked_update(m, first):
    g = worker.graph()
    _, m1, report = apply_updates(m, g, **first)
    return m1, worker.report_arrays(report)


def test_rank_repair_matches_stacked_repair(ranks, stacked):
    m, _ = stacked
    first, _ = worker.edge_batches(worker.graph())
    m1, report = _stacked_update(m, first)
    # a selective repair: some chunks resampled, not all, and some shard
    # resamples part of its own interval and keeps the rest
    sb = worker.BUILD["source_batch"]
    assert 0 < report["repaired_chunks"] < report["total_chunks"]
    kept = np.ones(m.index.n, bool)
    for c in np.unique(report["dirty_row_ids"] // sb):
        kept[c * sb:(c + 1) * sb] = False
    assert any(0 < _block(kept, r).sum() < kept.size // 4 for r in range(4))
    for r, got in enumerate(ranks["ranks"]):
        for k, v in report.items():
            assert _equal(got[f"repair/report/{k}"], v), (r, k)
        assert _equal(got["repair/values"], _block(m1.index.values.numpy(),
                                                   r))
        assert _equal(got["repair/indices"], _block(
            m1.index.indices.numpy(), r))
        assert _equal(got["repair/touch"], _block(m1.touch.bits.numpy(), r))
        # its untouched chunks keep their bytes
        own = _block(kept, r)
        for k, x in (("values", m.index.values), ("indices",
                                                  m.index.indices)):
            assert _equal(got[f"repair/{k}"][own], _block(x.numpy(), r)[own])


def test_rank_service_updates_match_stacked_and_roll_back(ranks, stacked):
    """Serve, apply the first batch, serve; the second batch fails on rank
    2, so every rank keeps the first batch's rows; serve again."""
    m, _ = stacked
    first, _ = worker.edge_batches(worker.graph())
    svc = PPRService(worker.graph(), None, worker.service_config(
        *worker.UPDATE_CASE), clock=worker.still, device="cpu",
        maintainer=m)
    want = {"before": worker.run_script(svc, "cache")}
    report = worker.report_arrays(svc.apply_updates(**first))
    want["after"] = worker.run_script(svc, "cache")
    want["rolled_back"] = worker.run_script(svc, "cache")
    leader = ranks["ranks"][0]
    for name, arrays in want.items():
        _same_answers(leader, arrays, f"service_update/{name}/")
    for k, v in report.items():
        assert _equal(leader[f"service_update/report/{k}"], v), k
    assert str(leader["service_update/failed"]) == "yes"
    m1 = svc.maintainer
    for r, got in enumerate(ranks["ranks"]):
        assert int(got["service_update/rollbacks"]) == 1, r
        for k, x in (("values", m1.index.values), ("touch", m1.touch.bits)):
            assert _equal(got[f"service_update/final/{k}"],
                          _block(x.numpy(), r)), (r, k)


def test_rank_fppr_after_repair_reads_the_repaired_rows(ranks, stacked):
    """An fppr rank service with the maintainer, after the first update
    batch, answers the repaired rows as the one-device service does after
    the same repair, and not as before it."""
    m, _ = stacked
    first, _ = worker.edge_batches(worker.graph())
    cfg = worker.service_config(*worker.FPPR_UPDATE_CASE)
    svc = PPRService(worker.graph(), None, cfg, clock=worker.still,
                     device="cpu", maintainer=m)
    items = worker.repaired_requests(svc.apply_updates(**first))
    assert items
    want = worker.answers_arrays(svc.run_closed_loop(items)[0],
                                 svc.answer_k)
    _same_answers(ranks["ranks"][0], want, "fppr_update/")
    before = PPRService(worker.graph(), m.index, cfg, clock=worker.still,
                        device="cpu")
    old = worker.answers_arrays(before.run_closed_loop(items)[0],
                                before.answer_k)
    assert not _equal(old["scores"], want["scores"])


# -- checkpoints --------------------------------------------------------------

@pytest.fixture(scope="module")
def stacked_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("stacked_full")
    m, stats = worker.stacked_checkpoint(path)
    return path, m, stats


def _steps(path):
    return Checkpointer(str(path)).all_steps()


def test_rank_checkpoint_files_match_stacked(ranks, stacked_ckpt):
    """Every committed step: the same arrays, meta.json and extra.json."""
    path, _, _ = stacked_ckpt
    mine = ranks["out"] / "full"
    assert _steps(mine) == _steps(path) == [2, 4, 6, 8]
    for step in _steps(path):
        a, b = Checkpointer(str(mine)), Checkpointer(str(path))
        assert a.read_meta(step) == b.read_meta(step)
        extra = a.read_extra(step)
        assert extra == b.read_extra(step)
        assert extra["signature"]["mesh_shape"] == {"data": 2, "model": 2}
        ta, _ = a.restore(step)
        tb, _ = b.restore(step)
        assert ta.keys() == tb.keys()
        for k in ta:
            assert _equal(ta[k], tb[k]), (step, k)


def test_rank_checkpointed_build_and_resume_match_stacked(ranks,
                                                          stacked_ckpt):
    _, m, stats = stacked_ckpt
    for r, got in enumerate(ranks["ranks"]):
        m_r = r % 2
        for tag in ("full", "crash/resumed", "stacked_crash/resumed"):
            for k, x in (("values", m.index.values),
                         ("indices", m.index.indices),
                         ("touch", m.touch.bits)):
                assert _equal(got[f"ckpt/{tag}/{k}"],
                              _block(x.numpy(), m_r, 2)), (r, tag, k)
            for k in ("kept_mass", "dropped_mass"):
                assert float(got[f"ckpt/{tag}/{k}"]) == stats[k], (r, tag)
            assert int(got[f"ckpt/{tag}/row_offset"]) == m_r * 2048
        assert bool(got["ckpt/crash/raised"])
        assert bool(got["ckpt/rank_crash/raised"])
        for tag in ("crash", "stacked_crash"):
            assert int(got[f"ckpt/{tag}/resumed/resumed_at_chunk"]) == \
                worker.CRASH_CHUNK
        assert int(got["ckpt/full/checkpoint_commits"]) == 3
        # the writer raises the injected fault; its peers learn of it
        assert str(got["ckpt/mid_commit/raised"]) == (
            "injected" if r == 0 else "peer")
        assert _equal(got["ckpt/loaded/values"],
                      _block(m.index.values.numpy(), m_r, 2))
    names = os.listdir(ranks["out"] / "mid_commit")
    assert "step_2.tmp" in names and "step_2" not in names


def test_stacked_mesh_resumes_the_ranks_crash(ranks, stacked_ckpt):
    _, m, stats = stacked_ckpt
    got, gstats = worker.stacked_checkpoint(
        ranks["out"] / "rank_crash", resume=True)
    assert gstats["resumed_at_chunk"] == worker.CRASH_CHUNK
    assert torch.equal(got.index.values, m.index.values)
    assert torch.equal(got.touch.bits, m.touch.bits)
    assert gstats["kept_mass"] == stats["kept_mass"]


def test_reference_loads_the_rank_checkpoint(ranks, stacked_ckpt):
    _, m, _ = stacked_ckpt
    index, stats = jindex.load_index_checkpoint(str(ranks["out"] / "full"))
    assert np.array_equal(np.asarray(index.values), m.index.values.numpy())
    assert np.array_equal(np.asarray(index.indices), m.index.indices.numpy())
    assert np.array_equal(np.asarray(stats["touch"]), m.touch.bits.numpy())


def test_rank_service_boots_from_checkpoint_like_stacked(ranks,
                                                         stacked_ckpt):
    """A 1 x 4 rank service booted from the 2 x 2 ranks' complete step
    serves, repairs and serves as the one-device service booted from the
    stacked step."""
    path, _, _ = stacked_ckpt
    svc = PPRService.from_checkpoint(
        worker.graph(), str(path), worker.service_config(
            *worker.UPDATE_CASE), clock=worker.still, device="cpu")
    assert svc.maintainer is not None
    first, _ = worker.edge_batches(worker.graph())
    want = {"before": worker.run_script(svc, "cache")}
    svc.apply_updates(**first)
    want["after"] = worker.run_script(svc, "cache")
    for name, arrays in want.items():
        _same_answers(ranks["ranks"][0], arrays, f"boot/{name}/")
    for got in ranks["ranks"]:
        assert int(got["boot/shard_rows"]) == 1024


# -- refusals, the CLI and the budget ---------------------------------------

def test_rank_service_refusals(ranks):
    for r, got in enumerate(ranks["ranks"]):
        for name in ("data_mesh", "role"):
            assert bool(got[f"refusals/{name}"]), (r, name)


@pytest.mark.parametrize("case", sorted(worker.CLI_CASES))
def test_ranks_cli_serve_digest_matches_the_ranks(ranks, capsys, case):
    """``launch.ranks --stacked --serve``'s digest is the rank service's,
    with its default mode and route and with ``--mode fppr
    --frontier-path dense``."""
    from repro_torch.launch import ranks as ranks_cli

    c = worker.CLI
    query = worker.CLI_CASES[case]
    flags = [x for k, v in query.items()
             for x in (f"--{k.replace('_', '-')}", v)]
    assert ranks_cli.main([
        "--stacked", "--device", "cpu", "--model", "4", "--n-log2",
        str(c["n_log2"]), "--walks", str(c["r"]), "--index-l", str(c["l"]),
        "--source-batch", str(c["source_batch"]), "--requests",
        str(c["requests"]), "--q-tile", str(c["q_tile"]), "--serve",
        str(c["serve_n"])] + flags) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["service"] == "stacked" and rec["served"] == c["serve_n"]
    assert rec["service_digest"] == str(
        ranks["ranks"][0][f"cli/{case}/digest"])


def test_rank_serving_runs_inside_its_budget(ranks):
    assert ranks["seconds"] < 60.0
