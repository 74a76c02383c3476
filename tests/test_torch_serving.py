"""The port's PPRService against the reference's, on the CPU.

Answers must be byte-identical across pipeline depths (each query row is
computed independently of its batch mates) and within 1e-5 L1 of the
reference service on densified rows.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import densify_rows
from repro.core import index as jindex
from repro.core import query as jquery
from repro.graphs import synthetic as jsyn
from repro.serving import PPRService as JService
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving.batching import BatchingConfig as JBatching
from repro.serving.pipeline import PipelineConfig as JPipeline
from repro_torch import convert
from repro_torch.core import query as tquery
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving import CacheConfig, PPRService, ServiceConfig
from repro_torch.serving.batching import BatchingConfig
from repro_torch.serving.pipeline import (CompletionQueue, PendingBatch,
                                          PipelineConfig)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jg = jsyn.rmat(11, avg_deg=8.0, seed=2)
    tg = tsyn.rmat(11, avg_deg=8.0, seed=2, device="cpu")
    jidx, _ = jindex.build_index(jg, r=16, l=32, key=jax.random.PRNGKey(4),
                                 source_batch=1024)
    tidx = convert.index_from_arrays(jidx.values, jidx.indices, device="cpu")
    r = np.random.default_rng(0)
    work = []
    for j in range(24):
        if j % 3 == 2:
            s = r.integers(0, jg.n, 3).tolist()
            work.append(dict(seeds=s, weights=(r.random(3) + 0.1).tolist()))
        else:
            work.append(int(r.integers(0, jg.n)))
    return jg, tg, jidx, tidx, work


QKW = dict(t_iterations=2, top_k=16, hub_split_degree=16, max_seeds=3,
           frontier_path="sparse")


def _serve(svc, work):
    answers, stats = svc.run_closed_loop(work)
    assert len(answers) == len(work) and stats["served"] >= len(work)
    by_id = sorted(answers, key=lambda a: a.request_id)
    return (np.stack([a.top_scores for a in by_id]),
            np.stack([a.top_vertices for a in by_id]), stats)


def _port_service(setup, depth, **cfg):
    _, tg, _, tidx, _ = setup
    return PPRService(tg, tidx, ServiceConfig(
        query=tquery.QueryConfig(**QKW),
        batching=BatchingConfig(max_batch=8),
        pipeline=PipelineConfig(depth=depth), **cfg), device="cpu")


def test_service_depths_identical_and_match_reference(setup):
    jg, _, jidx, _, work = setup
    runs = [_serve(_port_service(setup, d), work) for d in (1, 4)]
    for a, b in zip(runs[0][:2], runs[1][:2]):
        assert a.tobytes() == b.tobytes()
    js = JService(jg, jidx, JServiceConfig(
        query=jquery.QueryConfig(**QKW), batching=JBatching(max_batch=8),
        pipeline=JPipeline(depth=4)))
    want = _serve(js, work)
    got = runs[1]
    dg = densify_rows(got[0], got[1], jg.n)
    dw = densify_rows(want[0], want[1], jg.n)
    assert float(np.abs(dg - dw).sum(axis=1).max()) <= 1e-5
    stats = got[2]
    assert stats["frontier_path"] == "sparse"
    assert stats["combine_path"] == want[2]["combine_path"]
    assert stats["pipeline_depth"] == 4 and stats["device"] == "cpu"


def test_launcher_default_hub_split_degree_is_the_reference_default():
    """``python -m repro_torch.launch.serve`` with no options serves with
    the reference ``QueryConfig``'s ``hub_split_degree``, so one command
    takes the same route in both packages; the flag still sets it."""
    from repro_torch.launch import serve as tserve

    parser = tserve.build_parser()
    assert (parser.parse_args([]).hub_split_degree
            == jquery.QueryConfig().hub_split_degree
            == tquery.QueryConfig().hub_split_degree)
    assert parser.parse_args(["--hub-split-degree", "64"]).hub_split_degree \
        == 64


def test_service_cache_and_invalidate(setup):
    _, _, _, _, work = setup
    svc = _port_service(setup, 2, cache=CacheConfig(capacity=64))
    first = _serve(svc, work)
    again = _serve(svc, work)
    assert again[2]["cache_served"] > 0
    assert first[0].tobytes() == again[0].tobytes()
    assert first[1].tobytes() == again[1].tobytes()
    v = work[0]
    assert svc.invalidate([v]) >= 1
    rid = svc.submit(v)
    out = svc.poll(force=True)
    assert [a.request_id for a in out] == [rid] and not out[0].cached
    assert svc.snapshot_stats()["cache_epoch"] >= 1


def test_service_sheds_under_admission_control(setup):
    _, tg, _, tidx, _ = setup
    svc = PPRService(tg, tidx, ServiceConfig(
        query=tquery.QueryConfig(**QKW),
        batching=BatchingConfig(max_batch=8, max_queue_depth=2,
                                max_wait_s=60.0)), device="cpu")
    ids = [svc.submit(v) for v in range(4)]
    out = {a.request_id: a for a in svc.poll(force=True)}
    assert sorted(out) == ids
    assert sum(a.rejected for a in out.values()) == 2
    assert svc.snapshot_stats()["shed"] == 2


def test_legacy_dispatch_and_rejected_options(setup):
    _, _, _, _, work = setup
    svc = _port_service(setup, 2)
    svc.cfg.pipeline.dispatch = "legacy"
    base = _serve(_port_service(setup, 2), work[:8])
    legacy = _serve(svc, work[:8])
    assert base[0].tobytes() == legacy[0].tobytes()
    # the result-buffer ring is the default, as in the reference, and
    # serves the same bytes as fresh buffers
    assert PipelineConfig().reuse_buffers
    ringed = _port_service(setup, 2)
    fresh = _port_service(setup, 2)
    fresh.cfg.pipeline.reuse_buffers = False
    a, b = _serve(ringed, work), _serve(fresh, work)
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()
    assert a[2]["pipeline_buffers_reused"] > 0
    assert b[2]["pipeline_buffers_reused"] == 0
    with pytest.raises(ValueError):
        PipelineConfig(depth=0)


def test_completion_queue_order_and_backpressure():
    q = CompletionQueue(2)
    t = [PendingBatch(i, [], 1, torch.zeros(1, 1), torch.zeros(1, 1), 0.0)
         for i in range(3)]
    q.push(t[0])
    q.push(t[1])
    assert q.full() and t[0].is_ready()
    with pytest.raises(RuntimeError):
        q.push(t[2])
    assert q.pop().seq == 0 and q.pop(block=True).seq == 1 and q.pop() is None


# -- the result-buffer ring (the reference's tests/test_serving.py) ---------

RING_QKW = dict(mode="powerwalk", t_iterations=2, top_k=32, frontier_k=128,
                frontier_path="sparse")


@pytest.fixture(scope="module")
def ring_setup():
    jg = jsyn.rmat(10, avg_deg=6.0, seed=1)
    tg = tsyn.rmat(10, avg_deg=6.0, seed=1, device="cpu")
    jidx, _ = jindex.build_index(jg, r=16, l=16, key=jax.random.PRNGKey(2),
                                 source_batch=512)
    tidx = convert.index_from_arrays(jidx.values, jidx.indices, device="cpu")
    return jg, tg, jidx, tidx


def _ring_services(ring_setup, depth, reuse=True):
    """The port's and the reference's service, single-width batches of 16."""
    jg, tg, jidx, tidx = ring_setup
    batching = dict(max_batch=16, min_pad=16)
    port = PPRService(tg, tidx, ServiceConfig(
        query=tquery.QueryConfig(**RING_QKW),
        batching=BatchingConfig(**batching),
        pipeline=PipelineConfig(depth=depth, reuse_buffers=reuse)),
        device="cpu")
    ref = JService(jg, jidx, JServiceConfig(
        query=jquery.QueryConfig(**RING_QKW), batching=JBatching(**batching),
        pipeline=JPipeline(depth=depth, reuse_buffers=reuse)))
    return port, ref


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_buffer_ring_allocations_plateau_like_the_reference(ring_setup,
                                                            depth):
    """A long run at one padded width allocates at most ``depth`` result
    pairs and reuses them for every other dispatch, in both packages (how
    many it takes depends on when batches complete: on the CPU the port's
    are complete at once)."""
    port, ref = _ring_services(ring_setup, depth)
    work = np.random.default_rng(11).integers(0, 1024, 16 * 12).tolist()
    _, s = port.run_closed_loop(work)
    _, want = ref.run_closed_loop(work)
    assert s["pipeline_dispatched"] == want["pipeline_dispatched"] >= 10
    for st in (s, want):
        assert st["served"] == 16 * 12 and set(st["batch_hist"]) == {16}
        assert 1 <= st["pipeline_buffers_allocated"] <= depth
        assert (st["pipeline_buffers_reused"] == st["pipeline_dispatched"]
                - st["pipeline_buffers_allocated"])


def test_buffer_ring_disabled_never_reuses(ring_setup):
    port, ref = _ring_services(ring_setup, 1, reuse=False)
    work = np.random.default_rng(12).integers(0, 1024, 48).tolist()
    _, s = port.run_closed_loop(work)
    _, want = ref.run_closed_loop(work)
    assert s["pipeline_buffers_reused"] == want["pipeline_buffers_reused"] == 0
    assert s["pipeline_buffers_allocated"] == 0


def test_query_into_given_buffers_same_memory_fresh_answers(ring_setup):
    """``out=`` writes the answer into the given tensors: the same memory,
    the fresh query's answer, not the donor's."""
    port, _ = _ring_services(ring_setup, 1)
    eng = port.engine
    verts = np.arange(8, dtype=np.int32)
    v0, i0 = eng.query_topk_async(verts)
    donor = v0.clone()
    ptrs = (v0.data_ptr(), i0.data_ptr())
    v1, i1 = eng.query_topk_async(verts + 1, out=(v0, i0))
    assert (v1.data_ptr(), i1.data_ptr()) == ptrs
    want_v, want_i = eng.query_topk_async(verts + 1)
    assert torch.equal(v1, want_v) and torch.equal(i1, want_i)
    assert not torch.equal(v1, donor)


def test_service_reset_stats_like_the_reference(ring_setup):
    """``reset_stats`` zeroes the service, pipeline, buffer and cache
    counters (keeping the cache's entries), the reference's keys alike."""
    port, ref = _ring_services(ring_setup, 2)
    work = np.random.default_rng(13).integers(0, 1024, 40).tolist()
    for svc in (port, ref):
        svc.run_closed_loop(work)
        assert svc.stats["served"] == 40
        svc.reset_stats()
    for got, want in ((port.stats, ref.stats),
                      (port.pipeline.stats, ref.pipeline.stats),
                      (port.buffer.stats, ref.buffer.stats),
                      (port.cache.stats, ref.cache.stats)):
        assert all(v == 0 for v in got.values())
        assert set(want) <= set(got) | {"sharded_index"}
    assert not port.pipeline.batch_hist
