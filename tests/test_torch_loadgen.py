"""The port's load generation and benchmark helpers against the reference's.

``zipf_seed_workload`` must give the reference's items one for one, and
``run_open_loop`` the reference's submit schedule and latencies under the
same fake clock and sleep (a recording stub service, so both loops see the
same service); ``degree_histogram``, ``bucket_sample_sources`` and the
synthetic graphs must equal the reference's, CSR arrays bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import index as jindex
from repro.core import query as jquery
from repro.graphs import synthetic as jsyn
from repro.serving import loadgen as jloadgen
from repro_torch import convert
from repro_torch.core import graph as tgraph
from repro_torch.core import query as tquery
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving import (CacheConfig, PPRService, ServiceConfig,
                                 run_closed_loop, run_open_loop,
                                 zipf_seed_workload)
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving.batching import BatchingConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(skew=1.4, max_seeds=3, pool=64, seed=5),
    dict(max_seeds=4, pool=16, singles_fraction=0.3, tier="bulk", seed=2),
])
def test_zipf_seed_workload_equals_the_reference(kw):
    got = zipf_seed_workload(4096, 500, **kw)
    want = jloadgen.zipf_seed_workload(4096, 500, **kw)
    assert got == want


@dataclasses.dataclass
class _Answer:
    latency_s: float


class _StubService:
    """A service that answers every pending request at each ``poll``,
    on a fake clock that advances ``tick`` a read; records each submit."""

    def __init__(self, tick=1e-4, batch_cost=5e-3):
        self.now = 0.0
        self.tick = tick
        self.batch_cost = batch_cost
        self.submits = []
        self.pending = []

    def clock(self):
        self.now += self.tick
        return self.now

    def sleep(self, s):
        self.now += s

    def submit(self, vertex=None, tier="interactive", arrival=None,
               seeds=None, weights=None):
        t = self.clock() if arrival is None else arrival
        self.submits.append((vertex, tier, t, seeds, weights))
        self.pending.append(t)

    def poll(self, force=False):
        if not self.pending or (len(self.pending) < 4 and not force):
            return []
        self.now += self.batch_cost
        out = [_Answer(self.now - t) for t in self.pending]
        self.pending = []
        return out

    def snapshot_stats(self):
        return dict(first_batch_service_s=self.batch_cost)


@pytest.mark.parametrize("qps", [None, 500.0, 20000.0])
def test_run_open_loop_schedule_and_latencies_equal_the_reference(qps):
    work = [1, (2, "bulk"), dict(seeds=[3, 4], weights=[1.0, 2.0])] * 40
    runs = []
    for mod in (tloadgen, jloadgen):
        svc = _StubService()
        answers, stats = mod.run_open_loop(svc, work, qps, sleep=svc.sleep)
        runs.append((svc.submits, [a.latency_s for a in answers], stats))
    (sub_t, lat_t, st_t), (sub_j, lat_j, st_j) = runs
    assert sub_t == sub_j and lat_t == lat_j and st_t == st_j
    assert len(lat_t) == len(work)
    assert st_t["offered_qps"] == (qps or 0.0)
    assert st_t["qps_excl_first_batch"] >= st_t["qps"]


@pytest.fixture(scope="module")
def service_setup():
    jg = jsyn.rmat(11, avg_deg=8.0, seed=3)
    tg = tsyn.rmat(11, avg_deg=8.0, seed=3, device="cpu")
    jidx, _ = jindex.build_index(jg, r=16, l=32, key=jax.random.PRNGKey(1),
                                 source_batch=1024)
    tidx = convert.index_from_arrays(jidx.values, jidx.indices, device="cpu")
    return tg, tidx


def _zipf_service(tg, tidx, clock):
    return PPRService(tg, tidx, ServiceConfig(
        query=tquery.QueryConfig(t_iterations=2, top_k=16, max_seeds=4,
                                 hub_split_degree=16,
                                 frontier_path="sparse"),
        batching=BatchingConfig(max_batch=16),
        cache=CacheConfig(capacity=256)), clock=clock, device="cpu")


def _virtual_open_loop(tg, tidx, work, qps):
    """``run_open_loop`` on a virtual clock that only its injected
    ``sleep`` advances, as the reference's own open-loop tests drive it:
    batches form the same way on every run, however loaded the host."""
    t = [0.0]

    def sleep(dt):
        t[0] += dt

    return run_open_loop(_zipf_service(tg, tidx, lambda: t[0]), work, qps,
                         sleep=sleep)


def _answer_bytes(answers):
    by_id = sorted(answers, key=lambda a: a.request_id)
    return b"".join(a.top_scores.tobytes() + a.top_vertices.tobytes()
                    for a in by_id)


def test_open_and_closed_loop_serve_a_zipf_seed_stream(service_setup):
    """``bench_cache.py``'s stream (seed sets of up to 4, an answer cache)
    through the port's service: every request answered, repeats served
    from the cache, and every loop the same bytes.  Each loop runs on a
    virtual clock (the closed loops never sleep, so theirs stands still),
    so how requests batch, and so how many repeats find their answer
    cached, does not depend on the host's load."""
    tg, tidx = service_setup
    work = zipf_seed_workload(tg.n, 96, max_seeds=4, pool=24, seed=1)

    def still():
        return _zipf_service(tg, tidx, lambda: 0.0)

    runs = []
    for drive in (lambda: _virtual_open_loop(tg, tidx, work, 1e5),
                  lambda: run_closed_loop(still(), work),
                  lambda: still().run_closed_loop(work)):
        answers, stats = drive()
        assert len(answers) == len(work) == stats["served"]
        # how many repeats find their answer cached depends on when
        # batches complete, which the open loop's clock decides
        assert stats["cache_served"] > 0
        for k in ("latency_p50", "latency_p99", "qps", "offered_qps",
                  "qps_excl_first_batch", "wall_s"):
            assert np.isfinite(stats[k])
        runs.append(_answer_bytes(answers))
    assert runs[0] == runs[1] == runs[2]


def test_answers_do_not_depend_on_how_requests_batch(service_setup):
    """The same stream offered at three rates on the virtual clock splits
    into other batches (and other cache hits), and every request gets the
    same bytes: an answer depends on its seed set alone, not on the
    padded width or the batch it rode in.  The reference behaves the
    same way on these batchings."""
    tg, tidx = service_setup
    work = zipf_seed_workload(tg.n, 96, max_seeds=4, pool=24, seed=1)
    runs = [_virtual_open_loop(tg, tidx, work, qps)
            for qps in (1e5, 1e3, 50.0)]
    assert len({st["batches"] for _, st in runs}) == 3
    assert len({_answer_bytes(a) for a, _ in runs}) == 1


@pytest.mark.parametrize("make", [
    lambda m: m.figure2_graph() if m is jsyn else m.figure2_graph("cpu"),
    lambda m: m.complete(7) if m is jsyn else m.complete(7, device="cpu"),
    lambda m: (m.bipartite_recsys(300, 50, avg_deg=4.0, seed=3) if m is jsyn
               else m.bipartite_recsys(300, 50, avg_deg=4.0, seed=3,
                                       device="cpu")),
])
def test_synthetic_graphs_equal_the_reference(make):
    want, got = make(jsyn), make(tsyn)
    assert (got.n, got.m) == (want.n, want.m)
    for name in ("row_ptr", "col_idx", "src", "out_deg"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name


@pytest.mark.parametrize("n_buckets,per_bucket,seed", [(10, 8, 0),
                                                       (6, 3, 4)])
def test_degree_buckets_equal_the_reference(n_buckets, per_bucket, seed):
    jg = jsyn.rmat(12, avg_deg=8.0, seed=7)
    tg = tsyn.rmat(12, avg_deg=8.0, seed=7, device="cpu")
    assert np.array_equal(tgraph.degree_histogram(tg, n_buckets),
                          jgraph.degree_histogram(jg, n_buckets))
    got = tgraph.bucket_sample_sources(tg, per_bucket, n_buckets, seed)
    want = jgraph.bucket_sample_sources(jg, per_bucket, n_buckets, seed)
    assert got.size and np.array_equal(got, want)


def test_query_config_key_needs_only_the_mcfp_mode():
    tg = tsyn.figure2_graph("cpu")
    assert tquery.BatchQueryEngine(tg, None, tquery.QueryConfig(
        mode="mcfp", r_online=8), device="cpu").uses_key
    assert not tquery.BatchQueryEngine(tg, None, tquery.QueryConfig(
        mode="verd"), device="cpu").uses_key
    assert jquery.QueryConfig().mode == tquery.QueryConfig().mode
