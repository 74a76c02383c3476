"""The online PPR service: buffer -> shared decomposition -> top-k answers.

Clients submit query vertices (or weighted seed sets); the service
batches them (paper Section 3.3), runs the sparse VERD decomposition
against the PPR index on the device, and returns top-k (vertex, score)
lists with latency/throughput telemetry.  ``poll()`` dispatches ready
batches without syncing and harvests finished ones (``pipeline.py``);
``pipeline.depth=1`` is the blocking poll.  With a ``maintainer`` (a
``core.updates.MaintainableIndex``) the service applies edge updates
live, repairing the index and invalidating exactly the answers it
changed (:meth:`PPRService.apply_updates`); :meth:`PPRService
.from_checkpoint` boots from a checkpointed build.  The counterpart of
``repro.serving.engine``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.index import PPRIndex
from repro_torch.core.query import BatchQueryEngine, QueryConfig
from repro_torch.serving.batching import (BatchingConfig, BufferOverloadError,
                                          RequestBuffer)
from repro_torch.serving.cache import (AnswerCache, CacheConfig,
                                       canonicalize_seed_set)
from repro_torch.serving.pipeline import (CompletedBatch, PipelineConfig,
                                          ServingPipeline)

# a workload item is a vertex, a (vertex, tier) pair, or a seed-set dict
# {"seeds": [...], "weights": [...], "tier": "..."}
WorkItem = Union[int, Tuple[int, str], dict]


@dataclasses.dataclass
class ServiceConfig:
    query: QueryConfig = dataclasses.field(default_factory=QueryConfig)
    batching: BatchingConfig = dataclasses.field(default_factory=BatchingConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)


@dataclasses.dataclass
class Answer:
    request_id: int
    vertex: int
    top_vertices: np.ndarray
    top_scores: np.ndarray
    latency_s: float
    tier: str = "interactive"
    cached: bool = False          # served from the answer cache
    rejected: bool = False        # shed by admission control (empty top-k)


class PPRService:
    """Serves PPR answers against a :class:`PPRIndex` on ``device``.

    ``maintainer`` (a ``core.updates.MaintainableIndex``) enables
    :meth:`apply_updates`; with ``index=None`` its index serves.
    """

    def __init__(self, graph: Graph, index: Optional[PPRIndex],
                 cfg: Optional[ServiceConfig] = None, clock=None,
                 device="cuda", maintainer=None):
        self.cfg = cfg or ServiceConfig()
        self.maintainer = maintainer
        if index is None and maintainer is not None:
            index = maintainer.index
        self.engine = BatchQueryEngine(graph, index, self.cfg.query,
                                       device=device)
        self.graph = self.engine.graph
        self.buffer = RequestBuffer(self.cfg.batching, clock=clock)
        self.clock = clock or time.monotonic
        self.cache = AnswerCache(self.cfg.cache)
        self.pipeline = ServingPipeline(
            self.engine, self.buffer, self.cfg.pipeline, clock=self.clock,
            epoch_fn=lambda: self.cache.epoch,
        )
        self.frontier_path = (
            "sparse" if self.engine.uses_sparse_path() else "dense")
        self.answer_k = self.engine.effective_top_k
        self.index_rows = index.n if index is not None else 0
        self.stats: Dict[str, float] = dict(
            served=0, batches=0, total_latency=0.0, max_latency=0.0,
            pad_rows=0, first_batch_service_s=0.0, cache_served=0,
            cache_stale_drops=0, shed=0, updates_applied=0, rows_repaired=0,
            update_rollbacks=0,
        )
        self._pending_cached: List[Tuple[int, int, str, float, Tuple]] = []
        self._inflight_keys: Dict[int, Tuple] = {}
        self._pending_rejected: List[Tuple[int, int, str, float]] = []

    @classmethod
    def from_checkpoint(cls, graph: Graph, checkpoint_dir: str,
                        cfg: Optional[ServiceConfig] = None, clock=None,
                        device="cuda") -> "PPRService":
        """Boot from the *complete* committed step of a checkpointed build
        (partial steps, ``.tmp`` dirs and corrupt steps never boot), with
        no walk simulated.  A maintainable build (filters in the
        checkpoint) boots with its ``maintainer``, so :meth:`apply_updates`
        works across the restart; a plain one serves read-only."""
        from repro_torch.core import index as index_mod
        from repro_torch.core import updates as updates_mod

        tree, extra = index_mod._restore_complete(checkpoint_dir)
        if "touch" not in tree:
            index, _ = index_mod._index_from_tree(tree, extra, device)
            return cls(graph, index, cfg, clock=clock, device=device)
        m, _ = updates_mod._maintainable_from_tree(
            tree, extra, device, checkpoint_dir)
        if m.real_n != graph.n:
            raise ValueError(
                f"checkpoint was built on {m.real_n} vertices but the "
                f"graph has {graph.n}")
        return cls(graph, None, cfg, clock=clock, device=device,
                   maintainer=m)

    # -- client API ----------------------------------------------------------
    def submit(self, vertex: Optional[int] = None, tier: str = "interactive",
               arrival: Optional[float] = None,
               seeds: Optional[Sequence[int]] = None,
               weights: Optional[Sequence[float]] = None) -> int:
        """Enqueue a query (a ``vertex`` or a weighted seed set); cache hits
        and shed requests are answered by the next ``poll()``."""
        if seeds is not None:
            s_arr = np.asarray(seeds, dtype=np.int64).reshape(-1)
            if s_arr.size > self.cfg.query.max_seeds:
                raise ValueError(
                    f"seed set of {s_arr.size} exceeds "
                    f"query.max_seeds={self.cfg.query.max_seeds}")
        if self.cache.enabled:
            key = canonicalize_seed_set(
                [vertex] if seeds is None else seeds,
                None if seeds is None else weights,
                weight_quantum=self.cfg.cache.weight_quantum,
            )
            if key[0]:
                primary = (int(vertex) if seeds is None
                           else int(np.asarray(seeds).reshape(-1)[0]))
                hit = self.cache.get(key)
                if hit is not None:
                    rid = self.buffer.allocate_id()
                    t = self.clock() if arrival is None else arrival
                    self._pending_cached.append((rid, primary, tier, t, hit))
                    return rid
                # dispatch the canonical spelling so every spelling of the
                # key computes byte-identical answers
                quantum = self.cfg.cache.weight_quantum
                try:
                    rid = self.buffer.submit(
                        primary, tier=tier, arrival=arrival,
                        seeds=list(key[0]),
                        weights=[q * quantum for q in key[1]],
                    )
                except BufferOverloadError:
                    return self._reject(primary, tier, arrival)
                self._inflight_keys[rid] = key
                return rid
        try:
            return self.buffer.submit(vertex, tier=tier, arrival=arrival,
                                      seeds=seeds, weights=weights)
        except BufferOverloadError:
            primary = (int(vertex) if seeds is None
                       else int(np.asarray(seeds).reshape(-1)[0]))
            return self._reject(primary, tier, arrival)

    def _reject(self, vertex: int, tier: str, arrival: Optional[float]) -> int:
        rid = self.buffer.allocate_id()
        t = self.clock() if arrival is None else arrival
        self._pending_rejected.append((rid, int(vertex), tier, t))
        self.stats["shed"] += 1
        return rid

    def invalidate(self, vertices: Iterable[int]) -> int:
        """Drop cached answers whose seed sets touch ``vertices`` and bump
        the cache epoch (in-flight batches are then not cached)."""
        return self.cache.invalidate(vertices)

    def apply_updates(self, inserts=None, deletes=None) -> dict:
        """Apply an edge-update batch to the live graph and index.

        Needs a ``maintainer``.  Repairs the index
        (``core.updates.apply_updates``), swaps the engine onto the new
        graph and index, then invalidates exactly the repaired rows'
        answers in the cache, which also bumps its epoch so a batch still
        in flight on the old index is not cached.  Returns the repair
        report with ``cache_invalidated``.

        The swap is atomic: the repaired index and the new engine are
        built before any attribute changes, so a failure in either leaves
        the service serving the old graph and index
        (``stats["update_rollbacks"]`` counts these).
        """
        if self.maintainer is None:
            raise ValueError(
                "apply_updates requires a maintainer (build the index with "
                "core.updates.build_maintainable_index and pass it to "
                "PPRService(..., maintainer=...))")
        from repro_torch.core import updates as updates_mod

        try:
            new_graph, new_m, report = updates_mod.apply_updates(
                self.maintainer, self.graph, inserts=inserts,
                deletes=deletes)
            new_engine = BatchQueryEngine(new_graph, new_m.index,
                                          self.cfg.query,
                                          device=self.engine.device)
            frontier_path = (
                "sparse" if new_engine.uses_sparse_path() else "dense")
            answer_k = new_engine.effective_top_k
        except BaseException:
            self.stats["update_rollbacks"] += 1
            raise
        # the commit point: attribute assignments only, none can raise
        self.graph = new_engine.graph
        self.maintainer = new_m
        self.engine = new_engine
        self.pipeline.engine = new_engine
        self.frontier_path = frontier_path
        self.answer_k = answer_k
        self.index_rows = new_m.index.n
        # an answer is stale iff a seed's row was repaired; the call runs
        # for an empty set too, for its epoch bump
        report["cache_invalidated"] = self.cache.invalidate(
            report["dirty_row_ids"])
        self.stats["updates_applied"] += 1
        self.stats["rows_repaired"] += report["dirty_rows"]
        return report

    @property
    def in_flight(self) -> int:
        return self.pipeline.in_flight

    def poll(self, force: bool = False) -> List[Answer]:
        """Dispatch every ready batch (``force``: the whole buffer) and
        harvest finished ones; blocking at depth 1 or with ``force``."""
        cached = self._drain_cached() + self._drain_rejected()
        if (not len(self.buffer) or not (self.buffer.ready() or force)) \
                and not self.pipeline.in_flight:
            return cached
        drain = force or self.cfg.pipeline.depth <= 1
        completed = self.pipeline.dispatch(force=force)
        completed.extend(self.pipeline.harvest(drain=drain))
        more = self.pipeline.dispatch(force=force)
        if more or (drain and self.pipeline.in_flight):
            completed.extend(more)
            completed.extend(self.pipeline.harvest(drain=drain))
        return cached + self._absorb(completed)

    # -- bookkeeping ---------------------------------------------------------
    def _drain_cached(self) -> List[Answer]:
        if not self._pending_cached:
            return []
        out: List[Answer] = []
        now = self.clock()
        for rid, vertex, tier, arrival, (tv, ts) in self._pending_cached:
            lat = now - arrival
            out.append(Answer(rid, vertex, tv, ts, lat, tier, cached=True))
            self.stats["served"] += 1
            self.stats["cache_served"] += 1
            self.stats["total_latency"] += lat
            self.stats["max_latency"] = max(self.stats["max_latency"], lat)
        self._pending_cached.clear()
        return out

    def _drain_rejected(self) -> List[Answer]:
        if not self._pending_rejected:
            return []
        now = self.clock()
        out = [
            Answer(rid, vertex, np.zeros(0, np.int64), np.zeros(0, np.float32),
                   now - arrival, tier, rejected=True)
            for rid, vertex, tier, arrival in self._pending_rejected
        ]
        self._pending_rejected.clear()
        return out

    def _absorb(self, completed: List[CompletedBatch]) -> List[Answer]:
        out: List[Answer] = []
        for batch in completed:
            if not self.stats["batches"]:
                self.stats["first_batch_service_s"] = (
                    batch.completed_at - batch.dispatched_at)
            self.stats["pad_rows"] += batch.padded - len(batch.requests)
            self.stats["batches"] += 1
            for i, r in enumerate(batch.requests):
                lat = batch.completed_at - r.arrival
                out.append(Answer(r.request_id, r.vertex, batch.indices[i],
                                  batch.values[i], lat, r.tier))
                key = self._inflight_keys.pop(r.request_id, None)
                if key is not None:
                    # a batch dispatched before an invalidate carries an
                    # older epoch: returned, but never cached
                    if batch.epoch == self.cache.epoch:
                        self.cache.put(key, batch.indices[i], batch.values[i])
                    else:
                        self.stats["cache_stale_drops"] += 1
                self.stats["served"] += 1
                self.stats["total_latency"] += lat
                self.stats["max_latency"] = max(self.stats["max_latency"], lat)
        return out

    def snapshot_stats(self) -> dict:
        """Service + pipeline telemetry as one flat dict (JSON-safe)."""
        s = dict(self.stats)
        s["frontier_path"] = self.frontier_path
        s["answer_k"] = self.answer_k
        s["index_rows"] = self.index_rows
        s["device"] = str(self.engine.device)
        s["pipeline_depth"] = self.cfg.pipeline.depth
        s["dispatch_path"] = self.cfg.pipeline.dispatch
        s["max_queue_depth"] = self.cfg.batching.max_queue_depth
        s["buffer_shed"] = self.buffer.stats["shed"]
        s["combine_path"] = (
            "scatter" if self.engine.uses_scatter_combine(
                self.cfg.batching.max_batch) else "sparse"
        ) if self.frontier_path == "sparse" else "dense"
        s.update({f"pipeline_{k}": v for k, v in self.pipeline.stats.items()})
        s["batch_hist"] = {
            int(k): int(v) for k, v in sorted(self.pipeline.batch_hist.items())
        }
        s["mean_latency"] = s["total_latency"] / max(s["served"], 1)
        computed = s["served"] - s["cache_served"]
        s["pad_fraction"] = s["pad_rows"] / max(computed + s["pad_rows"], 1)
        s.update({f"cache_{k}": v for k, v in self.cache.stats.items()})
        s["cache_size"] = len(self.cache)
        s["cache_hit_rate"] = self.cache.stats["hits"] / max(
            self.cache.stats["hits"] + self.cache.stats["misses"], 1)
        s["cache_epoch"] = self.cache.epoch
        self.cache.check_integrity()
        return s

    def run_closed_loop(
        self, vertices: Sequence[WorkItem]
    ) -> Tuple[List[Answer], dict]:
        """Serve a fixed workload to completion, offering requests as fast
        as the loop runs; returns ``(answers, stats)`` with wall time, qps
        and latency percentiles."""
        answers: List[Answer] = []
        t0 = self.clock()
        for item in vertices:
            if isinstance(item, dict):
                self.submit(tier=item.get("tier", "interactive"),
                            seeds=item["seeds"], weights=item.get("weights"))
            else:
                v, tier = item if isinstance(item, tuple) else (
                    item, "interactive")
                self.submit(v, tier=tier)
            answers.extend(self.poll())
        answers.extend(self.poll(force=True))
        wall = self.clock() - t0
        s = self.snapshot_stats()
        lat = np.asarray([a.latency_s for a in answers], np.float64)
        s["wall_s"] = wall
        s["qps"] = len(answers) / max(wall, 1e-9)
        s["latency_p50"] = float(np.percentile(lat, 50)) if lat.size else 0.0
        s["latency_p99"] = float(np.percentile(lat, 99)) if lat.size else 0.0
        return answers, s
