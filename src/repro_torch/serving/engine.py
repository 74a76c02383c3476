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

Over a ``RankMesh`` of ``1 x ep`` ranks the index is sharded by rows (a
``core.index.RankIndex``), as the reference serves ``build_index_sharded``'s
output: model shard 0, the *leader*, runs the whole service (buffer,
cache, pipeline, the VERD push on its replica of the graph) and gathers
each batch's touched rows from the shards that own them; every other rank
runs :func:`serve_follower`, which answers the leader's broadcast
commands in order (rows, an update batch, stop) until the leader's
:meth:`PPRService.close`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Graph, _edge_pairs
from repro_torch.core.index import (CMD_ROWS, CMD_STOP, CMD_UPDATE,
                                    PPRIndex, RankIndex)
from repro_torch.core.query import BatchQueryEngine, QueryConfig
from repro_torch.distributed.mesh import fail_together
from repro_torch.serving.batching import (BatchingConfig, BufferOverloadError,
                                          RequestBuffer)
from repro_torch.serving.cache import (AnswerCache, CacheConfig,
                                       canonicalize_seed_set)
from repro_torch.serving.loadgen import WorkItem
from repro_torch.serving.pipeline import (CompletedBatch, PipelineConfig,
                                          ServingPipeline)


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


# what a rank service does not run yet
RANK_SERVICE_NEXT = ("a rank service runs on a 1 x ep mesh; the service "
                     "replicated over data rows is ROADMAP.md queue 1")


def _on_service_mesh(index, maintainer, mesh):
    """A rank service's index (the maintainer's, if ``None``) and
    maintainer, bound to ``mesh`` (default: the index's own), which must
    be ``1 x ep``."""
    if index is None and maintainer is not None:
        index = maintainer.index
    if not isinstance(index, RankIndex):
        raise ValueError("a service over a RankMesh serves a RankIndex "
                         "(build_index_sharded on the mesh, or "
                         "PPRService.from_checkpoint(..., mesh=))")
    mesh = mesh or index.mesh
    if mesh.data != 1:
        raise ValueError(f"a {mesh.data} x {mesh.model} service mesh: "
                         f"{RANK_SERVICE_NEXT}")
    index = index.on(mesh)
    if maintainer is not None:
        maintainer = dataclasses.replace(maintainer, index=index)
    return index, maintainer, mesh


class PPRService:
    """Serves PPR answers against a :class:`PPRIndex` on ``device``.

    ``maintainer`` (a ``core.updates.MaintainableIndex``) enables
    :meth:`apply_updates`; with ``index=None`` its index serves.  A
    ``RankIndex`` (or ``mesh``, a ``1 x ep`` ``RankMesh``) makes this the
    rank service's leader, on model shard 0 of the mesh: the other ranks
    run :func:`serve_follower` until :meth:`close`.
    """

    def __init__(self, graph: Graph, index: Optional[PPRIndex],
                 cfg: Optional[ServiceConfig] = None, clock=None,
                 device="cuda", maintainer=None, mesh=None):
        self.cfg = cfg or ServiceConfig()
        self.mesh = None
        if index is None and maintainer is not None:
            index = maintainer.index
        if mesh is not None or isinstance(index, RankIndex):
            index, maintainer, self.mesh = _on_service_mesh(
                index, maintainer, mesh)
        self.maintainer = maintainer
        self.engine = BatchQueryEngine(graph, index, self.cfg.query,
                                       device=device)
        if self.mesh is not None and not index.is_leader:
            raise ValueError("PPRService runs on the mesh's model shard 0; "
                             "the other ranks run serve_follower")
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
        self.index_sharded = isinstance(index, RankIndex)
        self._closed = False
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
                        device="cuda", mesh=None) -> "PPRService":
        """Boot from the *complete* committed step of a checkpointed build
        (partial steps, ``.tmp`` dirs and corrupt steps never boot), with
        no walk simulated.  A maintainable build (filters in the
        checkpoint) boots with its ``maintainer``, so :meth:`apply_updates`
        works across the restart; a plain one serves read-only.  With a
        ``RankMesh`` every rank boots its own block: this leader here, the
        followers in ``serve_follower(..., checkpoint_dir=)``."""
        index, m = boot_checkpoint(graph, checkpoint_dir, device, mesh)
        return cls(graph, index if m is None else None, cfg, clock=clock,
                   device=device, maintainer=m, mesh=mesh)

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
        (``core.updates.apply_updates``), builds an engine on the new
        graph and index with the old engine's CUDA graphs captured anew
        (``capture_s``, ``graphs_captured`` in the report), swaps it in,
        then invalidates exactly the repaired rows' answers in the cache,
        which also bumps its epoch so a batch still in flight on the old
        index is not cached.  Batches in flight hold the old engine, its
        graphs and their pool until they are harvested.  Returns the
        repair report with ``cache_invalidated``.

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

        if self.mesh is not None:
            return self._apply_updates_on_ranks(inserts, deletes)
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
            # the old engine's graphs captured anew over the new graph and
            # index, before the commit point: a failed capture rolls back
            t0 = time.perf_counter()
            new_engine.capture_shapes(list(self.engine.graphs))
            report["capture_s"] = time.perf_counter() - t0
            report["graphs_captured"] = len(new_engine.graphs)
        except BaseException:
            self.stats["update_rollbacks"] += 1
            raise
        return self._commit_update(new_engine, new_m, frontier_path,
                                   answer_k, report)

    def _commit_update(self, new_engine, new_m, frontier_path, answer_k,
                       report) -> dict:
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

    def _apply_updates_on_ranks(self, inserts, deletes) -> dict:
        """:meth:`apply_updates` on the leader: the batch goes to every
        rank, each repairs its own rows (``core.updates.apply_updates``,
        which fails on every rank if it fails on one), and the leader's
        verdict on its new engine commits or rolls back every rank."""
        from repro_torch.core import updates as updates_mod

        self._command(CMD_UPDATE, encode_edges(inserts, deletes))
        try:
            new_graph, new_m, report = updates_mod.apply_updates(
                self.maintainer, self.graph, inserts=inserts,
                deletes=deletes)
        except BaseException:
            self.stats["update_rollbacks"] += 1
            raise
        try:
            new_engine = BatchQueryEngine(new_graph, new_m.index,
                                          self.cfg.query,
                                          device=self.engine.device)
            report["capture_s"] = 0.0
            report["graphs_captured"] = len(new_engine.graphs)
            commit = True
        except BaseException:
            commit = False
            raise
        finally:
            self.mesh.broadcast(torch.tensor(
                [int(commit)], dtype=torch.int64, device=self.mesh.device),
                src=0, axes="model")
            if not commit:
                self.stats["update_rollbacks"] += 1
        return self._commit_update(new_engine, new_m, "sparse",
                                   new_engine.effective_top_k, report)

    def _command(self, kind: int, payload: Optional[torch.Tensor] = None
                 ) -> None:
        """Broadcast a command to the followers (``serve_follower``)."""
        if self._closed:
            raise RuntimeError("the rank service is closed")
        head = torch.tensor([kind], dtype=torch.int64)
        msg = head if payload is None else torch.cat([head, payload])
        self.mesh.broadcast(msg.to(self.mesh.device), src=0, axes="model")

    def close(self) -> None:
        """Stop the followers of a rank service (``serve_follower``
        returns); idempotent, and nothing on one device.  A batch in
        flight gathered its rows when it was dispatched: :meth:`poll`
        still harvests it."""
        if self.mesh is None or self._closed:
            return
        self._command(CMD_STOP)
        self._closed = True

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
        s["index_sharded"] = self.index_sharded
        if self.index_sharded:
            s["index_shard_rows"] = self.engine.index.n_shard
            s.update({f"exchange_{k}": v
                      for k, v in self.engine.index.exchange.items()})
        s["device"] = str(self.engine.device)
        s["graphs_captured"] = len(self.engine.graphs)
        s["capture_s"] = self.engine.capture_s
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

    def reset_stats(self) -> None:
        """Zero the counters (after warm-up dispatches, say); cached
        answers and captured graphs stay."""
        for k in self.stats:
            self.stats[k] = 0 if isinstance(self.stats[k], int) else 0.0
        for k in self.pipeline.stats:
            self.pipeline.stats[k] = 0
        self.pipeline.batch_hist.clear()
        for k in self.buffer.stats:
            self.buffer.stats[k] = 0
        for k in self.cache.stats:
            self.cache.stats[k] = 0

    def run_closed_loop(
        self, vertices: Sequence[WorkItem]
    ) -> Tuple[List[Answer], dict]:
        """Serve a fixed workload to completion, offering requests as fast
        as the loop runs (``loadgen.run_closed_loop``); returns
        ``(answers, stats)`` with wall time, qps and latency percentiles."""
        from repro_torch.serving import loadgen

        return loadgen.run_closed_loop(self, vertices)


def encode_edges(inserts=None, deletes=None) -> torch.Tensor:
    """An update batch as one ``int64`` vector for a broadcast: the two
    counts, then the inserted and the deleted ``(src, dst)`` pairs."""
    ins, dele = _edge_pairs(inserts), _edge_pairs(deletes)
    return torch.from_numpy(np.concatenate(
        [[len(ins), len(dele)], ins.reshape(-1), dele.reshape(-1)]).astype(
            np.int64))


def decode_edges(x: torch.Tensor):
    """``(inserts, deletes)`` of :func:`encode_edges`."""
    # contract: allow(host-sync): an update batch is applied on the host
    a = x.cpu().numpy()
    ni, nd = int(a[0]), int(a[1])
    return (a[2:2 + 2 * ni].reshape(ni, 2),
            a[2 + 2 * ni:2 + 2 * (ni + nd)].reshape(nd, 2))


def boot_checkpoint(graph: Graph, checkpoint_dir: str, device="cuda",
                    mesh=None):
    """``(index, maintainer)`` of the complete step under
    ``checkpoint_dir`` (the maintainer ``None`` for a build without
    filters); with a ``RankMesh``, this rank's block."""
    from repro_torch.core import index as index_mod
    from repro_torch.core import updates as updates_mod

    tree, extra = index_mod._restore_complete(checkpoint_dir)
    if "touch" not in tree:
        index, _ = index_mod._index_from_tree(tree, extra, device, mesh)
        return index, None
    m, _ = updates_mod._maintainable_from_tree(
        tree, extra, device, checkpoint_dir, mesh)
    if m.real_n != graph.n:
        raise ValueError(
            f"checkpoint was built on {m.real_n} vertices but the "
            f"graph has {graph.n}")
    return m.index, m


def serve_follower(graph: Graph, index: Optional[RankIndex], mesh=None,
                   maintainer=None, *, checkpoint_dir: Optional[str] = None
                   ) -> dict:
    """A rank service's follower (every model shard but 0 of a ``1 x ep``
    mesh): answers the leader's commands in order until it closes.  Rows:
    this shard's rows a batch touches, to the leader.  An update batch:
    this shard's repair (``core.updates.apply_updates`` on the
    ``maintainer``), swapped in if the leader commits it, dropped if the
    repair fails on any rank or the leader rolls back.  ``checkpoint_dir``
    boots this rank's block of a complete step instead of ``index``.
    Returns the follower's counts and its final ``index``, ``maintainer``
    and ``graph``."""
    from repro_torch.core import updates as updates_mod

    if checkpoint_dir is not None:
        index, maintainer = boot_checkpoint(graph, checkpoint_dir,
                                            mesh=mesh)
    index, maintainer, mesh = _on_service_mesh(index, maintainer, mesh)
    if index.is_leader:
        raise ValueError("model shard 0 leads: it runs PPRService")
    graph = graph.to(mesh.device)
    stats = dict(row_requests=0, updates_applied=0, update_rollbacks=0)
    while True:
        msg = mesh.broadcast(None, src=0, axes="model")
        kind = int(msg[0])
        if kind == CMD_ROWS:
            index.send_rows(msg[1:])
            stats["row_requests"] += 1
        elif kind == CMD_UPDATE:
            inserts, deletes = decode_edges(msg[1:])
            try:
                if maintainer is None:
                    fail_together(mesh, ValueError(
                        "a follower with no maintainer"), "the repair")
                new_graph, new_m, _ = updates_mod.apply_updates(
                    maintainer, graph, inserts=inserts, deletes=deletes)
            except Exception:  # noqa: BLE001 - the leader raises it
                stats["update_rollbacks"] += 1
                continue
            if int(mesh.broadcast(None, src=0, axes="model")[0]):
                graph, maintainer, index = new_graph, new_m, new_m.index
                stats["updates_applied"] += 1
            else:
                stats["update_rollbacks"] += 1
        elif kind == CMD_STOP:
            return dict(stats, index=index, maintainer=maintainer,
                        graph=graph)
        else:
            raise ValueError(f"unknown rank service command {kind}")
