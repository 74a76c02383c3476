"""Online batch-query engine (paper Section 3.3).

Buffers a batch of PPR queries, runs them as one shared decomposition, and
returns top-k answers.  The strategies of the paper's Table 3:

* ``powerwalk`` -- VERD iterations + index combine (the contribution),
* ``verd``      -- VERD with no index (the paper's R = 0 column),
* ``fppr``      -- direct index lookup,
* ``pi``        -- power iteration (the accuracy reference),
* ``mcfp``      -- online Monte-Carlo (``r_online`` walks a query, no
  index), drawn from the config seed's key: ``run()`` folds each chunk's
  offset into it and the serving pipeline each dispatch's sequence number
  (:meth:`BatchQueryEngine.dispatch_key`), so answers replay bit for bit.

The VERD modes run on ``Q x K`` sparse state or on dense ``[Q, n]`` state
(small graphs, hub-heavy graphs without hub splitting); the baselines run
dense.  Routing constants and the frontier-width estimate are the
reference's (``repro.core.query``) verbatim, so the same config resolves
to the same route and widths.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import capture as capture_mod
from repro_torch.core import mcfp as mcfp_mod
from repro_torch.core import power_iteration as pi_mod
from repro_torch.core import verd as verd_mod
from repro_torch.core import walks as walks_mod
from repro_torch.core.frontier import topk_dense
from repro_torch.core.graph import Graph
from repro_torch.core.index import PPRIndex, RankIndex
from repro_torch.core.walks import DEFAULT_C
from repro_torch.device import resolve_device

AUTO_SPARSE_MIN_N = 1 << 14

SCATTER_COMBINE_BUDGET_BYTES = 256 * 1024 * 1024

MCFP_MAX_STEPS = 64   # positions a walk of the mcfp mode (estimate_ppr's)


def auto_frontier_floor(top_k: int) -> int:
    """Minimum auto-derived sparse frontier width K: 4x the answer size,
    at least 256."""
    return max(4 * top_k, 256)


def normalize_seed_weights(weights: torch.Tensor) -> torch.Tensor:
    """Seed-set weights normalized to sum 1 per row (all-zero rows stay 0)."""
    w = weights.to(torch.float32)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)


def _fppr_lookup(index: PPRIndex, sources, seed_w) -> torch.Tensor:
    """fppr dense answers: a plain row lookup, or for seed sets the
    weighted sum of each seed's index row (exact by PPR linearity).  A
    :class:`RankIndex` first gathers the seeds' rows on the leader and
    looks them up there: the same rows, the same bytes."""
    if isinstance(index, RankIndex):
        need = torch.unique(sources.long())
        index, sources = index.gather(need), torch.searchsorted(
            need, sources.long())
    if seed_w is None:
        return index.lookup_dense(sources)
    q, s = sources.shape
    rows = index.lookup_dense(sources.reshape(-1)).reshape(q, s, -1)
    return (seed_w[:, :, None] * rows).sum(dim=1)


@dataclasses.dataclass
class QueryConfig:
    mode: str = "powerwalk"       # powerwalk | verd | fppr | mcfp | pi
    t_iterations: int = 2
    c: float = DEFAULT_C
    top_k: int = 200
    r_online: int = 2000
    pi_iterations: int = 100
    threshold: float = 0.0
    max_batch: int = 4096
    frontier_k: int = 0            # sparse frontier width (0 = auto-derive)
    frontier_path: str = "auto"    # dense | sparse | auto
    combine_path: str = "auto"     # sparse | scatter | auto
    hub_split_degree: int = 0
    max_seeds: int = 1
    seed: int = 0                  # base PRNG seed of the mcfp mode


class BatchQueryEngine:
    """Executes batches of PPR queries with a shared decomposition."""

    def __init__(self, graph: Graph, index: Optional[PPRIndex] = None,
                 config: Optional[QueryConfig] = None, device="cuda"):
        self.device = resolve_device(device)
        self.graph = graph.to(self.device)
        self.index = None if index is None else index.to(self.device)
        self.config = config or QueryConfig()
        cfg = self.config
        if cfg.mode in ("powerwalk", "fppr") and index is None:
            raise ValueError(f"mode {cfg.mode} requires a PPR index")
        if index is not None and index.n < graph.n:
            raise ValueError(f"index covers {index.n} rows < graph.n={graph.n}")
        if cfg.frontier_path not in ("dense", "sparse", "auto"):
            raise ValueError(f"unknown frontier_path {cfg.frontier_path!r}")
        if cfg.combine_path not in ("sparse", "scatter", "auto"):
            raise ValueError(f"unknown combine_path {cfg.combine_path!r}")
        if cfg.max_seeds > 1 and cfg.mode in ("mcfp", "pi"):
            raise ValueError(
                f"mode {cfg.mode!r} does not support seed-set queries")
        # the base key is pure config, so a rebuilt engine replays the same
        # Monte-Carlo noise; the stateful key serves direct query_dense calls
        self._base_key = rng.prng_key(cfg.seed)
        self._key = self._base_key
        self._degree_cap: Optional[int] = None
        # one CUDA graph per dispatch shape, all in one memory pool; they
        # live and die with the engine
        self.graphs: Dict[tuple, capture_mod.CapturedQuery] = {}
        self._pool = None
        self.capture_s = 0.0

    @property
    def exchanges_rows(self) -> bool:
        """Whether a query gathers index rows from other ranks: the index
        is one rank's model shard (a
        :class:`~repro_torch.core.index.RankIndex`) and the mode reads it
        (``powerwalk``, ``fppr``).  No CUDA graph can hold the exchange,
        so those dispatches run eagerly; the other modes capture as on
        one device."""
        return (isinstance(self.index, RankIndex)
                and self.config.mode in ("powerwalk", "fppr"))

    @property
    def frontier_k(self) -> int:
        """Sparse frontier width K: ``cfg.frontier_k``, or the expected
        support ``mean_degree ** t * max_seeds`` floored at
        :func:`auto_frontier_floor` and capped at ``n``."""
        cfg = self.config
        n = self.graph.n
        if cfg.frontier_k > 0:
            return min(cfg.frontier_k, n)
        mean_deg = self.graph.m / max(n, 1)
        log_support = (
            cfg.t_iterations * math.log(max(mean_deg, 1.0))
            + math.log(max(cfg.max_seeds, 1))
        )
        if log_support >= math.log(max(n, 1)):
            # contract: allow(host-sync): n is the graph's Python int
            support = float(n)
        else:
            support = math.exp(log_support)
        return min(
            n, max(auto_frontier_floor(cfg.top_k), int(math.ceil(support)))
        )

    def uses_sparse_path(self) -> bool:
        """Route decision (the reference's): sparse once ``n >=
        AUTO_SPARSE_MIN_N``, ``8K <= n`` and ``K * gather width <= n``."""
        cfg = self.config
        if cfg.mode not in ("powerwalk", "verd"):
            return False
        if cfg.frontier_path == "sparse":
            return True
        if cfg.frontier_path == "dense":
            return False
        return (
            self.graph.n >= AUTO_SPARSE_MIN_N
            and 8 * self.frontier_k <= self.graph.n
            and self.frontier_k * self.effective_gather_width() <= self.graph.n
        )

    def uses_scatter_combine(self, q: int) -> bool:
        """Final combine by dense scatter while ``q * n * 4`` bytes fits
        :data:`SCATTER_COMBINE_BUDGET_BYTES`, else the sparse combine."""
        cfg = self.config
        if cfg.mode != "powerwalk" or not self.uses_sparse_path():
            return False
        if cfg.combine_path == "scatter":
            return True
        if cfg.combine_path == "sparse":
            return False
        return q * self.graph.n * 4 <= SCATTER_COMBINE_BUDGET_BYTES

    def degree_cap(self) -> int:
        if self._degree_cap is None:
            self._degree_cap = verd_mod.resolve_degree_cap(self.graph)
        return self._degree_cap

    def effective_gather_width(self) -> int:
        h, _ = verd_mod.resolve_hub_splits(
            self.degree_cap(), self.config.hub_split_degree)
        return h

    @property
    def effective_top_k(self) -> int:
        return max(1, min(self.config.top_k, self.graph.n))

    def _host_tensor(self, x, dtype) -> torch.Tensor:
        """A dispatch input on the host, pinned on a CUDA engine (a
        pageable copy would first wait for the whole stream, which
        serializes the serving pipeline's dispatches), or the tensor
        itself where it already lies on the engine's device."""
        if isinstance(x, torch.Tensor) and x.device.type == self.device.type:
            return x.to(dtype)
        t = torch.as_tensor(np.asarray(x)).to(dtype)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, x, dtype) -> torch.Tensor:
        return self._host_tensor(x, dtype).to(self.device, non_blocking=True)

    def _inputs_raw(self, sources, weights):
        """Sources and raw weights on the device (not normalized: the
        query body normalizes them, inside a captured graph too)."""
        sources = self._to_device(sources, torch.int32)
        if weights is not None:
            weights = self._to_device(weights, torch.float32)
        return sources, weights

    def _inputs(self, sources, weights):
        sources, weights = self._inputs_raw(sources, weights)
        return sources, (None if weights is None
                         else normalize_seed_weights(weights))

    def query_sparse(self, sources, out_k: Optional[int] = None,
                     weights=None):
        """Sparse-path answers as a SparseFrontier (never builds [Q, n])."""
        cfg = self.config
        if cfg.mode not in ("powerwalk", "verd"):
            raise ValueError(
                f"mode {cfg.mode!r} has no frontier; query_sparse supports "
                "the VERD modes (powerwalk, verd) only")
        sources, seed_w = self._inputs(sources, weights)
        return verd_mod.verd_query_sparse(
            self.graph, sources, self.index if cfg.mode == "powerwalk" else None,
            t=cfg.t_iterations, k=self.frontier_k, c=cfg.c,
            threshold=cfg.threshold, out_k=out_k or self.effective_top_k,
            degree_cap=self.degree_cap(),
            hub_split_degree=cfg.hub_split_degree, seed_weights=seed_w,
        )

    def query_dense(self, sources, *, key=None, weights=None
                    ) -> torch.Tensor:
        """Dense ``f32[Q, n]`` answers of the configured mode.  ``key``
        sets the ``mcfp`` mode's stream; without it the engine's stateful
        key splits once a call.  ``weights`` switches to seed-set rows
        (linear modes only: ``mcfp`` and ``pi`` raise)."""
        cfg = self.config
        if weights is not None and cfg.mode in ("mcfp", "pi"):
            raise ValueError(
                f"mode {cfg.mode!r} does not support seed-set queries")
        sources, seed_w = self._inputs(sources, weights)
        g = self.graph
        if cfg.mode in ("powerwalk", "verd"):
            return verd_mod.verd_query(
                g, sources, self.index if cfg.mode == "powerwalk" else None,
                t=cfg.t_iterations, c=cfg.c, threshold=cfg.threshold,
                seed_weights=seed_w)
        if cfg.mode == "fppr":
            return _fppr_lookup(self.index, sources, seed_w)
        if cfg.mode == "mcfp":
            if key is None:
                self._key, key = rng.split(self._key)
            return mcfp_mod.estimate_ppr(g, sources, cfg.r_online, key,
                                         c=cfg.c)
        if cfg.mode == "pi":
            return pi_mod.power_iteration(g, sources,
                                          n_iter=cfg.pi_iterations, c=cfg.c)
        raise ValueError(f"unknown mode {cfg.mode!r}")

    def query_topk(self, sources, *, key=None, weights=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k answers ``(values f32[Q, k], indices int32[Q, k])``: the
        sparse route with the sparse combine, or the dense answers' top-k
        in ``lax.top_k``'s order (ties by vertex ascending)."""
        k = self.effective_top_k
        if self.uses_sparse_path():
            sf = self.query_sparse(sources, out_k=k, weights=weights)
            vals, idx = sf.values, sf.indices
        else:
            vals, idx = topk_dense(
                self.query_dense(sources, key=key, weights=weights), k)
        if vals.shape[-1] != k or idx.shape[-1] != k:
            raise AssertionError((tuple(vals.shape), tuple(idx.shape), k))
        return vals, idx

    def dispatch_key(self, seq: int) -> torch.Tensor:
        """Per-dispatch PRNG key: the config seed's key with the dispatch
        sequence number folded in, so ``mcfp`` answers replay bit for bit
        for a given (seed, dispatch order) at any pipeline depth."""
        return rng.fold_in(self._base_key, seq)

    @property
    def uses_key(self) -> bool:
        """Whether answers depend on the dispatch key (the ``mcfp`` mode)."""
        return self.config.mode == "mcfp"

    def query_topk_async(self, sources, *, key=None, weights=None, out=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k answers as tensors whose work is enqueued on the current
        CUDA stream, with no host sync on the way.

        On the card each dispatch shape (padded width, seed-set width) is
        one CUDA graph (``core/capture.py``), captured at its first
        dispatch, as the reference's jit compiles once per padded width:
        the inputs go up through pinned memory into the graph's static
        inputs, the graph replays, and the graph's static outputs come
        back; they hold this answer until the next dispatch of the same
        shape is enqueued.  ``out = (vals f32[Q, k], idx int32[Q, k])``
        receives a copy of the answer, enqueued on the stream, and is
        returned instead.  On the CPU the query runs eagerly.

        The query is the reference's ``_fused_topk``: the sparse route
        combines by scatter while the ``[Q, n]`` scratch fits the budget,
        else through ``index_combine_sparse``; the dense route is
        :meth:`query_topk`'s.  ``key`` seeds the ``mcfp`` mode (default:
        the base key; the pipeline passes :meth:`dispatch_key`).  Where a
        query gathers rows from other ranks (:attr:`exchanges_rows`) the
        dispatch runs eagerly on the card too, the row exchange in the
        middle."""
        cfg = self.config
        if weights is not None and cfg.mode in ("mcfp", "pi"):
            raise ValueError(
                f"mode {cfg.mode!r} does not support seed-set queries")
        if self.uses_key and key is None:
            key = self._base_key
        if self.device.type == "cuda" and not self.exchanges_rows:
            vals, idx = self._replay(sources, weights, key)
        else:
            vals, idx = self._query_eager(sources, weights, key)
        if out is None:
            return vals, idx
        out[0].copy_(vals, non_blocking=True)
        out[1].copy_(idx, non_blocking=True)
        return out[0], out[1]

    def _query_eager(self, sources, weights, key):
        """The dispatch run op by op with no graph (the CPU's path)."""
        sources, weights = self._inputs_raw(sources, weights)
        words = (walks_mod.step_key_words(key, MCFP_MAX_STEPS, self.device)
                 if self.uses_key else None)
        return self._topk_eager(sources, weights, words)

    def _replay(self, sources, weights, key):
        """Write the dispatch's inputs into its shape's graph, capturing
        the graph at the shape's first dispatch, and replay it."""
        src = self._host_tensor(sources, torch.int32)
        w = None if weights is None else self._host_tensor(weights,
                                                           torch.float32)
        shape = (tuple(src.shape), None if w is None else tuple(w.shape))
        cap = self.graphs.get(shape)
        words = (walks_mod.host_step_key_words(key, MCFP_MAX_STEPS)
                 .pin_memory() if self.uses_key else None)
        if cap is None:
            static = [None if x is None else torch.empty(
                x.shape, dtype=x.dtype, device=self.device)
                for x in (src, w, words)]
            self._write(static, (src, w, words))
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            cap = self.graphs[shape] = capture_mod.CapturedQuery(
                self._topk_eager, *static, self.effective_top_k, self._pool)
            self.capture_s += cap.capture_s
        else:
            self._write((cap.sources, cap.weights, cap.words),
                        (src, w, words))
        return cap.replay()

    @staticmethod
    def _write(static, values) -> None:
        """Enqueue the copies of a dispatch's inputs (pinned host tensors,
        or tensors on the card) into a graph's static inputs."""
        for dst, x in zip(static, values):
            if dst is not None:
                dst.copy_(x, non_blocking=True)

    def capture_shapes(self, shapes) -> None:
        """Capture the graphs of ``shapes`` (keys of another engine's
        :attr:`graphs`) ahead of serving, on inputs of vertex 0 (weight 1
        on the first seed)."""
        for src_shape, w_shape in shapes:
            if (src_shape, w_shape) in self.graphs:
                continue
            weights = None
            if w_shape is not None:
                weights = np.zeros(w_shape, np.float32)
                weights[:, 0] = 1.0
            self._replay(np.zeros(src_shape, np.int32), weights,
                         self._base_key if self.uses_key else None)

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes of the engine's graph memory pool (None: not
        measurable here)."""
        if self._pool is None:
            return 0
        return capture_mod.pool_bytes(self._pool, self.device)

    def _topk_eager(self, sources, weights, words
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole query on device inputs, op by op: the body each
        captured graph records (the reference's ``_fused_topk_impl``).
        ``weights`` are raw seed weights; ``words`` the ``mcfp`` mode's
        step key words."""
        cfg = self.config
        g = self.graph
        k = self.effective_top_k
        seed_w = None if weights is None else normalize_seed_weights(weights)
        if self.uses_sparse_path():
            if cfg.mode == "powerwalk" and self.uses_scatter_combine(
                    int(sources.shape[0])):
                s, f = verd_mod.verd_iterate_sparse(
                    g, sources, seed_w, t=cfg.t_iterations,
                    k=self.frontier_k, c=cfg.c, threshold=cfg.threshold,
                    degree_cap=self.degree_cap(),
                    hub_split_degree=cfg.hub_split_degree,
                )
                vals, idx = verd_mod.combine_with_index_scatter(
                    s, f, self.index, out_k=k)
            else:
                sf = verd_mod.verd_query_sparse(
                    g, sources,
                    self.index if cfg.mode == "powerwalk" else None,
                    t=cfg.t_iterations, k=self.frontier_k, c=cfg.c,
                    threshold=cfg.threshold, out_k=k,
                    degree_cap=self.degree_cap(),
                    hub_split_degree=cfg.hub_split_degree,
                    seed_weights=seed_w,
                )
                vals, idx = sf.values, sf.indices
        else:
            if cfg.mode in ("powerwalk", "verd"):
                dense = verd_mod.verd_query(
                    g, sources,
                    self.index if cfg.mode == "powerwalk" else None,
                    t=cfg.t_iterations, c=cfg.c, threshold=cfg.threshold,
                    seed_weights=seed_w)
            elif cfg.mode == "fppr":
                dense = _fppr_lookup(self.index, sources, seed_w)
            elif cfg.mode == "mcfp":
                dense = mcfp_mod.estimate_ppr(
                    g, sources, cfg.r_online, None, c=cfg.c,
                    max_steps=MCFP_MAX_STEPS, words=words)
            elif cfg.mode == "pi":
                dense = pi_mod.power_iteration(
                    g, sources, n_iter=cfg.pi_iterations, c=cfg.c)
            else:
                raise ValueError(f"unknown mode {cfg.mode!r}")
            vals, idx = topk_dense(dense, k)
        if vals.shape[-1] != k or idx.shape[-1] != k:
            raise AssertionError((tuple(vals.shape), tuple(idx.shape), k))
        return vals, idx

    def run(self, sources, weights=None) -> dict:
        """Execute a query set in ``max_batch`` chunks; answers + timing.
        The ``mcfp`` mode folds each chunk's offset into the config seed's
        key, so a rerun (or a rebuilt engine) replays every chunk."""
        sources = np.asarray(sources, dtype=np.int32)
        weights = None if weights is None else np.asarray(weights, np.float32)
        k = self.effective_top_k
        vals = np.zeros((len(sources), k), dtype=np.float32)
        idxs = np.zeros((len(sources), k), dtype=np.int32)
        start = time.perf_counter()
        step = self.config.max_batch
        for i in range(0, len(sources), step):
            w_chunk = None if weights is None else weights[i:i + step]
            v, ix = self.query_topk(sources[i:i + step],
                                    key=rng.fold_in(self._base_key, i),
                                    weights=w_chunk)
            # contract: allow(host-sync): offline runner returns host arrays
            vals[i:i + len(v)] = v.cpu().numpy()
            # contract: allow(host-sync): offline runner returns host arrays
            idxs[i:i + len(v)] = ix.cpu().numpy()
        elapsed = time.perf_counter() - start
        return dict(
            values=vals, indices=idxs, seconds=elapsed,
            queries=len(sources), qps=len(sources) / max(elapsed, 1e-9),
            mode=self.config.mode, top_k=k,
        )


# ---------------------------------------------------------------------------
# Contract-auditor entry points (repro_torch.analysis).
#
# dense-state-bound: the sparse query path must hold Q x K state, never an
# f32[Q, n] dense frontier (the scatter combine is budget-gated separately,
# so the audit pins the sparse combine path).  The widest legal f32
# intermediate is the combine candidate row (~K*L wide) plus the push
# gather area (~K*degree_cap), far under the dense floor Q*n.
#
# retrace-guard: the captured serving dispatch must hold exactly one CUDA
# graph per bucketed pad width — a dtype or input-spelling wobble in the
# dispatch path (an int64 tensor, a python-int seed list, an np.int32
# array) would silently double capture time and graph-pool memory.
# ---------------------------------------------------------------------------

from repro_torch.analysis.registry import register_entry_point as _register_ep


def _random_index(n: int, l: int, seed: int, device) -> PPRIndex:
    r = np.random.default_rng(seed)
    return PPRIndex(
        values=torch.as_tensor(r.random((n, l)), dtype=torch.float32,
                               device=device),
        indices=torch.as_tensor(r.integers(0, n, (n, l)), dtype=torch.int32,
                                device=device),
        l=l, n=n)


def _contract_spec_sparse_query(device):
    from repro_torch.analysis.trace import record
    from repro_torch.graphs import synthetic

    n, q, l = 1 << 14, 8, 16
    g = synthetic.erdos_renyi(n, 3.0, seed=7, device=device)
    engine = BatchQueryEngine(g, _random_index(n, l, 0, g.device), QueryConfig(
        mode="powerwalk", t_iterations=2, top_k=32, frontier_k=128,
        frontier_path="sparse", combine_path="sparse",
    ), device=device)
    cap = engine.degree_cap()   # primed outside the run (a host read)
    k = engine.frontier_k
    sources = torch.arange(q, dtype=torch.int32, device=engine.device)
    _, records = record(engine.query_topk_async, sources)
    budget = q * (k * (cap + l + 8) + 1024)
    return dict(records=records, budget=budget, floor=q * n)


def _retrace_spec_fused_topk(device):
    from repro_torch.graphs import synthetic
    from repro_torch.serving.batching import BatchingConfig

    n, l = 256, 8
    g = synthetic.erdos_renyi(n, 4.0, seed=3, device=device)
    engine = BatchQueryEngine(
        g, _random_index(n, l, 1, g.device),
        QueryConfig(mode="powerwalk", t_iterations=1, top_k=8),
        device=device)
    widths = BatchingConfig(max_batch=64).padded_shapes()

    def call(width: int, variant: int) -> None:
        # three spellings of the same batch a production dispatcher might
        # produce; all must land in one captured graph per width
        if variant == 0:
            srcs = np.zeros(width, np.int32)
        elif variant == 1:
            srcs = torch.zeros(width, dtype=torch.int64, device=engine.device)
        else:
            srcs = [0] * width
        engine.query_topk_async(srcs, key=engine.dispatch_key(0))

    return dict(cache=engine.graphs, widths=widths, variants=3, call=call,
                captures=engine.device.type == "cuda")


_register_ep("sparse-query-path", "dense-state-bound",
             "src/repro_torch/core/query.py", _contract_spec_sparse_query)
_register_ep("fused-topk-serving", "retrace-guard",
             "src/repro_torch/core/query.py", _retrace_spec_fused_topk)
