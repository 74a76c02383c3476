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
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import mcfp as mcfp_mod
from repro_torch.core import power_iteration as pi_mod
from repro_torch.core import verd as verd_mod
from repro_torch.core.frontier import topk_dense
from repro_torch.core.graph import Graph
from repro_torch.core.index import PPRIndex
from repro_torch.core.walks import DEFAULT_C
from repro_torch.device import resolve_device

AUTO_SPARSE_MIN_N = 1 << 14

SCATTER_COMBINE_BUDGET_BYTES = 256 * 1024 * 1024


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
    weighted sum of each seed's index row (exact by PPR linearity)."""
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

    def _to_device(self, x, dtype) -> torch.Tensor:
        """Host arrays go up through pinned memory with a non-blocking
        copy: a pageable copy would first wait for the whole stream, which
        serializes the serving pipeline's dispatches."""
        if isinstance(x, torch.Tensor) and x.device.type == self.device.type:
            return x.to(self.device, dtype)
        t = torch.as_tensor(np.asarray(x)).to(dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _inputs(self, sources, weights):
        sources = self._to_device(sources, torch.int32)
        seed_w = None
        if weights is not None:
            seed_w = normalize_seed_weights(
                self._to_device(weights, torch.float32))
        return sources, seed_w

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

    def query_topk_async(self, sources, *, key=None, weights=None, out=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k answers as tensors whose work is enqueued on the current
        CUDA stream, with no host sync on the way (the degree cap is
        resolved once per engine, the ELL view once per graph).  The dense route
        is :meth:`query_topk`'s; the sparse route routes the final combine
        like the reference: scatter while the ``[Q, n]`` scratch fits the
        budget, else the ``index_combine_sparse`` kernel.  ``out`` (donated
        result buffers) is not ported.  ``key`` seeds the ``mcfp`` mode
        (default: the base key; the pipeline passes :meth:`dispatch_key`)."""
        if out is not None:
            raise NotImplementedError(
                "donated result buffers (reuse_buffers) are not ported yet")
        cfg = self.config
        if key is None:
            key = self._base_key
        if not self.uses_sparse_path():
            return self.query_topk(sources, key=key, weights=weights)
        sources, seed_w = self._inputs(sources, weights)
        k = self.effective_top_k
        if cfg.mode == "powerwalk" and self.uses_scatter_combine(
                int(sources.shape[0])):
            s, f = verd_mod.verd_iterate_sparse(
                self.graph, sources, seed_w, t=cfg.t_iterations,
                k=self.frontier_k, c=cfg.c, threshold=cfg.threshold,
                degree_cap=self.degree_cap(),
                hub_split_degree=cfg.hub_split_degree,
            )
            vals, idx = verd_mod.combine_with_index_scatter(
                s, f, self.index, out_k=k)
        else:
            sf = verd_mod.verd_query_sparse(
                self.graph, sources,
                self.index if cfg.mode == "powerwalk" else None,
                t=cfg.t_iterations, k=self.frontier_k, c=cfg.c,
                threshold=cfg.threshold, out_k=k,
                degree_cap=self.degree_cap(),
                hub_split_degree=cfg.hub_split_degree, seed_weights=seed_w,
            )
            vals, idx = sf.values, sf.indices
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
            vals[i:i + len(v)] = v.cpu().numpy()
            idxs[i:i + len(v)] = ix.cpu().numpy()
        elapsed = time.perf_counter() - start
        return dict(
            values=vals, indices=idxs, seconds=elapsed,
            queries=len(sources), qps=len(sources) / max(elapsed, 1e-9),
            mode=self.config.mode, top_k=k,
        )
