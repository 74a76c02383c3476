"""Distributed PPR engine: PowerWalk's vertex-sharded, query-tiled VERD
(the counterpart of ``repro.core.distributed_engine``, "PowerWalk at pod
scale").

* **Graph layout**: vertices partition into ``ep`` contiguous model-axis
  intervals of ``n_shard``; each shard owns the out-edges of its vertices
  (local CSR rows, global destination ids), :func:`build_sharded_graph`.
* **VERD iteration, sparse exchange** (default): each shard pushes its
  local ``[Q, K]`` frontier slice through its slab with the
  ``sharded_frontier_push`` kernel, which emits per-owner top-``wire_k``
  ``(value, local index)`` buckets; one ``all_to_all`` moves them, and
  each shard dedup-merges what it received back to its ``[Q, K]`` slice.
  ``exchange="dense"`` keeps the full ``[Q, n]`` slab exchange as the
  oracle (and its deprecated ``compress_k`` variant).
* **Index combine + top-k**: the local combine against the vertex-sharded
  index, bucketed by owner and exchanged once, then each shard's top-k,
  gathered and re-selected.
* **Offline**: :func:`make_sparse_index_build_step` sweeps each shard's
  source chunks; walks split over the data axis and their sketches merge
  in replica order (``index.sparse_chunk_estimates``);
  :func:`make_sparse_walk_counts_step` splits walks over every shard and
  merges them through one gather.
* **MCFP walk counts** (:func:`make_walk_counts_step`): walk cursors split
  over the data axis, and every shard counts the visits that land in its
  vertex interval, with no communication until the final sums.

The mesh is a :class:`~repro_torch.distributed.mesh.ShardMesh`, whose
shards are a stacked axis on one device, or a
:class:`~repro_torch.distributed.mesh.RankMesh`, one shard a process.
Each step runs the body of every shard the process holds
(``mesh.local_data``, ``mesh.local_model``) in a loop, and each
collective names the mesh axes it joins, as the reference's do inside its
``shard_map``.  A global shard index builds global ids and keys; a local
position indexes the local stacks.  Operands and results follow the
reference's specs: what it shards over an axis (the slabs and the index
over ``model``, the build's rows, the walk counts' blocks) a process
passes and gets for its own shards only, stacked on a leading axis; what
it replicates (sources, keys, the walk steps' graph arrays, the tile's
answers) every process passes and gets whole.  So a rank's results are
the stacked mesh's for its shards, bit for bit.  On the card the sparse
step launches ``sharded_frontier_push`` once per local shard and
iteration, as the reference calls its kernel once per device.  The
reference's ``kernel_q_tile`` and ``kernel_interpret`` only tile or
interpret the TPU kernel and are dropped.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import frontier as frontier_mod
from repro_torch.core.graph import Graph
from repro_torch.core.index import (normalize_sketch_to_index_rows,
                                    sparse_chunk_estimates)
from repro_torch.core.query import auto_frontier_floor
from repro_torch.core.walks import (DEFAULT_C, advance_walks,
                                    simulate_walks_sparse, step_key_words)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Distributed engine configuration (the reference's fields, less the
    TPU kernel's ``kernel_q_tile`` and ``kernel_interpret``, and the mesh
    axis names: a :class:`ShardMesh` has exactly its ``data`` and
    ``model`` axes, read by name)."""

    n: int                      # padded global vertex count (multiple of ep)
    ep: int                     # model-axis shards (vertex intervals)
    q_tile: int = 32            # queries per shared-decomposition tile
    c: float = DEFAULT_C
    t_iterations: int = 2
    index_l: int = 667
    top_k: int = 200
    exchange: str = "sparse"    # sparse (per-owner buckets) | dense (oracle)
    frontier_k: int = 0         # per-shard local frontier width (0 = derive)
    wire_k: int = 0             # per-owner exchange width (0 = frontier_k)
    combine_wire_k: int = 0     # index-combine exchange width (0 = derive)
    degree_cap: int = 0         # max out-degree; required for sparse exchange
    hub_split_degree: int = 0   # TPU gather geometry; no effect on answers
    compress_k: int = 0         # DEPRECATED: top-k'd dense exchange; use
                                # exchange="sparse" + wire_k instead
    edge_chunk: int = 1 << 22   # local edge-scan chunk of the dense oracle
    wire_dtype: Any = torch.float32   # bf16 halves exchange bytes

    def __post_init__(self):
        if self.exchange not in ("sparse", "dense"):
            raise ValueError(f"unknown exchange {self.exchange!r}")
        if self.compress_k:
            warnings.warn(
                "DistConfig.compress_k is deprecated: set wire_k instead. "
                "On the default exchange='sparse' path compress_k is only "
                "honored as the wire_k fallback when wire_k is unset; on "
                "the legacy exchange='dense' oracle path it still selects "
                "the compressed slab exchange.",
                DeprecationWarning,
                stacklevel=2,
            )

    @property
    def n_shard(self) -> int:
        return self.n // self.ep

    @property
    def resolved_frontier_k(self) -> int:
        """Local frontier width K (the engine selector's auto floor)."""
        if self.frontier_k > 0:
            return min(self.frontier_k, self.n)
        return min(self.n, auto_frontier_floor(self.top_k))

    @property
    def resolved_wire_k(self) -> int:
        """Per-owner exchange width; ``n_shard`` always covers."""
        k = self.wire_k if self.wire_k > 0 else (
            self.compress_k if self.compress_k > 0
            else self.resolved_frontier_k
        )
        return min(k, self.n_shard)

    @property
    def resolved_combine_wire_k(self) -> int:
        k = self.combine_wire_k if self.combine_wire_k > 0 else max(
            self.resolved_wire_k, self.top_k
        )
        return min(k, self.n_shard)


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Per-shard CSR slabs, stacked on a leading shard dim.

    row_ptr: int32[ep, n_shard + 1]   local rows (offsets into col_idx row)
    col_idx: int32[ep, m_shard]       global destination ids (padded)
    edge_w:  f32[ep, m_shard]         1/out_deg(src), 0 on padding, for
                                      exchange="dense"; a [ep, 1] stub for
                                      the sparse step, which re-derives 1/deg
    dangling: f32[ep, n_shard]        1.0 where the local vertex is dangling
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    edge_w: torch.Tensor
    dangling: torch.Tensor

    @staticmethod
    def specs(cfg: DistConfig, m_shard: int, device="meta") -> "ShardedGraph":
        """The four slabs as empty tensors of their shapes and dtypes (the
        reference's ``ShapeDtypeStruct`` specs): on ``meta`` for a
        dry-run, which allocates nothing."""
        dev = resolve_device(device)
        m_w = m_shard if cfg.exchange == "dense" else 1
        empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
        return ShardedGraph(
            row_ptr=empty((cfg.ep, cfg.n_shard + 1), torch.int32),
            col_idx=empty((cfg.ep, m_shard), torch.int32),
            edge_w=empty((cfg.ep, m_w), torch.float32),
            dangling=empty((cfg.ep, cfg.n_shard), torch.float32))


def build_sharded_graph(graph: Graph, cfg: DistConfig, device="cuda",
                        shards=None) -> ShardedGraph:
    """Host-side partitioning of a graph into per-shard slabs on
    ``device``: every shard's, or the listed model ``shards``' (a rank's
    own), stacked in that order and padded to the widest shard of all, as
    the stacked slabs are."""
    dev = resolve_device(device)
    ep, ns = cfg.ep, cfg.n_shard
    row_ptr = graph.row_ptr.cpu().numpy().astype(np.int64)
    col = graph.col_idx.cpu().numpy().astype(np.int32)
    deg = graph.out_deg.cpu().numpy().astype(np.float32)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    bounds = row_ptr[np.minimum(np.arange(ep + 1) * ns, graph.n)]
    m_shard = max(int(np.diff(bounds).max()), 1)
    slabs = []
    for s in (range(ep) if shards is None else shards):
        lo_v, hi_v = s * ns, min((s + 1) * ns, graph.n)
        lo_e = row_ptr[lo_v] if lo_v <= graph.n else row_ptr[-1]
        hi_e = row_ptr[hi_v] if hi_v <= graph.n else row_ptr[-1]
        local_rp = (row_ptr[lo_v:hi_v + 1] - row_ptr[lo_v]).astype(np.int32) \
            if lo_v <= graph.n else np.zeros(1, np.int32)
        if len(local_rp) < ns + 1:   # pad vertex rows of the last shards
            local_rp = np.concatenate(
                [local_rp,
                 np.full(ns + 1 - len(local_rp), local_rp[-1], np.int32)])
        lc = col[lo_e:hi_e]
        if cfg.exchange == "dense":
            lw = np.repeat(inv[lo_v:hi_v],
                           np.diff(row_ptr[lo_v:hi_v + 1]).astype(np.int64))
        else:
            lw = np.zeros(0, np.float32)
        dang = np.zeros(ns, np.float32)
        real = min(hi_v, graph.n) - lo_v
        if real > 0:
            dang[:real] = (deg[lo_v:lo_v + real] == 0).astype(np.float32)
        slabs.append((local_rp, lc, lw.astype(np.float32), dang))
    rp = np.stack([s[0] for s in slabs])
    ci = np.stack([np.pad(s[1], (0, m_shard - len(s[1]))) for s in slabs])
    if cfg.exchange == "dense":
        ew = np.stack([np.pad(s[2], (0, m_shard - len(s[2]))) for s in slabs])
    else:   # the sparse step re-derives 1/deg: no O(m) f32 slab
        ew = np.zeros((len(slabs), 1), np.float32)
    dg = np.stack([s[3] for s in slabs])
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return ShardedGraph(row_ptr=as_t(rp), col_idx=as_t(ci), edge_w=as_t(ew),
                        dangling=as_t(dg))


# ---------------------------------------------------------------------------
# one VERD iteration, per shard
# ---------------------------------------------------------------------------

_ADD_ELEMENTS = 1 << 26   # values one accumulating index_put_ sorts


def _add_columns(acc, cols, vals):
    """``acc[q, cols[q, j]] += vals[q, j]`` for ``[qt, n]`` rows, each
    column's values summed in ``j`` order on the card too: an accumulating
    ``index_put_`` (``index_add_`` adds duplicates by CUDA atomics, in no
    fixed order, so the answers would differ from run to run).  It sorts
    an int64 index of its values, so ``j`` goes ``_ADD_ELEMENTS`` values
    at a time; each call adds a column's values to what it holds in ``j``
    order, so the sums are those of one call."""
    qt, n = acc.shape
    rows = torch.arange(qt, dtype=torch.int64, device=acc.device)[:, None]
    width = max(1, _ADD_ELEMENTS // qt)
    for j in range(0, vals.shape[1], width):
        part = vals[:, j:j + width]
        flat = rows * n + cols[:, j:j + width].long()
        acc.view(-1).index_put_((flat.expand(part.shape).reshape(-1),),
                                part.reshape(-1), accumulate=True)
    return acc


def _push_local(cfg: DistConfig, g_row_ptr, g_col, g_w, f_local):
    """Local dense push: ``[qt, ns] -> [qt, ep, ns]`` contributions by
    destination owner, scanning the slab ``edge_chunk`` edges at a time."""
    qt = f_local.shape[0]
    m = g_col.shape[0]
    chunk = max(1, min(cfg.edge_chunk, m))
    acc = torch.zeros((qt, cfg.n), dtype=torch.float32,
                      device=f_local.device)
    for e0 in range(0, m, chunk):
        e_ids = torch.arange(e0, min(e0 + chunk, m), dtype=g_row_ptr.dtype,
                             device=f_local.device)
        src_row = torch.clamp(
            torch.searchsorted(g_row_ptr, e_ids, right=True) - 1,
            0, cfg.n_shard - 1)
        vals = f_local[:, src_row] * g_w[e_ids.long()][None, :]
        # destination bucket = owner * n_shard + local id == global id
        _add_columns(acc, g_col[e_ids.long()][None, :], vals)
    return acc.reshape(qt, cfg.ep, cfg.n_shard)


def _check_mesh(cfg: DistConfig, mesh) -> None:
    if mesh.model != cfg.ep:
        raise ValueError(
            f"mesh {mesh.shape} has {mesh.model} 'model' shards, the config "
            f"{cfg.ep}")
    if cfg.n % cfg.ep:
        raise ValueError(f"n={cfg.n} must be a multiple of ep={cfg.ep}")


def _stacked_sources(cfg: DistConfig, sources, device, shards: range):
    """Per model shard of ``shards``: ``hit`` (1.0 where the source is
    local) and the source's local id clipped into the shard."""
    sources = torch.as_tensor(sources).to(device=device, dtype=torch.int32)
    lo = (torch.arange(shards.start, shards.stop, dtype=torch.int32,
                       device=device) * cfg.n_shard)[:, None]
    hit = ((sources >= lo) & (sources < lo + cfg.n_shard)).to(torch.float32)
    local = torch.clamp(sources - lo, 0, cfg.n_shard - 1).to(torch.int32)
    return hit, local


def _gathered_topk(cfg: DistConfig, mesh, lv, gi):
    """Distributed top-k: gather every shard's local top-k (global ids),
    re-select with ``lax.top_k``'s order."""
    av = mesh.all_gather(torch.stack(lv), "model")
    ai = mesh.all_gather(torch.stack(gi), "model")
    out_v, sel = frontier_mod.topk_dense(av, cfg.top_k)
    return out_v, torch.gather(ai, 1, sel.long())


def make_verd_tile_step(cfg: DistConfig, mesh):
    """Returns ``fn(slabs, sources[qt], index_vals, index_idx) ->
    (topk_vals f32[qt, top_k], topk_idx int32[qt, top_k])``.

    One query tile: ``t`` iterations of shared decomposition, the index
    combine and the distributed top-k.  ``slabs`` and ``index_vals/idx``
    (``[shards, n_shard, L]``) hold the process's model shards
    (``mesh.local_model``: all ``ep`` on a ``ShardMesh``, one on a rank);
    ``sources`` and the answers are whole on every process.
    ``cfg.exchange`` picks the sparse wire format (per-owner top-``wire_k``
    pairs) or the dense slab oracle.
    """
    _check_mesh(cfg, mesh)
    if cfg.exchange == "sparse":
        return _make_verd_tile_step_sparse(cfg, mesh)
    return _make_verd_tile_step_dense(cfg, mesh)


def _make_verd_tile_step_dense(cfg: DistConfig, mesh):
    """Dense slab exchange: ``O(Q x N)`` wire bytes per iteration."""
    ep, ns, c = cfg.ep, cfg.n_shard, cfg.c
    shards = mesh.local_model
    loc = range(len(shards))

    def wire_a2a(x):
        # the cast goes before the exchange, as the reference's does: the
        # wire carries wire_dtype
        return mesh.all_to_all(x.to(cfg.wire_dtype), "model").to(
            torch.float32)

    def step(slabs: ShardedGraph, sources, index_vals, index_idx):
        dev = mesh.device
        hit, local = _stacked_sources(cfg, sources, dev, shards)
        qt = hit.shape[1]
        rows = torch.arange(qt, device=dev)
        onehot = [torch.zeros((qt, ns), dtype=torch.float32, device=dev)
                  .index_put_((rows, local[e].long()), hit[e], accumulate=True)
                  for e in loc]
        f = list(onehot)
        s = [torch.zeros_like(x) for x in onehot]
        for _ in range(cfg.t_iterations):
            s = [s[e] + c * f[e] for e in loc]
            # dangling mass returns to each query's source (Section 2.1)
            dm = mesh.psum(torch.stack(
                [(f[e] * slabs.dangling[e][None, :]).sum(dim=1)
                 for e in loc]), "model")
            contrib = [_push_local(cfg, slabs.row_ptr[e], slabs.col_idx[e],
                                   slabs.edge_w[e], f[e]) for e in loc]
            if cfg.compress_k:
                # top-k per (query, owner bucket)
                buckets = [frontier_mod.topk_dense(x, cfg.compress_k)
                           for x in contrib]
                vals = wire_a2a(torch.stack([b[0] for b in buckets]))
                idx = mesh.all_to_all(torch.stack([b[1] for b in buckets]),
                                      "model")
                new_f = []
                for e in loc:
                    qi = rows[:, None, None].expand(vals[e].shape)
                    new_f.append(torch.zeros((qt, ns), dtype=torch.float32,
                                             device=dev).index_put_(
                        (qi.reshape(-1), idx[e].reshape(-1).long()),
                        vals[e].reshape(-1), accumulate=True))
            else:
                recv = wire_a2a(torch.stack(contrib))
                new_f = [recv[e].sum(dim=1) for e in loc]
            f = [(1.0 - c) * new_f[e] + (1.0 - c) * dm[:, None] * onehot[e]
                 for e in loc]

        # combine with the local index rows, chunked over local vertices so
        # the [qt, chunk, L] expansion stays bounded; columns are global, so
        # bucket by owner and exchange once
        v_chunk = min(65536, ns)
        contrib = []
        for e in loc:
            acc = torch.zeros((qt, cfg.n), dtype=torch.float32, device=dev)
            for v0 in range(0, ns, v_chunk):
                iv = index_vals[e][v0:v0 + v_chunk].to(torch.float32)
                ii = index_idx[e][v0:v0 + v_chunk]
                fw = f[e][:, v0:v0 + v_chunk, None] * iv[None, :, :]
                _add_columns(acc, ii.reshape(1, -1), fw.reshape(qt, -1))
            contrib.append(acc.reshape(qt, ep, ns))
        recv = wire_a2a(torch.stack(contrib))
        k = min(cfg.top_k, ns)
        lv, gi = [], []
        for e, me in enumerate(shards):
            v, i = frontier_mod.topk_dense(s[e] + recv[e].sum(dim=1), k)
            lv.append(v)
            gi.append(i + me * ns)
        return _gathered_topk(cfg, mesh, lv, gi)

    return step


def _make_verd_tile_step_sparse(cfg: DistConfig, mesh):
    """Sparse wire format: ``O(Q x shards x wire_k)`` bytes per iteration.

    Per shard and iteration: ``kernel_ops.sharded_frontier_push`` of the
    local ``[Q, K]`` slice (per-owner top-``wire_k`` buckets), one
    ``all_to_all``, then a dedup-merge and re-compaction of the received
    partials and the returning dangling mass to ``[Q, K]``.  ``s`` and the
    combine contributions stay sparse; only each shard's top-k is
    gathered.  Every dedup sums without atomics (``ordered``), so a tile's
    answers are the same bytes on every run and on every mesh.
    """
    if cfg.degree_cap <= 0:
        raise ValueError(
            "exchange='sparse' requires cfg.degree_cap > 0 (the max "
            "out-degree; resolve it host-side with "
            "repro_torch.core.verd.resolve_degree_cap)")
    ep, ns, c = cfg.ep, cfg.n_shard, cfg.c
    k_front = min(cfg.resolved_frontier_k, ns)   # a slice has <= ns columns
    kw = cfg.resolved_wire_k
    kc = cfg.resolved_combine_wire_k
    shards = mesh.local_model
    loc = range(len(shards))

    def wire_a2a(x):
        return mesh.all_to_all(x.to(cfg.wire_dtype), "model").to(
            torch.float32)

    def step(slabs: ShardedGraph, sources, index_vals, index_idx):
        dev = mesh.device
        hit, local = _stacked_sources(cfg, sources, dev, shards)
        qt = hit.shape[1]
        fv = [hit[e][:, None] for e in loc]
        fi = [local[e][:, None] for e in loc]
        s_vals = [[] for _ in loc]
        s_idxs = [[] for _ in loc]
        for _ in range(cfg.t_iterations):
            for e in loc:
                s_vals[e].append(c * fv[e])
                s_idxs[e].append(fi[e])
            # dangling mass returns to each query's source (Section 2.1)
            dm = mesh.psum(torch.stack(
                [(fv[e] * slabs.dangling[e][fi[e].long()]).sum(dim=1)
                 for e in loc]), "model")
            pushed = [kernel_ops.sharded_frontier_push(
                fv[e], fi[e], slabs.row_ptr[e], slabs.col_idx[e], c=c,
                degree_cap=cfg.degree_cap, ep=ep, n_shard=ns, wire_k=kw,
                hub_split_degree=cfg.hub_split_degree) for e in loc]
            bv = wire_a2a(torch.stack([p[0] for p in pushed]))
            bi = mesh.all_to_all(torch.stack([p[1] for p in pushed]), "model")
            for e in loc:
                cand_v = torch.cat([bv[e].reshape(qt, -1),
                                    ((1.0 - c) * dm * hit[e])[:, None]], 1)
                cand_i = torch.cat([bi[e].reshape(qt, -1),
                                    local[e][:, None]], 1)
                fv[e], fi[e] = frontier_mod.compact_arrays(
                    cand_v, cand_i, k_front, ordered=True)

        # index combine on the sparse slice: gather the K touched local
        # rows, bucket the (global-column) contributions by owner, exchange
        buckets = []
        for e in loc:
            rows = fi[e].long()
            iv = index_vals[e][rows].to(torch.float32)        # [qt, K, L]
            ii = index_idx[e][rows]
            contrib = (fv[e][..., None] * iv).reshape(qt, -1)
            buckets.append(frontier_mod.bucket_by_owner(
                contrib, ii.reshape(qt, -1), ep, ns, kc, ordered=True))
        cv = wire_a2a(torch.stack([b[0] for b in buckets]))
        ci = mesh.all_to_all(torch.stack([b[1] for b in buckets]), "model")

        # local entries: accumulated s + received combine partials (both
        # local ids), one compaction to the local top-k
        lv, gi = [], []
        for e, me in enumerate(shards):
            p_v = torch.cat(s_vals[e] + [cv[e].reshape(qt, -1)], dim=1)
            p_i = torch.cat(s_idxs[e] + [ci[e].reshape(qt, -1)], dim=1)
            v, i = frontier_mod.compact_arrays(p_v, p_i, cfg.top_k,
                                               ordered=True)
            lv.append(v)
            gi.append(i + me * ns)
        return _gathered_topk(cfg, mesh, lv, gi)

    return step


def exchange_bytes_per_iteration(cfg: DistConfig) -> Dict[str, float]:
    """Wire bytes one shard sends per VERD iteration, per exchange format:
    ``dense`` the ``[q_tile, n]`` slab in ``wire_dtype``, ``sparse``
    ``q_tile * ep * wire_k`` (value, int32 index) pairs; ``reduction`` is
    dense / sparse.  Computed from the config, not measured."""
    item = torch.empty((), dtype=cfg.wire_dtype).element_size()
    dense = float(cfg.q_tile * cfg.n * item)
    sparse = float(cfg.q_tile * cfg.ep * cfg.resolved_wire_k * (item + 4))
    return dict(dense=dense, sparse=sparse,
                reduction=dense / max(sparse, 1.0))


# ---------------------------------------------------------------------------
# offline indexing
# ---------------------------------------------------------------------------

def _walk_graph(row_ptr, col_idx, out_deg) -> Graph:
    """Wrap replicated CSR arrays for the walk engine, which never reads
    the COO ``src``: it is poisoned to -1 (a broadcast view, no memory)."""
    m = col_idx.shape[0]
    src = torch.full((1,), -1, dtype=torch.int32,
                     device=col_idx.device).expand(m)
    return Graph(row_ptr=row_ptr, col_idx=col_idx, src=src, out_deg=out_deg,
                 n=int(out_deg.shape[0]), m=int(m))


def _merge_sparse_counts(parts, mesh, l: int, axes):
    """Cross-shard sketch merge of the local shards' walk counts ``parts``
    (in mesh order along ``axes``): one gather of the ``[rows, l]``
    sketches along the width axis and one dedup-merge back to ``l``, the
    summed ``moves``, and the ``dropped`` ledger of every truncation, so
    ``fp_v.sum(1) + dropped == moves``."""
    av = mesh.all_gather(torch.stack([p.fp.values for p in parts]), axes)
    ai = mesh.all_gather(torch.stack([p.fp.indices for p in parts]), axes)
    moves = mesh.psum(torch.stack([p.moves for p in parts]), axes)
    fp_v, fp_i, dropped = frontier_mod.merge_sketch_parts(
        av, ai, mesh.psum(torch.stack([p.fp_dropped for p in parts]), axes),
        l)
    return fp_v, fp_i, moves, dropped


def make_walk_counts_step(cfg: DistConfig, mesh, *, max_steps: int = 64):
    """Returns ``fn(row_ptr, col_idx, out_deg, sources int32[W], rows
    int32[W], key) -> (fp_counts f32[q_tile, n], moves f32[q_tile])``.

    The graph arrays are whole on every shard.  The walks split into
    ``mesh.data`` contiguous blocks, one per data replica, whose stream
    folds the replica's index into every step key (``fold_in(fold_in(key,
    t), d)``).  Every (data, model) shard counts the visits of its block
    that land in its vertex interval into ``[q_tile, n_shard]``; the counts
    are summed over the data axis and laid side by side over the model
    axis, and ``moves`` is summed over every shard and divided by ``ep``,
    as the reference's psum does.  The model shards of one replica share
    its walks (their keys do not differ), so each block is walked once and
    counted by every local shard.  ``sources`` and ``rows`` hold the
    process's data blocks (the whole ``W`` on a ``ShardMesh``, which must
    split over ``mesh.data``; a rank's own block), and ``fp_counts`` its
    model shards' columns (``[q_tile, n_shard]`` on a rank).
    """
    _check_mesh(cfg, mesh)
    ep, ns = cfg.ep, cfg.n_shard
    blocks, shards = mesh.local_data, mesh.local_model

    def fn(row_ptr, col_idx, out_deg, sources, rows, key):
        if sources.shape[0] % len(blocks):
            raise ValueError(f"{sources.shape[0]} walks do not split over "
                             f"{len(blocks)} data shards")
        dev = sources.device
        w = sources.shape[0] // len(blocks)
        c32 = torch.tensor(cfg.c, dtype=torch.float32, device=dev)
        fp = torch.zeros((len(blocks), len(shards), cfg.q_tile, ns),
                         dtype=torch.float32, device=dev)
        moves = torch.zeros((len(blocks), len(shards), cfg.q_tile),
                            dtype=torch.float32, device=dev)
        for b, d in enumerate(blocks):
            src = sources[b * w:(b + 1) * w].to(torch.int32)
            rw = rows[b * w:(b + 1) * w].long()
            words = step_key_words(key, max_steps, dev, fold=d)
            cursors = src
            active = torch.ones((w,), dtype=torch.bool, device=dev)
            for t in range(max_steps):
                bits = rng.random_bits(words[t], (w,), dev)
                af = active.to(torch.float32)
                for p, me in enumerate(shards):
                    lo = me * ns
                    local = (cursors >= lo) & (cursors < lo + ns)
                    fp[b, p].index_put_(
                        (rw, torch.clamp(cursors - lo, 0, ns - 1).long()),
                        af * local.to(torch.float32), accumulate=True)
                    moves[b, p].index_put_((rw,), af, accumulate=True)
                active = active & ~(rng.bits_to_uniform(bits[0]) < c32)
                cursors = advance_walks(row_ptr, col_idx, out_deg, cursors,
                                        src, bits[1], bits[2])
        fp = mesh.psum(fp, "data")
        fp = fp.transpose(0, 1).reshape(cfg.q_tile, len(shards) * ns)
        moves = mesh.psum(moves.reshape(-1, cfg.q_tile),
                          ("data", "model")) / ep
        return fp, moves

    return fn


def make_sparse_walk_counts_step(cfg: DistConfig, mesh, *, r: int, l: int,
                                 max_steps: int = 64,
                                 compact_every: int = 8):
    """Returns ``fn(row_ptr, col_idx, out_deg, sources[rows], key) ->
    (fp_vals f32[rows, l], fp_idx int32[rows, l], moves, walks,
    dropped)``.

    The ``r`` walks of every source split evenly over every shard of the
    mesh (``r / size`` each, key folded with the shard's index along the
    data axis, then the model axis), then one sketch merge
    (:func:`_merge_sparse_counts`); ``walks`` is summed.  Requires ``r``
    divisible by the mesh size.  Every input and output is whole on every
    process; each walks its local shards.
    """
    n_model, n_data = mesh.model, mesh.data
    if r % (n_data * n_model) != 0:
        raise ValueError(
            f"r={r} must divide evenly over the {n_data * n_model} mesh "
            "shards")
    r_local = r // (n_data * n_model)

    def fn(row_ptr, col_idx, out_deg, sources, key):
        g = _walk_graph(row_ptr, col_idx, out_deg)
        parts = []
        for d in mesh.local_data:
            for md in mesh.local_model:
                shard_key = rng.fold_in(rng.fold_in(key, d), md)
                parts.append(simulate_walks_sparse(
                    g, sources, r_local, shard_key, l=l, ep_l=0, c=cfg.c,
                    max_steps=max_steps, compact_every=compact_every))
        axes = ("data", "model")
        fp_v, fp_i, moves, dropped = _merge_sparse_counts(parts, mesh, l,
                                                          axes)
        walks = mesh.psum(torch.stack([p.walks for p in parts]), axes)
        return fp_v, fp_i, moves, walks, dropped

    return fn


def _replica_chunk_estimates(g, sources, chunk_key, mesh, *, r_local: int,
                             l: int, sketch_l: int, touch_bits: int, **walk):
    """One source chunk on a rank that holds one data replica: its ``r /
    n_data`` walks under ``fold_in(chunk_key, d)``, the replicas' sketches
    merged over ``data`` and the Bloom filters OR-merged, then normalized
    and truncated to ``l``: ``index.sparse_chunk_estimates``'s outputs."""
    (d,) = mesh.local_data
    counts = simulate_walks_sparse(g, sources, r_local,
                                   rng.fold_in(chunk_key, d), l=sketch_l,
                                   ep_l=0, touch_bits=touch_bits, **walk)
    fp_v, fp_i, moves, dropped = _merge_sparse_counts([counts], mesh,
                                                      sketch_l, "data")
    out = normalize_sketch_to_index_rows(fp_v, fp_i, moves, dropped, l)
    if not touch_bits:
        return out
    touch = mesh.psum(counts.touch[None].to(torch.int32), "data") > 0
    return out + (touch,)


def make_sparse_index_build_step(
    cfg: DistConfig,
    mesh,
    *,
    r: int,
    l: int,
    sketch_l: int,
    real_n: int,
    max_steps: int = 64,
    compact_every: int = 8,
    source_batch: int = 256,
    respawn: bool = False,
    touch_bits: int = 0,
    chunk_start: int = 0,
    chunk_count: Optional[int] = None,
):
    """The whole offline index build on the mesh.

    Returns ``fn(row_ptr, col_idx, out_deg, key) -> (values f32[S, rows,
    l], indices int32[S, rows, l], kept f32[S, rows], dropped f32[S,
    rows])``, stacked over the process's model shards (``S = ep`` on a
    ``ShardMesh``, whose reshape to ``[ep * rows, ...]`` is the
    reference's ``P(model, None)`` rows in shard order; a rank's own shard,
    ``S = 1``), so no array of the step covers the whole ``[n, L]`` index:
    each model shard sweeps the source chunks ``[chunk_start, chunk_start
    + chunk_count)`` of its own vertex interval.  Each data replica runs
    ``r / n_data`` walks of a chunk (respawn mode when ``respawn``) under
    ``fold_in(chunk_key, s)`` (the chunk key itself for one replica), the
    sketches merge in replica order, and the rows are normalized and
    truncated to ``l``; pad vertices (``>= real_n``) get zero rows.  The
    chunk at global source offset ``o`` uses ``fold_in(key, o)``, the fold
    order of the single-device build.  A process that holds every replica
    (the stacked mesh) runs them as ``index.sparse_chunk_estimates`` with
    ``r_splits = n_data``, whose concatenation is the replicas' gather; a
    rank walks its own replica and merges the sketches through the mesh
    over ``data`` (:func:`_merge_sparse_counts`), as the reference's
    ``shard_map`` does, to the same bits.  Requires ``n_shard`` a multiple
    of ``source_batch`` and ``r`` of the replica count.  ``touch_bits > 0``
    appends a fifth output, the rows' walks-through Bloom filters
    ``bool[S, rows, touch_bits]`` OR-merged over the replicas, pad rows
    all False.
    """
    ns = cfg.n_shard
    n_split = mesh.data
    if r % n_split != 0:
        raise ValueError(
            f"r={r} must divide evenly over the {n_split} walk shards")
    if ns % source_batch != 0:
        raise ValueError(
            f"n_shard={ns} must be a multiple of source_batch={source_batch}")
    n_chunks = ns // source_batch
    if chunk_count is None:
        chunk_count = n_chunks - chunk_start
    if not (0 <= chunk_start and chunk_count >= 1
            and chunk_start + chunk_count <= n_chunks):
        raise ValueError(
            f"chunk range [{chunk_start}, {chunk_start + chunk_count}) "
            f"outside the [0, {n_chunks}) per-shard chunk grid")
    rows_out = chunk_count * source_batch
    shards = mesh.local_model
    replicas = mesh.local_data
    walk = dict(sketch_l=sketch_l, c=cfg.c, max_steps=max_steps,
                compact_every=compact_every, respawn=respawn,
                touch_bits=touch_bits)

    def chunk_estimates(g, sources, chunk_key):
        if len(replicas) == n_split:     # every replica in this process
            return sparse_chunk_estimates(g, sources, chunk_key, r=r, l=l,
                                          r_splits=n_split, **walk)
        return _replica_chunk_estimates(g, sources, chunk_key, mesh,
                                        r_local=r // n_split, l=l, **walk)

    def fn(row_ptr, col_idx, out_deg, key):
        g = _walk_graph(row_ptr, col_idx, out_deg)
        dev = g.device
        values = torch.empty((len(shards), rows_out, l), dtype=torch.float32,
                             device=dev)
        indices = torch.empty((len(shards), rows_out, l), dtype=torch.int32,
                              device=dev)
        kept_all = torch.empty((len(shards), rows_out), dtype=torch.float32,
                               device=dev)
        dropped_all = torch.empty_like(kept_all)
        touch_all = (torch.empty((len(shards), rows_out, touch_bits),
                                 dtype=torch.bool, device=dev)
                     if touch_bits else None)
        for p, me in enumerate(shards):
            for j in range(chunk_start, chunk_start + chunk_count):
                offset = me * ns + j * source_batch
                sources = offset + torch.arange(source_batch,
                                                dtype=torch.int32, device=dev)
                est = chunk_estimates(g, sources, rng.fold_in(key, offset))
                vals, idxs, kept, dropped_est = est[:4]
                # pad vertices walked in place: no phantom mass in the index
                real = (sources < real_n)
                o = (j - chunk_start) * source_batch
                out = (p, slice(o, o + source_batch))
                values[out] = torch.where(real[:, None], vals, 0.0)
                indices[out] = torch.where(real[:, None], idxs, 0)
                kept_all[out] = torch.where(real, kept, 0.0)
                dropped_all[out] = torch.where(real, dropped_est, 0.0)
                if touch_bits:
                    touch_all[out] = est[4] & real[:, None]
        if touch_bits:
            return values, indices, kept_all, dropped_all, touch_all
        return values, indices, kept_all, dropped_all

    return fn


# ---------------------------------------------------------------------------
# Contract-auditor entry point (repro_torch.analysis): the sharded build's
# step on a 2 x 2 mesh stacked on one device returns its rows stacked per
# model shard, and no array of its run covers the full [n, L] index — the
# index stays model-sharded, never replicated.  The graph and shapes are
# the reference's; a stacked mesh needs no forced device split.
# ---------------------------------------------------------------------------

from repro_torch.analysis.registry import register_entry_point as _register_ep


def _contract_spec_sharded_build_step(device):
    from repro_torch.analysis.trace import record
    from repro_torch.distributed import ShardMesh
    from repro_torch.graphs import synthetic

    mesh = ShardMesh(data=2, model=2, device=device)
    g = synthetic.erdos_renyi(64, 4.0, seed=21, device=device)
    cfg = DistConfig(n=64, ep=2)
    l = 16
    step = make_sparse_index_build_step(
        cfg, mesh, r=64, l=l, sketch_l=48, real_n=64, source_batch=16,
    )
    out, records = record(step, g.row_ptr, g.col_idx, g.out_deg,
                          rng.prng_key(3))
    return dict(records=records, outputs=[tuple(o.shape) for o in out],
                n=cfg.n, l=l, shards=cfg.ep)


_register_ep("sparse-index-build-step", "no-replicated-index",
             "src/repro_torch/core/distributed_engine.py",
             _contract_spec_sharded_build_step)
