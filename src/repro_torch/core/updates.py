"""Incremental index maintenance for evolving graphs.

Rebuilding the whole fingerprint index per edge batch resamples ``n * R /
c`` walk positions.  Each row is an independent Monte-Carlo sketch, so an
edge update only invalidates the rows whose walks could have crossed a
touched vertex.  This module finds that set and repairs only it, as
``repro.core.updates`` does:

* **Invalidation.**  :func:`build_maintainable_index` records each row's
  walks-through Bloom filter over every counted walk position
  (``walks.simulate_walks_sparse(touch_bits=...)``).  A walk only steps
  *from* counted positions, so a row whose filter misses every touched
  vertex re-simulates bit-identically on the updated graph.  The dirty
  set is the filter hits plus the touched sources; the filters are
  queried on the device (:meth:`TouchSketch.dirty_rows`).
* **Repair granularity.**  A row's random stream depends on its position
  in its build chunk (the uniforms are drawn ``[rows, w]`` from
  ``fold_in(key, chunk_offset)``), so repair recomputes whole chunks of
  the build's grid with the build's keys
  (:func:`repro_torch.core.index.sparse_chunk_estimates`): the repaired
  index equals a rebuild on the mutated graph bit for bit, on the
  single-device grid and on the sharded one alike.
* **Accounting.**  Work is counted in resampled walk positions, chunk
  slots swept times ``r / c``, the unit of
  ``index.preprocessing_cost_model``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import index as index_mod
from repro_torch.core import walks as walks_mod
from repro_torch.core.graph import Graph, _edge_pairs, apply_edge_updates
from repro_torch.core.index import (PPRIndex, build_index,
                                    build_index_sharded,
                                    sparse_chunk_estimates)
from repro_torch.distributed.checkpoint import deserialize_key

DEFAULT_C = walks_mod.DEFAULT_C


def default_touch_bits(r: int, c: float = DEFAULT_C) -> int:
    """Bloom width for ``r`` walks a row: a filter holds about ``r / c``
    distinct positions under ``TOUCH_HASHES`` hashes, so ``~256 * r`` bits
    keep the false-positive rate a (row, vertex) near 1e-4.  A power of
    two in ``[1024, 65536]``."""
    bits = 1024
    while bits < 256 * max(r, 1) and bits < 65536:
        bits *= 2
    return bits


@dataclasses.dataclass(frozen=True)
class TouchSketch:
    """Per-row walks-through Bloom filters: ``bits bool[rows, n_bits]``."""

    bits: torch.Tensor
    hashes: int = walks_mod.TOUCH_HASHES

    @property
    def rows(self) -> int:
        return int(self.bits.shape[0])

    @property
    def n_bits(self) -> int:
        return int(self.bits.shape[1])

    @property
    def nbytes(self) -> int:
        return self.rows * self.n_bits  # bool storage

    def dirty_rows(self, touched) -> np.ndarray:
        """Sorted int64 ids of the rows whose filter holds *any* touched
        vertex, queried where the filters live.  No false negatives: a
        row missing from the result is bit-stable under the update."""
        t = np.unique(np.asarray(touched, np.int64).reshape(-1))
        if t.size == 0:
            return np.zeros(0, dtype=np.int64)
        dev = self.bits.device
        hb = walks_mod.touch_hash_bits(
            torch.from_numpy(t).to(dev), self.n_bits, self.hashes).long()
        dirty = torch.zeros(self.rows, dtype=torch.bool, device=dev)
        # chunk the touched set so the [rows, chunk, k] gather stays small
        chunk = max(1, (1 << 22) // max(self.rows, 1))
        for i in range(0, t.size, chunk):
            dirty |= self.bits[:, hb[i:i + chunk]].all(dim=2).any(dim=1)
        return torch.nonzero(dirty).reshape(-1).cpu().numpy().astype(
            np.int64)

    def replace_rows(self, rows, new_bits: torch.Tensor) -> "TouchSketch":
        """A copy with the rows ``rows`` replaced (as
        ``PPRIndex.replace_rows``)."""
        b = self.bits.clone()
        b[torch.as_tensor(rows, device=b.device).long()] = new_bits.to(b)
        return TouchSketch(bits=b, hashes=self.hashes)


@dataclasses.dataclass(frozen=True)
class BuildParams:
    """Everything a repair needs to replay the build's chunk grid."""

    r: int
    l: int
    sketch_l: int
    c: float
    max_steps: int
    compact_every: int
    source_batch: int
    r_splits: int
    respawn: bool
    engine: str          # "sparse" | "sparse-sharded"


@dataclasses.dataclass(frozen=True)
class MaintainableIndex:
    """A ``PPRIndex`` with what repair needs: the build key (``int64[2]``),
    the chunk-grid parameters and the rows' touch sketch."""

    index: PPRIndex
    touch: TouchSketch
    key: torch.Tensor
    params: BuildParams
    real_n: int          # graph vertices (index.n may be padded above it)

    @property
    def n_chunks(self) -> int:
        sb = self.params.source_batch
        grid_n = self.index.n if self.params.engine == "sparse-sharded" \
            else self.real_n
        return -(-grid_n // sb)


def _params_from_stats(stats: dict, r: int, c: float, max_steps: int,
                       compact_every: int) -> BuildParams:
    return BuildParams(
        r=int(r), l=int(stats["l"]), sketch_l=int(stats["sketch_l"]),
        c=float(c), max_steps=int(max_steps),
        compact_every=int(compact_every),
        source_batch=int(stats["source_batch"]),
        r_splits=int(stats["r_splits"]), respawn=bool(stats["respawn"]),
        engine=str(stats["engine"]),
    )


def build_maintainable_index(
    graph: Graph,
    r: int,
    l: int,
    key,
    *,
    touch_bits: int = 0,
    mesh=None,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    source_batch: int = 256,
    compact_every: int = 8,
    r_splits: int = 1,
    respawn: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 8,
    resume: bool = False,
    checkpoint_keep: int = 3,
    fault_plan=None,
    device="cuda",
) -> Tuple[MaintainableIndex, dict]:
    """A full-sweep build that also records the maintenance state.

    On one device (``mesh=None``: :func:`~repro_torch.core.index
    .build_index` on ``device``) or on a ``ShardMesh`` (:func:`~repro_torch
    .core.index.build_index_sharded` on the mesh's device; ``r_splits`` is
    then the mesh's data axis).  ``touch_bits=0`` sizes the filters from
    ``r`` (:func:`default_touch_bits`).  The checkpoint arguments make the
    build crash-safe; the filters ride in every commit, so
    :func:`load_maintainable_index` reloads an index that repairs as the
    returned one does.  Returns ``(maintainable, stats)``, the filters
    moved out of ``stats``.
    """
    if touch_bits <= 0:
        touch_bits = default_touch_bits(r, c)
    ckpt_kwargs = dict(
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        resume=resume, checkpoint_keep=checkpoint_keep,
        fault_plan=fault_plan,
    )
    if mesh is None:
        index, stats = build_index(
            graph, r, l, key, c=c, max_steps=max_steps,
            source_batch=source_batch, engine="sparse",
            compact_every=compact_every, r_splits=r_splits,
            respawn=respawn, touch_bits=touch_bits, device=device,
            **ckpt_kwargs,
        )
    else:
        index, stats = build_index_sharded(
            graph, r, l, key, mesh=mesh, c=c, max_steps=max_steps,
            source_batch=source_batch, compact_every=compact_every,
            respawn=respawn, touch_bits=touch_bits, **ckpt_kwargs,
        )
    touch = TouchSketch(bits=stats.pop("touch"))
    params = _params_from_stats(stats, r, c, max_steps, compact_every)
    m = MaintainableIndex(index=index, touch=touch,
                          key=rng.key_data(key).cpu(), params=params,
                          real_n=graph.n)
    return m, stats


def _maintainable_from_tree(tree: dict, extra: dict, device,
                            checkpoint_dir: str
                            ) -> Tuple[MaintainableIndex, dict]:
    index, stats = index_mod._index_from_tree(tree, extra, device)
    if "touch" not in stats:
        raise ValueError(
            f"checkpoint under {checkpoint_dir} has no touch sketch: not a "
            "maintainable-index build")
    sig = extra["signature"]
    params = _params_from_stats(
        dict(sig, l=stats["l"], engine=stats["engine"]), r=sig["r"],
        c=sig["c"], max_steps=sig["max_steps"],
        compact_every=sig["compact_every"])
    m = MaintainableIndex(
        index=index, touch=TouchSketch(bits=stats.pop("touch")),
        key=deserialize_key(sig["key"]), params=params, real_n=int(sig["n"]))
    return m, stats


def load_maintainable_index(checkpoint_dir: str, device="cuda"
                            ) -> Tuple[MaintainableIndex, dict]:
    """A :class:`MaintainableIndex` from the *complete* step of a
    checkpointed maintainable build, on ``device``, without a walk: the
    step holds the rows and the filters, and its build signature the key
    and the chunk grid, so the reloaded index repairs bit-identically to
    the one the build returned.  A build without filters raises
    ``ValueError``."""
    tree, extra = index_mod._restore_complete(checkpoint_dir)
    return _maintainable_from_tree(tree, extra, device, checkpoint_dir)


def plan_repair(m: MaintainableIndex, touched_sources) -> dict:
    """Invalidation plan for a touched-source set: the dirty rows (filter
    hits and the touched sources) and the build-grid chunks covering
    them."""
    touched = np.unique(np.asarray(touched_sources, np.int64).reshape(-1))
    touched = touched[(touched >= 0) & (touched < m.real_n)]
    dirty = m.touch.dirty_rows(touched)
    dirty = np.union1d(dirty, touched)
    dirty = dirty[dirty < m.real_n]
    sb = m.params.source_batch
    chunks = np.unique(dirty // sb) if dirty.size else np.zeros(0, np.int64)
    return dict(
        touched=touched,
        dirty_rows=dirty,
        chunks=chunks,
        n_chunks_total=m.n_chunks,
    )


def _padded_walk_graph(graph: Graph, n_pad: int) -> Graph:
    """The graph padded to the sharded index's vertex count with dangling
    vertices, as ``build_index_sharded`` pads its CSR arrays."""
    pad = n_pad - graph.n
    if pad == 0:
        return graph
    row_ptr = torch.cat([graph.row_ptr, graph.row_ptr[-1:].expand(pad)])
    out_deg = torch.cat([graph.out_deg, torch.zeros(
        pad, dtype=graph.out_deg.dtype, device=graph.device)])
    return Graph(row_ptr=row_ptr, col_idx=graph.col_idx, src=graph.src,
                 out_deg=out_deg, n=n_pad, m=graph.m)


def apply_updates(
    m: MaintainableIndex,
    graph: Graph,
    inserts=None,
    deletes=None,
) -> Tuple[Graph, MaintainableIndex, dict]:
    """Apply an edge-update batch and repair exactly the dirtied rows.

    ``graph`` must be the graph ``m`` was built (or last repaired) on; the
    repair runs on its device.  Returns ``(new_graph, new_maintainable,
    report)`` and changes neither input.  ``report["dirty_row_ids"]`` is
    the vertex set an answer cache must invalidate; ``resampled_*`` and
    ``rebuild_*`` count walk positions.
    """
    if graph.n != m.real_n:
        raise ValueError(
            f"graph has {graph.n} vertices but the index was built on "
            f"{m.real_n}")
    new_graph, touched = apply_edge_updates(graph, inserts, deletes)
    plan = plan_repair(m, touched)
    p = m.params
    sb = p.source_batch
    # every swept chunk slot expects r / c counted positions; a rebuild
    # sweeps the whole grid, pad slots included
    pos_per_slot = p.r / p.c
    resampled_slots = int(len(plan["chunks"])) * sb
    rebuild_slots = plan["n_chunks_total"] * sb
    report = dict(
        edges_inserted=len(_edge_pairs(inserts)),
        edges_deleted=len(_edge_pairs(deletes)),
        touched_sources=int(plan["touched"].size),
        dirty_rows=int(plan["dirty_rows"].size),
        dirty_row_ids=plan["dirty_rows"],
        repaired_chunks=int(len(plan["chunks"])),
        total_chunks=int(plan["n_chunks_total"]),
        resampled_positions=resampled_slots * pos_per_slot,
        rebuild_positions=rebuild_slots * pos_per_slot,
        resample_ratio=rebuild_slots / max(resampled_slots, 1),
    )
    if not len(plan["chunks"]):
        return new_graph, m, report

    dev = new_graph.device
    walk_g = _padded_walk_graph(new_graph, m.index.n)
    sharded = p.engine == "sparse-sharded"
    rows_parts, vals_parts, idxs_parts, touch_parts = [], [], [], []
    for chunk in plan["chunks"]:
        start = int(chunk) * sb
        if sharded:
            # the sharded grid covers the padded vertex range: pad rows
            # are swept (their slot positions matter), then zeroed
            real = sb
            src = torch.arange(start, start + sb, dtype=torch.int32,
                               device=dev)
        else:
            # the single-device grid pads its ragged tail with source 0
            real = min(sb, m.real_n - start)
            src = torch.zeros(sb, dtype=torch.int32, device=dev)
            src[:real] = torch.arange(start, start + real,
                                      dtype=torch.int32, device=dev)
        vals, idxs, _, _, touch = sparse_chunk_estimates(
            walk_g, src, rng.fold_in(m.key, start), r=p.r, l=p.l,
            sketch_l=p.sketch_l, c=p.c, max_steps=p.max_steps,
            compact_every=p.compact_every, r_splits=p.r_splits,
            respawn=p.respawn, touch_bits=m.touch.n_bits,
        )
        if sharded:
            realm = (src < m.real_n)[:, None]
            vals = torch.where(realm, vals, 0.0)
            idxs = torch.where(realm, idxs, 0)
            touch = touch & realm
        rows_parts.append(np.arange(start, start + real, dtype=np.int64))
        vals_parts.append(vals[:real])
        idxs_parts.append(idxs[:real])
        touch_parts.append(touch[:real])

    rows = np.concatenate(rows_parts)
    new_index = m.index.replace_rows(
        rows, torch.cat(vals_parts), torch.cat(idxs_parts))
    new_touch = m.touch.replace_rows(rows, torch.cat(touch_parts))
    new_m = MaintainableIndex(index=new_index, touch=new_touch, key=m.key,
                              params=p, real_n=m.real_n)
    report["rows_replaced"] = int(rows.size)
    return new_graph, new_m, report
