"""The PPR index: top-L truncated MCFP fingerprints of every vertex.

``values f32[n, L]`` (descending within a row, 0-padded) + ``indices
int32[n, L]`` on the device, built by streaming source chunks through the
sparse walk engine (``repro.core.index.build_index(engine="sparse")``):
same chunk padding, ``sketch_l = min(n, max(2l, l+32))``, per-chunk key
``fold_in(key, chunk_offset)`` and stats, so a build from the same key
equals the reference's bit for bit.  :func:`build_index_sharded` builds
the same rows on a :class:`~repro_torch.distributed.mesh.ShardMesh`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import frontier
from repro_torch.core.graph import Graph
from repro_torch.core.walks import DEFAULT_C, simulate_walks_sparse
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PPRIndex:
    """Top-L truncated PPR fingerprints for every vertex."""

    values: torch.Tensor
    indices: torch.Tensor
    l: int
    n: int
    # derived views built once per index (``columns``); not part of equality
    _views: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @property
    def nbytes(self) -> int:
        return self.n * self.l * 8

    def columns(self, nv: int, n: int):
        """The transposed view of rows ``[0, nv)`` over output columns
        ``[0, n)`` (``kernels.index_combine.index_columns``), built on
        first use and kept for the index's lifetime: the dense
        ``index_combine`` kernel pulls every output entry through it in a
        fixed order.  At rmat(20), L = 256 it holds ~1 GiB and its build
        is one device sort of the index's nonzero entries."""
        from repro_torch.kernels.index_combine import index_columns

        view = self._views.get(("columns", nv, n))
        if view is None:
            view = self._views[("columns", nv, n)] = index_columns(
                self.values[:nv], self.indices[:nv], n)
        return view

    def lookup_dense(self, vertices: torch.Tensor) -> torch.Tensor:
        """Densify rows: ``f32[len(vertices), n]`` (the FPPR answer)."""
        rows = vertices.long()
        vals, idxs = self.values[rows], self.indices[rows]
        out = torch.zeros((rows.shape[0], self.n), dtype=vals.dtype,
                          device=vals.device)
        return out.scatter_add_(1, idxs.long(), vals)

    def to(self, device) -> "PPRIndex":
        dev = resolve_device(device)
        if self.values.device.type == dev.type and dev.index in (
            None, self.values.device.index
        ):
            return self
        return PPRIndex(values=self.values.to(dev),
                        indices=self.indices.to(dev), l=self.l, n=self.n)


def truncate_topl(estimates: torch.Tensor, l: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-``l`` entries of each dense row (``lax.top_k``'s
    order); negative values clamp to 0 and zero slots point at vertex 0."""
    vals, idxs = frontier.topk_dense(estimates, l)
    vals = torch.clamp(vals, min=0.0)
    return vals, torch.where(vals > 0, idxs, 0).to(torch.int32)


def index_from_dense(estimates: torch.Tensor, l: int) -> "PPRIndex":
    """An index from precomputed dense vectors (tests and baselines)."""
    vals, idxs = truncate_topl(estimates, l)
    return PPRIndex(values=vals, indices=idxs, l=l,
                    n=int(estimates.shape[1]))


def normalize_sketch_to_index_rows(fp_v, fp_i, moves, dropped_counts, l: int):
    """Sketch counts -> index rows: divide by the move count, slice to
    width ``l``.  Returns ``(vals, idxs, kept, dropped)`` in estimate
    units (kept/dropped per row)."""
    inv_moves = 1.0 / torch.clamp(moves[:, None], min=1.0)
    est_v = fp_v * inv_moves
    vals, idxs = est_v[:, :l], fp_i[:, :l]
    idxs = torch.where(vals > 0, idxs, 0)
    kept = vals.sum(dim=1)
    dropped = est_v[:, l:].sum(dim=1) + dropped_counts * inv_moves[:, 0]
    return vals, idxs, kept, dropped


def _sketch_width(n: int, l: int) -> int:
    """Walk sketch width of a build truncating to ``l``."""
    return min(n, max(2 * l, l + 32))


def _mass_stats(kept: float, dropped: float) -> dict:
    return dict(kept_mass=kept, dropped_mass=dropped,
                drop_fraction=dropped / max(kept + dropped, 1e-12))


def sparse_chunk_estimates(
    graph: Graph,
    chunk_sources: torch.Tensor,
    key,
    *,
    r: int,
    l: int,
    sketch_l: int,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    compact_every: int = 8,
    r_splits: int = 1,
    respawn: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """One source chunk of the build: walk at sketch width ``sketch_l``,
    normalize, truncate to ``l``.  Returns ``(vals, idxs, kept, dropped)``
    left on the device.

    ``r_splits > 1`` runs ``r / r_splits`` walks per sub-pass under keys
    ``fold_in(key, split)`` and dedup-merges the sketches in split order
    (``frontier.merge_sketch_parts``): the sharded builder's fold order, so
    this build at ``r_splits`` equal to the data-axis size reproduces
    :func:`build_index_sharded` row for row.  ``respawn`` selects
    respawn-mode scheduling (``walks.respawn_schedule``)."""
    if r % r_splits != 0:
        raise ValueError(f"r={r} must divide over r_splits={r_splits}")
    walk = dict(l=sketch_l, ep_l=0, c=c, max_steps=max_steps,
                compact_every=compact_every, respawn=respawn)
    if r_splits == 1:
        counts = simulate_walks_sparse(graph, chunk_sources, r, key, **walk)
        fp_v, fp_i = counts.fp.values, counts.fp.indices
        moves, dropped = counts.moves, counts.fp_dropped
    else:
        parts = [simulate_walks_sparse(graph, chunk_sources, r // r_splits,
                                       rng.fold_in(key, s), **walk)
                 for s in range(r_splits)]
        moves = torch.zeros((chunk_sources.shape[0],), dtype=torch.float32,
                            device=graph.device)
        dropped = torch.zeros_like(moves)
        for p in parts:
            moves = moves + p.moves
            dropped = dropped + p.fp_dropped
        fp_v, fp_i, dropped = frontier.merge_sketch_parts(
            torch.cat([p.fp.values for p in parts], dim=1),
            torch.cat([p.fp.indices for p in parts], dim=1),
            dropped, sketch_l,
        )
    return normalize_sketch_to_index_rows(fp_v, fp_i, moves, dropped, l)


def build_index(
    graph: Graph,
    r: int,
    l: int,
    key,
    *,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    source_batch: int = 256,
    sources: Optional[np.ndarray] = None,
    engine: str = "sparse",
    compact_every: int = 8,
    r_splits: int = 1,
    respawn: bool = False,
    device="cuda",
) -> Tuple[PPRIndex, dict]:
    """Offline preprocessing: MCFP for every vertex, truncated to top-L.

    ``r_splits``/``respawn`` select the sharded builder's per-chunk walk
    split and respawn-mode scheduling (:func:`sparse_chunk_estimates`).
    ``key`` is a port PRNG key (:func:`repro_torch.rng.prng_key`).  The
    graph moves to ``device`` (default ``"cuda"``; pass ``"cpu"`` for the
    plain path).  Duplicate ``sources`` are deduplicated up front
    (``stats["duplicate_sources"]``).  Returns ``(index, stats)``; stats
    carry the kept/dropped estimate mass, synced once at the end.
    """
    if engine != "sparse":
        raise NotImplementedError(
            f"engine={engine!r}: only the sparse engine is ported; the "
            "legacy engine draws with jax.random.randint, which waits for "
            "a bit-exact counterpart in repro_torch/rng.py (ROADMAP.md "
            "queue 1)"
        )
    graph = graph.to(device)
    dev = graph.device
    n = graph.n
    l = min(l, n)
    if sources is None:
        sources = np.arange(n, dtype=np.int32)
        duplicate_sources = 0
    else:
        sources = np.asarray(sources, dtype=np.int32)
        unique_sources = np.unique(sources)
        duplicate_sources = len(sources) - len(unique_sources)
        sources = unique_sources
    sketch_l = _sketch_width(n, l)
    n_src = len(sources)
    pad_rows = (-n_src) % source_batch
    padded = np.concatenate(
        [sources, np.zeros(pad_rows, np.int32)]
    ) if pad_rows else sources
    n_chunks = len(padded) // source_batch
    padded_dev = torch.from_numpy(padded).to(dev)

    vals_chunks, idxs_chunks, kept_parts, dropped_parts = [], [], [], []
    for ci in range(n_chunks):
        i = ci * source_batch
        chunk = padded_dev[i:i + source_batch]
        real = min(source_batch, n_src - i)
        vals, idxs, kept, dropped = sparse_chunk_estimates(
            graph, chunk, rng.fold_in(key, i), r=r, l=l, sketch_l=sketch_l,
            c=c, max_steps=max_steps, compact_every=compact_every,
            r_splits=r_splits, respawn=respawn,
        )
        vals_chunks.append(vals[:real])
        idxs_chunks.append(idxs[:real])
        kept_parts.append(kept[:real].sum())
        dropped_parts.append(dropped[:real].sum())

    if not n_src:
        values = torch.zeros((n, l), dtype=torch.float32, device=dev)
        indices = torch.zeros((n, l), dtype=torch.int32, device=dev)
    elif n_src == n and np.array_equal(sources, np.arange(n, dtype=np.int32)):
        values = torch.cat(vals_chunks, dim=0)
        indices = torch.cat(idxs_chunks, dim=0)
    else:  # subset build: one scatter into the zero index
        rows = torch.from_numpy(sources).to(dev).long()
        values = torch.zeros((n, l), dtype=torch.float32, device=dev)
        values[rows] = torch.cat(vals_chunks, dim=0)
        indices = torch.zeros((n, l), dtype=torch.int32, device=dev)
        indices[rows] = torch.cat(idxs_chunks, dim=0)
    if kept_parts:
        kept = float(torch.stack(kept_parts).sum())
        dropped = float(torch.stack(dropped_parts).sum())
    else:
        kept = dropped = 0.0
    stats = dict(
        r=r,
        l=l,
        engine="sparse",
        sketch_l=sketch_l,
        r_splits=r_splits,
        respawn=bool(respawn),
        source_batch=source_batch,
        pad_rows=pad_rows,
        pad_fraction=pad_rows / max(n_src + pad_rows, 1),
        **_mass_stats(kept, dropped),
        nbytes=n * l * 8,
        duplicate_sources=duplicate_sources,
    )
    return PPRIndex(values=values, indices=indices, l=l, n=n), stats


def build_index_sharded(
    graph: Graph,
    r: int,
    l: int,
    key,
    *,
    mesh,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    source_batch: int = 256,
    compact_every: int = 8,
    respawn: bool = True,
    touch_bits: int = 0,
    checkpoint_dir: Optional[str] = None,
) -> Tuple[PPRIndex, dict]:
    """The full-index build on a :class:`~repro_torch.distributed.mesh
    .ShardMesh` (``distributed_engine.make_sparse_index_build_step``).

    Sources shard over the model axis (each shard sweeps the chunks of its
    own vertex interval), walks split over the batch axes (``r / n_data``
    per replica, sketches merged by one gather).  Chunk at global offset
    ``o`` uses ``fold_in(key, o)`` and replica ``s`` folds ``s`` on top:
    :func:`build_index` with ``r_splits = n_data`` over the same chunk
    grid gives the same rows.  The vertex count pads up to ``ep`` shards
    of a multiple of ``source_batch`` (clamped, with a warning, to the
    shard interval); pad vertices are dangling, their rows zeroed, and the
    index has ``n = n_pad``.  Runs on the mesh's device.

    Not ported: checkpointed builds (``checkpoint_dir``) and ``touch_bits``
    (the Bloom filters of incremental repair), ROADMAP.md queue 1.
    """
    from repro_torch.core.distributed_engine import (
        DistConfig, make_sparse_index_build_step)

    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointed sharded builds are not ported yet; see ROADMAP.md "
            "queue 1, checkpointed builds")
    if touch_bits:
        raise NotImplementedError(
            "touch_bits (the Bloom filters of incremental repair) is not "
            "ported yet; see ROADMAP.md queue 1, touch filters and repair")
    ep, n_split = mesh.model, mesh.data
    if r % n_split != 0:
        raise ValueError(
            f"r={r} must divide evenly over the {n_split} walk shards")
    graph = graph.to(mesh.device)
    n = graph.n
    l = min(l, n)
    sketch_l = _sketch_width(n, l)
    ns = -(-n // ep)
    if source_batch > ns:
        warnings.warn(
            f"source_batch={source_batch} exceeds the per-shard interval; "
            f"clamped to {ns} — single-device parity comparisons must use "
            "the effective batch from stats['source_batch']",
            stacklevel=2,
        )
    source_batch = max(1, min(source_batch, ns))
    ns = -(-ns // source_batch) * source_batch
    n_pad = ns * ep
    cfg = DistConfig(n=n_pad, ep=ep, c=c)
    pad = n_pad - n
    row_ptr, out_deg = graph.row_ptr, graph.out_deg
    if pad:  # pad vertices are dangling: they walk in place
        row_ptr = torch.cat([row_ptr, row_ptr[-1:].expand(pad)])
        out_deg = torch.cat([out_deg, torch.zeros(
            pad, dtype=out_deg.dtype, device=out_deg.device)])
    step = make_sparse_index_build_step(
        cfg, mesh, r=r, l=l, sketch_l=sketch_l, real_n=n,
        max_steps=max_steps, compact_every=compact_every,
        source_batch=source_batch, respawn=respawn,
    )
    values, indices, kept_rows, dropped_rows = step(
        row_ptr, graph.col_idx, out_deg, key)
    kept = float(kept_rows.sum())
    dropped = float(dropped_rows.sum())
    stats = dict(
        r=r,
        l=l,
        engine="sparse-sharded",
        sketch_l=sketch_l,
        r_splits=n_split,
        respawn=bool(respawn),
        n=n,
        n_pad=n_pad,
        shards=ep,
        source_batch=source_batch,
        pad_rows=pad,
        pad_fraction=pad / max(n_pad, 1),
        duplicate_sources=0,
        **_mass_stats(kept, dropped),
        nbytes=n_pad * l * 8,
    )
    return PPRIndex(values=values, indices=indices, l=l, n=n_pad), stats
