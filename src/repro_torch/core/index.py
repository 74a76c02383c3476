"""The PPR index: top-L truncated MCFP fingerprints of every vertex.

``values f32[n, L]`` (descending within a row, 0-padded) + ``indices
int32[n, L]`` on the device, built by streaming source chunks through the
sparse walk engine (``repro.core.index.build_index(engine="sparse")``):
same chunk padding, ``sketch_l = min(n, max(2l, l+32))``, per-chunk key
``fold_in(key, chunk_offset)`` and stats, so a build from the same key
equals the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

    @property
    def nbytes(self) -> int:
        return self.n * self.l * 8

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
) -> Tuple[torch.Tensor, ...]:
    """One source chunk of the build: walk at sketch width ``sketch_l``,
    normalize, truncate to ``l``.  Returns ``(vals, idxs, kept, dropped)``
    left on the device.  Only ``r_splits=1`` is ported."""
    if r_splits != 1:
        raise NotImplementedError(
            "r_splits > 1 (the sharded builder's walk split) is not ported "
            "yet; see ROADMAP.md"
        )
    counts = simulate_walks_sparse(
        graph, chunk_sources, r, key, l=sketch_l, ep_l=0, c=c,
        max_steps=max_steps, compact_every=compact_every,
    )
    return normalize_sketch_to_index_rows(
        counts.fp.values, counts.fp.indices, counts.moves,
        counts.fp_dropped, l,
    )


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
    device="cuda",
) -> Tuple[PPRIndex, dict]:
    """Offline preprocessing: MCFP for every vertex, truncated to top-L.

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
    sketch_l = min(n, max(2 * l, l + 32))
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
            r_splits=r_splits,
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
        respawn=False,
        source_batch=source_batch,
        pad_rows=pad_rows,
        pad_fraction=pad_rows / max(n_src + pad_rows, 1),
        kept_mass=kept,
        dropped_mass=dropped,
        drop_fraction=dropped / max(kept + dropped, 1e-12),
        nbytes=n * l * 8,
        duplicate_sources=duplicate_sources,
    )
    return PPRIndex(values=values, indices=indices, l=l, n=n), stats
