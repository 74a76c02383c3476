"""The PPR index: top-L truncated MCFP fingerprints of every vertex.

``values f32[n, L]`` (descending within a row, 0-padded) + ``indices
int32[n, L]`` on the device, built by streaming source chunks through the
sparse walk engine (``repro.core.index.build_index(engine="sparse")``):
same chunk padding, ``sketch_l = min(n, max(2l, l+32))``, per-chunk key
``fold_in(key, chunk_offset)`` and stats, so a build from the same key
equals the reference's bit for bit.  ``engine="legacy"`` keeps the dense
MCFP oracle (``mcfp.estimate_ppr_batched`` truncated to top-L).
:func:`build_index_sharded` builds the sparse rows on a
:class:`~repro_torch.distributed.mesh.ShardMesh`, or a rank's own shard of
them on a :class:`~repro_torch.distributed.mesh.RankMesh`: a
:class:`RankIndex`, whose leader gathers the rows a query touches from the
model shards that own them (:meth:`RankIndex.gather`).

Both sparse builds can record each row's walks-through Bloom filter
(``touch_bits``, the invalidation sketch of ``core/updates.py``) and can
be crash-safe: with ``checkpoint_dir`` they commit their partial rows,
ledger and filters every ``checkpoint_every`` chunks
(:class:`~repro_torch.distributed.checkpoint.Checkpointer`, the
reference's on-disk layout and build signature), and ``resume=True``
continues from the newest committed step bit for bit.
:func:`load_index_checkpoint` boots a finished build without walking.

The memory planner (:func:`plan_for_budget`, :func:`walk_state_cost`,
:func:`preprocessing_cost_model`) is the paper's offline/online knob:
"the computation can be shifted to the offline stage as much as the
memory budget allows".
"""

from __future__ import annotations

import dataclasses
import warnings
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import frontier, mcfp
from repro_torch.core.graph import Graph, graph_fingerprint
from repro_torch.core.walks import (DEFAULT_C, BuildLedger,
                                    compaction_schedule, respawn_schedule,
                                    schedule_slot_area,
                                    simulate_walks_sparse)
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import Checkpointer, serialize_key
from repro_torch.distributed.mesh import AXES, RankMesh, fail_together

# the rank service's leader to its followers: the first word of each
# command it broadcasts over the model axis (serving/engine.py)
CMD_ROWS, CMD_UPDATE, CMD_STOP = 0, 1, 2
# what RankIndex.exchange counts
EXCHANGE_COUNTS = ("exchanges", "rows", "rows_crossed", "bytes_crossed")


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

    def replace_rows(self, rows, values: torch.Tensor,
                     indices: torch.Tensor) -> "PPRIndex":
        """A copy with the rows ``rows`` replaced: the repair primitive of
        ``core/updates.py``.  This index is left as it is, so a service
        serves it until it swaps in the copy."""
        rows = torch.as_tensor(rows, device=self.values.device).long()
        new_v = self.values.clone()
        new_v[rows] = values.to(new_v)
        new_i = self.indices.clone()
        new_i[rows] = indices.to(new_i)
        return PPRIndex(values=new_v, indices=new_i, l=self.l, n=self.n)


@dataclasses.dataclass(frozen=True)
class RankIndex:
    """One model shard's rows of a PPR index on a ``RankMesh``: ``rows``
    holds the rank's ``[n_shard, L]`` rows (global columns, ``n`` the whole
    index's row count), rows ``row_offset`` on of the whole.  No rank holds
    another's rows: a query reads rows only on the mesh's leader (model
    shard 0), which :meth:`gather` collects from their owners (the rows
    a sparse frontier touches, :meth:`gather_rows`; the columns of a dense
    one that hold a nonzero; an ``fppr`` query's seeds); the other shards
    answer in :meth:`send_rows`.  ``exchange`` counts what crossed."""

    rows: PPRIndex
    row_offset: int
    mesh: RankMesh
    exchange: Dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(EXCHANGE_COUNTS, 0),
        compare=False, repr=False)

    @property
    def values(self) -> torch.Tensor:
        return self.rows.values

    @property
    def indices(self) -> torch.Tensor:
        return self.rows.indices

    @property
    def l(self) -> int:
        return self.rows.l

    @property
    def n(self) -> int:
        return self.rows.n

    @property
    def n_shard(self) -> int:
        return int(self.rows.values.shape[0])

    @property
    def nbytes(self) -> int:
        return self.n_shard * self.l * 8

    @property
    def is_leader(self) -> bool:
        return self.mesh.local_model[0] == 0

    def to(self, device) -> "RankIndex":
        """This index: its rows stay on the mesh's device."""
        if resolve_device(device) != self.mesh.device:
            raise ValueError(f"a RankIndex lives on its mesh's device "
                             f"{self.mesh.device}, not {device}")
        return self

    def on(self, mesh: RankMesh) -> "RankIndex":
        """The same rows over ``mesh`` (a service's ``1 x ep`` mesh of the
        build mesh's first data replica, say), whose model shard must be
        this rank's, with ``exchange`` counted from zero."""
        if not isinstance(mesh, RankMesh):
            raise ValueError(f"a RankIndex serves over a RankMesh, got "
                             f"{mesh!r}")
        if mesh.model != self.mesh.model or (
                mesh.local_model != self.mesh.local_model):
            raise ValueError(f"{mesh!r} does not hold this rank's model "
                             f"shard of {self.mesh!r}")
        return dataclasses.replace(
            self, mesh=mesh, exchange=dict.fromkeys(EXCHANGE_COUNTS, 0))

    def replace_rows(self, rows, values: torch.Tensor,
                     indices: torch.Tensor) -> "RankIndex":
        """``PPRIndex.replace_rows`` of rows of this shard (global ids)."""
        local = np.asarray(rows, np.int64) - self.row_offset
        if local.size and (local.min() < 0 or local.max() >= self.n_shard):
            raise ValueError("rows outside this rank's shard")
        return dataclasses.replace(
            self, rows=self.rows.replace_rows(local, values, indices))

    def _block(self, need: torch.Tensor) -> torch.Tensor:
        """This shard's rows of the sorted global ids ``need``, values and
        indices side by side as ``int32[k, 2L]``."""
        lo = self.row_offset
        mine = need[(need >= lo) & (need < lo + self.n_shard)] - lo
        return torch.cat([self.values[mine].view(torch.int32),
                          self.indices[mine]], dim=1)

    def send_rows(self, need: torch.Tensor) -> None:
        """A follower's part of :meth:`gather`: its rows of ``need``
        to the leader."""
        self.mesh.gather_blocks(self._block(need.to(self.mesh.device)),
                                "model", dst=0)

    def gather(self, need: torch.Tensor, *, spare: int = 0) -> PPRIndex:
        """On the leader: the rows ``need`` (ascending unique global ids),
        gathered from their owners in that order, then ``spare`` zero rows,
        as a ``PPRIndex`` whose ``n`` is the whole index's.  The ids go to
        the followers as a ``CMD_ROWS`` broadcast (``send_rows`` answers
        it).  Nothing is summed across ranks: the leader's own rows stay
        local and the followers' blocks cross as bytes, each padded to the
        longest, which ``exchange`` counts."""
        if not self.is_leader:
            raise ValueError("only the leader (model shard 0) gathers rows; "
                             "followers run serving.engine.serve_follower")
        dev = self.mesh.device
        need = need.to(dev, torch.int64)
        self.mesh.broadcast(torch.cat([torch.full(
            (1,), CMD_ROWS, dtype=torch.int64, device=dev), need]), src=0,
            axes="model")
        own = self._block(need)
        blocks = self.mesh.gather_blocks(own[:0], "model", dst=0)
        got = torch.cat([own] + list(blocks[1:])
                        + [own.new_zeros(spare, 2 * self.l)])
        # every follower sends the longest follower block's row count
        sent = [int(b.shape[0]) for b in blocks[1:]]
        ex = self.exchange
        ex["exchanges"] += 1
        ex["rows"] += int(need.shape[0])
        ex["rows_crossed"] += sum(sent)
        ex["bytes_crossed"] += len(sent) * max(sent, default=0) * self.l * 8
        return PPRIndex(values=got[:, :self.l].contiguous().view(
            torch.float32), indices=got[:, self.l:].contiguous(), l=self.l,
            n=self.n)

    def gather_rows(self, fv: torch.Tensor, fi: torch.Tensor
                    ) -> Tuple[PPRIndex, torch.Tensor]:
        """On the leader: the rows of the live slots (``fv > 0``) of the
        frontier ``(fv, fi)`` (:meth:`gather`, one zero row after them),
        and ``fi`` remapped to each slot's gathered row (dead slots to the
        zero row).  A combine reads rows only through live slots, so its
        answer over these rows is the same bytes as over the whole
        index."""
        live = fv > 0
        need = torch.unique(fi[live].long())
        rows = self.gather(need, spare=1)
        slot = torch.searchsorted(need, fi.long())
        slot = torch.where(live, slot, need.shape[0]).to(torch.int32)
        return rows, slot


def rank_block(mesh: RankMesh, whole: int) -> slice:
    """This rank's model shard of ``whole`` rows (an even split), or
    ``ValueError``."""
    if whole % mesh.model:
        raise ValueError(f"{whole} index rows do not split into "
                         f"{mesh.model} model shards")
    ns = whole // mesh.model
    return slice(mesh.local_model[0] * ns, (mesh.local_model[0] + 1) * ns)


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
    touch_bits: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """One source chunk of the build: walk at sketch width ``sketch_l``,
    normalize, truncate to ``l``.  Returns ``(vals, idxs, kept, dropped)``
    left on the device; with ``touch_bits`` a fifth output, the rows'
    walks-through Bloom filters ``bool[rows, touch_bits]`` (OR-merged over
    the ``r_splits`` sub-passes).

    ``r_splits > 1`` runs ``r / r_splits`` walks per sub-pass under keys
    ``fold_in(key, split)`` and dedup-merges the sketches in split order
    (``frontier.merge_sketch_parts``): the sharded builder's fold order, so
    this build at ``r_splits`` equal to the data-axis size reproduces
    :func:`build_index_sharded` row for row.  ``respawn`` selects
    respawn-mode scheduling (``walks.respawn_schedule``)."""
    if r % r_splits != 0:
        raise ValueError(f"r={r} must divide over r_splits={r_splits}")
    walk = dict(l=sketch_l, ep_l=0, c=c, max_steps=max_steps,
                compact_every=compact_every, respawn=respawn,
                touch_bits=touch_bits)
    if r_splits == 1:
        counts = simulate_walks_sparse(graph, chunk_sources, r, key, **walk)
        fp_v, fp_i = counts.fp.values, counts.fp.indices
        moves, dropped = counts.moves, counts.fp_dropped
        touch = counts.touch
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
        touch = None
        if touch_bits:
            touch = parts[0].touch
            for p in parts[1:]:
                touch = touch | p.touch
    out = normalize_sketch_to_index_rows(fp_v, fp_i, moves, dropped, l)
    return out + (touch,) if touch_bits else out


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
    touch_bits: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 8,
    resume: bool = False,
    checkpoint_keep: int = 3,
    fault_plan=None,
    device="cuda",
) -> Tuple[PPRIndex, dict]:
    """Offline preprocessing: MCFP for every vertex, truncated to top-L.

    ``engine="sparse"`` (default) streams the compacted sketch engine into
    the index; ``r_splits``/``respawn`` select the sharded builder's
    per-chunk walk split and respawn-mode scheduling
    (:func:`sparse_chunk_estimates`).  ``engine="legacy"`` is the dense
    oracle (:func:`_build_index_legacy`).  ``key`` is a port PRNG key
    (:func:`repro_torch.rng.prng_key`).  The graph moves to ``device``
    (default ``"cuda"``; pass ``"cpu"`` for the plain path).  Duplicate
    ``sources`` are deduplicated up front (``stats["duplicate_sources"]``).
    Returns ``(index, stats)``; stats carry the kept/dropped estimate mass,
    synced once at the end.

    ``touch_bits > 0`` (sparse engine) also returns each row's
    walks-through Bloom filter as ``stats["touch"]`` (``bool[n,
    touch_bits]`` on the device, zero rows for unswept sources).

    **Crash safety** (sparse engine): with ``checkpoint_dir`` the build
    commits, every ``checkpoint_every`` chunks, the rows built so far, the
    ledger (:class:`~repro_torch.core.walks.BuildLedger`) and the filters,
    and at the end a ``complete=True`` step holding the index and stats.
    ``resume=True`` restores the newest committed step that verifies
    (``.tmp`` dirs and corrupt steps never are), refuses one whose build
    signature (graph topology, key, chunk grid) differs, and continues
    from its first incomplete chunk.  Chunk keys are positional, so the
    resumed build equals an uninterrupted one bit for bit, totals
    included.  ``fault_plan`` is the :mod:`repro_torch.testing.faults`
    seam.  The checkpoint is the reference's (same layout and signature),
    so either package resumes or loads the other's.
    """
    if checkpoint_dir is not None and engine != "sparse":
        raise ValueError("checkpointing requires engine='sparse'")
    if engine not in ("sparse", "legacy"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "legacy" and (r_splits != 1 or respawn or touch_bits):
        raise ValueError(
            "r_splits/respawn/touch_bits apply to the sparse engine only")
    graph = graph.to(device)
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
    if engine == "legacy":
        return _build_index_legacy(
            graph, r, l, key, c=c, max_steps=max_steps,
            source_batch=source_batch, sources=sources,
            duplicate_sources=duplicate_sources)
    index, stats = _build_index_sparse(
        graph, r, l, key, c=c, max_steps=max_steps,
        source_batch=source_batch, sources=sources,
        compact_every=compact_every, r_splits=r_splits, respawn=respawn,
        touch_bits=touch_bits, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, resume=resume,
        checkpoint_keep=checkpoint_keep, fault_plan=fault_plan)
    stats["duplicate_sources"] = duplicate_sources
    return index, stats


def _make_build_checkpointer(checkpoint_dir: Optional[str],
                             checkpoint_every: int, checkpoint_keep: int,
                             fault_plan) -> Optional[Checkpointer]:
    if checkpoint_dir is None:
        return None
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    return Checkpointer(
        checkpoint_dir, keep=checkpoint_keep,
        pre_commit=None if fault_plan is None else fault_plan.pre_commit)


def _resume_build_state(ckpt: Checkpointer, signature: dict):
    """``(next_chunk, tree, extra)`` of the newest committed step that
    verifies, or ``None`` (start from scratch).  A step written by another
    build (its signature differs) is an error: resuming it would splice
    other RNG streams into this build."""
    hit = ckpt.restore_latest()
    if hit is None:
        return None
    step, tree, extra = hit
    if extra.get("signature") != signature:
        raise ValueError(
            f"checkpoint at {ckpt.root} step {step} was written by a "
            "different build (graph/key/chunk-grid signature mismatch); "
            "refusing to resume")
    return int(extra["next_chunk"]), tree, extra


def _complete_stats(extra: dict, tree: dict, touch_bits: int, dev) -> dict:
    """Stats of a restored *complete* build (JSON keeps the floats exact)."""
    stats = dict(extra["stats"])
    stats["resumed_complete"] = True
    if touch_bits:
        stats["touch"] = torch.from_numpy(tree["touch"]).to(dev)
        stats["touch_bits"] = touch_bits
    return stats


def _build_index_sparse(
    graph: Graph, r: int, l: int, key, *, c: float, max_steps: int,
    source_batch: int, sources: np.ndarray, compact_every: int,
    r_splits: int, respawn: bool, touch_bits: int,
    checkpoint_dir: Optional[str], checkpoint_every: int, resume: bool,
    checkpoint_keep: int, fault_plan,
) -> Tuple[PPRIndex, dict]:
    """The streaming sparse build over the unique ``sources``.  Each
    chunk's rows are written straight into the ``[n, l]`` index (and the
    ``[n, touch_bits]`` filters), so the peak holds them once; a commit
    copies the rows built so far, in source order, to the host."""
    dev = graph.device
    n = graph.n
    sketch_l = _sketch_width(n, l)
    n_src = len(sources)
    pad_rows = (-n_src) % source_batch
    padded = np.concatenate(
        [sources, np.zeros(pad_rows, np.int32)]
    ) if pad_rows else sources
    n_chunks = len(padded) // source_batch
    padded_dev = torch.from_numpy(padded).to(dev)
    full = n_src == n and np.array_equal(sources, np.arange(n, dtype=np.int32))
    src_rows = None if full else torch.from_numpy(
        sources.astype(np.int64)).to(dev)

    def rows_of(lo: int, hi: int):
        """Index rows of the sources ``sources[lo:hi]``."""
        return slice(lo, hi) if full else src_rows[lo:hi]

    values = torch.zeros((n, l), dtype=torch.float32, device=dev)
    indices = torch.zeros((n, l), dtype=torch.int32, device=dev)
    touch = (torch.zeros((n, touch_bits), dtype=torch.bool, device=dev)
             if touch_bits else None)
    ckpt = _make_build_checkpointer(
        checkpoint_dir, checkpoint_every, checkpoint_keep, fault_plan)
    signature = None
    if ckpt is not None:
        signature = dict(
            kind="build_index_sparse",
            r=int(r), l=int(l), sketch_l=int(sketch_l), c=float(c),
            max_steps=int(max_steps), compact_every=int(compact_every),
            r_splits=int(r_splits), respawn=bool(respawn),
            touch_bits=int(touch_bits), source_batch=int(source_batch),
            n=int(n), n_src=int(n_src),
            sources_crc=zlib.crc32(sources.tobytes()) & rng.MASK,
            graph_crc=graph_fingerprint(graph),
            key=serialize_key(key),
        )
    ledger = BuildLedger(dev)
    start_chunk = 0
    commits = 0
    if ckpt is not None and resume:
        restored = _resume_build_state(ckpt, signature)
        if restored is not None:
            start_chunk, tree, extra = restored
            if extra.get("complete"):
                index = PPRIndex(
                    values=torch.from_numpy(tree["vals"]).to(dev),
                    indices=torch.from_numpy(tree["idxs"]).to(dev), l=l, n=n)
                return index, _complete_stats(extra, tree, touch_bits, dev)
            rows = rows_of(0, tree["vals"].shape[0])
            values[rows] = torch.from_numpy(tree["vals"]).to(dev)
            indices[rows] = torch.from_numpy(tree["idxs"]).to(dev)
            if touch is not None:
                touch[rows] = torch.from_numpy(tree["touch"]).to(dev)
            ledger = BuildLedger.restore(tree["kept"], tree["dropped"], dev)

    def commit_partial(done: int) -> None:
        nonlocal ledger, commits
        kept_arr, dropped_arr = ledger.export()
        rows = rows_of(0, done * source_batch)
        tree = dict(vals=values[rows], idxs=indices[rows], kept=kept_arr,
                    dropped=dropped_arr)
        if touch is not None:
            tree["touch"] = touch[rows]
        ckpt.save(done, tree, dict(signature=signature, complete=False,
                                   next_chunk=done, n_chunks=n_chunks))
        commits += 1
        # one entry a side from here on: the same flat stream, a short list
        ledger = BuildLedger.restore(kept_arr, dropped_arr, dev)

    for ci in range(start_chunk, n_chunks):
        if fault_plan is not None:
            fault_plan.chunk_boundary(ci)
        i = ci * source_batch
        real = min(source_batch, n_src - i)
        out = sparse_chunk_estimates(
            graph, padded_dev[i:i + source_batch], rng.fold_in(key, i), r=r,
            l=l, sketch_l=sketch_l, c=c, max_steps=max_steps,
            compact_every=compact_every, r_splits=r_splits, respawn=respawn,
            touch_bits=touch_bits,
        )
        rows = rows_of(i, i + real)
        values[rows] = out[0][:real]
        indices[rows] = out[1][:real]
        ledger.append(out[2][:real].sum(), out[3][:real].sum())
        if touch is not None:
            touch[rows] = out[4][:real]
        done = ci + 1
        if ckpt is not None and done < n_chunks \
                and done % checkpoint_every == 0:
            commit_partial(done)

    kept, dropped = ledger.totals()
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
    )
    if ckpt is not None:
        stats["checkpoint_commits"] = commits
        stats["resumed_at_chunk"] = start_chunk
        kept_arr, dropped_arr = ledger.export()
        tree = dict(vals=values, idxs=indices, kept=kept_arr,
                    dropped=dropped_arr)
        if touch is not None:
            tree["touch"] = touch
        ckpt.save(n_chunks, tree, dict(
            signature=signature, complete=True, next_chunk=n_chunks,
            n_chunks=n_chunks, stats=dict(stats)))
    if touch is not None:
        stats["touch"] = touch
        stats["touch_bits"] = touch_bits
    return PPRIndex(values=values, indices=indices, l=l, n=n), stats


def _build_index_legacy(graph: Graph, r: int, l: int, key, *, c: float,
                        max_steps: int, source_batch: int,
                        sources: np.ndarray, duplicate_sources: int
                        ) -> Tuple[PPRIndex, dict]:
    """The dense-accumulator build: each chunk's ``f32[source_batch, n]``
    MCFP rows (:func:`mcfp.estimate_ppr_batched`) truncated to top-``l``
    in ``lax.top_k``'s order, written into the zero index on the device.
    The total and kept mass of every chunk stay on the device and are
    summed there, with one sync at the end."""
    dev = graph.device
    n = graph.n
    values = torch.zeros((n, l), dtype=torch.float32, device=dev)
    indices = torch.zeros((n, l), dtype=torch.int32, device=dev)
    rows = torch.from_numpy(sources.astype(np.int64)).to(dev)
    totals, kepts = [], []
    stats: dict = {}
    done = 0
    for chunk_ids, est in mcfp.estimate_ppr_batched(
        graph, sources, r, key, c=c, max_steps=max_steps,
        source_batch=source_batch, stats=stats,
    ):
        vals, idxs = truncate_topl(est, l)
        chunk_rows = rows[done:done + len(chunk_ids)]
        done += len(chunk_ids)
        values[chunk_rows] = vals
        indices[chunk_rows] = idxs
        totals.append(est.sum())
        kepts.append(vals.sum())
    if totals:
        total = float(torch.stack(totals).sum())
        kept = float(torch.stack(kepts).sum())
    else:  # empty sources: a valid all-zero index
        total = kept = 0.0
    dropped = total - kept
    stats.update(
        r=r,
        l=l,
        engine="legacy",
        duplicate_sources=duplicate_sources,
        kept_mass=kept,
        dropped_mass=dropped,
        drop_fraction=dropped / max(total, 1e-12),
        nbytes=n * l * 8,
    )
    return PPRIndex(values=values, indices=indices, l=l, n=n), stats


class _RankCommits:
    """The checkpointed sharded build's commits over a ``RankMesh``.

    One writer, the mesh's shard ``(0, 0)``, gathers each model shard's
    blocks of every segment from the first data replica, keeps them on the
    host (by the last commit, the whole index: the stacked build's layout
    needs every block in one step) and commits them as the stacked build
    does; every rank waits for each commit's outcome, so a failed commit
    fails them all.  On resume the writer picks the step and every rank
    restores its own block of it."""

    def __init__(self, ckpt: Checkpointer, mesh: RankMesh, names):
        self.ckpt, self.mesh, self.names = ckpt, mesh, names
        self.model = mesh.local_model[0]
        self.gathers = mesh.local_data[0] == 0
        self.writer = self.gathers and self.model == 0
        self.host = []      # the writer's segments, [ep, rows, ...] each

    def _from_writer(self, word: Optional[int]) -> int:
        x = (torch.tensor([word], dtype=torch.int64, device=self.mesh.device)
             if self.writer else None)
        return int(self.mesh.broadcast(x, src=0, axes=AXES)[0])

    def resume(self, signature: dict):
        """``(next_chunk, tree, extra)`` of the step the writer resumes
        from on every rank (``tree`` the whole step), or ``None``."""
        hit, err, step = None, None, -1
        if self.writer:
            try:
                hit = _resume_build_state(self.ckpt, signature)
                step = -1 if hit is None else hit[0]
            except ValueError as e:
                err, step = e, -2
        step = self._from_writer(step)
        if err is not None:
            raise err
        if step == -2:
            raise ValueError(f"checkpoint at {self.ckpt.root}: the writer "
                             "refused to resume (signature mismatch)")
        if step == -1:
            return None
        err = None
        if hit is None:
            try:
                tree, extra = self.ckpt.restore(step)
                if extra.get("signature") != signature:
                    raise ValueError(f"checkpoint at {self.ckpt.root} step "
                                     f"{step} was written by a different "
                                     "build; refusing to resume")
                hit = (int(extra["next_chunk"]), tree, extra)
            except (OSError, ValueError, RuntimeError) as e:
                err = e
        # a barrier too: no rank reads a step the writer may prune
        fail_together(self.mesh, err, f"restoring step {step} of "
                      f"{self.ckpt.root}", AXES)
        return hit

    def restored(self, tree: dict) -> list:
        """This rank's blocks ``[1, rows, ...]`` of a partial step; the
        writer keeps the whole step as its first segment."""
        if self.writer:
            self.host.append([tree[k] for k in self.names])
        return [torch.from_numpy(np.ascontiguousarray(tree[k][self.model]))
                [None].to(self.mesh.device) for k in self.names]

    def commit(self, step: int, blocks, extra: dict,
               whole: bool = False) -> None:
        """Gather this segment's ``[1, rows, ...]`` blocks on the writer,
        which commits every segment so far as step ``step`` (``whole``:
        reshaped to the assembled ``[n_pad, ...]`` index)."""
        if self.gathers:
            got = [self.mesh.gather_blocks(b[0], "model", dst=0)
                   for b in blocks]
            if self.writer:
                self.host.append([torch.stack(g).cpu().numpy() for g in got])
        err = None
        if self.writer:
            try:
                segs = [np.concatenate(parts, axis=1)
                        for parts in zip(*self.host)]
                self.host = [segs]
                tree = {k: (a.reshape(-1, *a.shape[2:]) if whole else a)
                        for k, a in zip(self.names, segs)}
                self.ckpt.save(step, tree, extra)
            except BaseException as e:  # noqa: BLE001 - raised below
                err = e
        fail_together(self.mesh, err, f"the commit of step {step} under "
                      f"{self.ckpt.root}", AXES)


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
    checkpoint_every: int = 8,
    resume: bool = False,
    checkpoint_keep: int = 3,
    fault_plan=None,
):
    """The full-index build on a :class:`~repro_torch.distributed.mesh
    .ShardMesh` (``distributed_engine.make_sparse_index_build_step``), or
    one rank's part of it on a :class:`~repro_torch.distributed.mesh
    .RankMesh`.

    Sources shard over the model axis (each shard sweeps the chunks of its
    own vertex interval), walks split over the batch axes (``r / n_data``
    per replica, sketches merged by one gather).  Chunk at global offset
    ``o`` uses ``fold_in(key, o)`` and replica ``s`` folds ``s`` on top:
    :func:`build_index` with ``r_splits = n_data`` over the same chunk
    grid gives the same rows.  The vertex count pads up to ``ep`` shards
    of a multiple of ``source_batch`` (clamped, with a warning, to the
    shard interval); pad vertices are dangling, their rows zeroed, and the
    index has ``n = n_pad``.  Runs on the mesh's device.  ``touch_bits``
    adds the rows' Bloom filters (``stats["touch"]``, ``bool[n_pad,
    touch_bits]``, pad rows zero).

    With ``checkpoint_dir`` the sweep runs in segments of
    ``checkpoint_every`` per-shard chunks, each segment's shard blocks
    (rows, per-row ledgers, filters) committed as it ends and the
    assembled index as a final ``complete=True`` step; ``resume=True``
    continues from the newest committed step bit for bit, and refuses a
    step of another graph, key, mesh or chunk grid.  ``fault_plan`` fires
    ``chunk_boundary`` at each segment's first chunk.

    On a ``RankMesh`` every rank returns its own model shard: a
    :class:`RankIndex` of ``[n_shard, L]`` rows (global columns, ``n =
    n_pad``) that are rows ``stats["row_offset"]`` on of the whole,
    identical on the shard's data replicas, with ``stats["touch"]`` its
    rows' filters; ``kept_mass`` and ``dropped_mass`` sum every shard's
    rows as the stacked build does, so every rank's totals are its.  A
    checkpointed build there writes the stacked build's steps, byte for
    byte (:class:`_RankCommits`: one writer, which holds the whole index
    in host memory at each commit), so either mesh resumes the other's;
    ``fault_plan.chunk_boundary`` fires on every rank.
    """
    from repro_torch.core.distributed_engine import (
        DistConfig, make_sparse_index_build_step)

    on_ranks = isinstance(mesh, RankMesh)
    ep, n_split = mesh.model, mesh.data
    if r % n_split != 0:
        raise ValueError(
            f"r={r} must divide evenly over the {n_split} walk shards")
    graph = graph.to(mesh.device)
    dev = graph.device
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
    n_chunks = ns // source_batch
    cfg = DistConfig(n=n_pad, ep=ep, c=c)
    pad = n_pad - n
    row_ptr, out_deg = graph.row_ptr, graph.out_deg
    if pad:  # pad vertices are dangling: they walk in place
        row_ptr = torch.cat([row_ptr, row_ptr[-1:].expand(pad)])
        out_deg = torch.cat([out_deg, torch.zeros(
            pad, dtype=out_deg.dtype, device=out_deg.device)])
    row_offset = mesh.local_model[0] * ns if on_ranks else 0

    def sweep(chunk_start: int, chunk_count: Optional[int]):
        step = make_sparse_index_build_step(
            cfg, mesh, r=r, l=l, sketch_l=sketch_l, real_n=n,
            max_steps=max_steps, compact_every=compact_every,
            source_batch=source_batch, respawn=respawn,
            touch_bits=touch_bits, chunk_start=chunk_start,
            chunk_count=chunk_count,
        )
        return step(row_ptr, graph.col_idx, out_deg, key)

    def shard_major(parts):
        """Segments ``[S, rows, ...]`` in sweep order -> ``[S * ns, ...]``."""
        x = torch.cat(parts, dim=1)
        return x.reshape(-1, *x.shape[2:])

    def finish(values, indices, stats, touch):
        if touch is not None:
            stats["touch"] = touch
            stats["touch_bits"] = touch_bits
        rows = PPRIndex(values=values, indices=indices, l=l, n=n_pad)
        if on_ranks:
            stats.update(row_offset=row_offset,
                         nbytes=values.shape[0] * l * 8)
            return RankIndex(rows=rows, row_offset=row_offset, mesh=mesh), \
                stats
        return rows, stats

    ckpt = _make_build_checkpointer(
        checkpoint_dir, checkpoint_every, checkpoint_keep, fault_plan)
    extra_stats: dict = {}
    if ckpt is None:
        out = [x.reshape(-1, *x.shape[2:]) for x in sweep(0, None)]
    else:
        signature = dict(
            kind="build_index_sharded",
            r=int(r), l=int(l), sketch_l=int(sketch_l), c=float(c),
            max_steps=int(max_steps), compact_every=int(compact_every),
            source_batch=int(source_batch), respawn=bool(respawn),
            touch_bits=int(touch_bits), n=int(n), n_pad=int(n_pad),
            shards=int(ep), r_splits=int(n_split),
            model_axis="model", batch_axes=["data"],
            mesh_shape=dict(mesh.shape),
            graph_crc=graph_fingerprint(graph),
            key=serialize_key(key),
        )
        names = ("vals", "idxs", "kept", "dropped", "touch")[
            :5 if touch_bits else 4]
        ranks = _RankCommits(ckpt, mesh, names) if on_ranks else None
        # per segment, shard-major blocks [S, rows, ...] on the device
        segs = []
        start_chunk = 0
        commits = 0
        if resume:
            restored = (ranks.resume(signature) if on_ranks
                        else _resume_build_state(ckpt, signature))
            if restored is not None:
                start_chunk, tree, extra = restored
                if extra.get("complete"):
                    if on_ranks:
                        own = rank_block(mesh, tree["vals"].shape[0])
                        tree = {k: v[own] for k, v in tree.items()}
                    stats = _complete_stats(extra, tree, touch_bits, dev)
                    return finish(
                        torch.from_numpy(tree["vals"]).to(dev),
                        torch.from_numpy(tree["idxs"]).to(dev), stats,
                        stats.pop("touch", None))
                segs.append(ranks.restored(tree) if on_ranks else
                            [torch.from_numpy(tree[k]).to(dev)
                             for k in names])
        ci = start_chunk
        while ci < n_chunks:
            if fault_plan is not None:
                fault_plan.chunk_boundary(ci)
            cnt = min(checkpoint_every, n_chunks - ci)
            segs.append(list(sweep(ci, cnt)))
            ci += cnt
            if ci < n_chunks:
                meta = dict(signature=signature, complete=False,
                            next_chunk=ci, n_chunks=n_chunks)
                if on_ranks:
                    ranks.commit(ci, segs[-1], meta)
                segs = [[torch.cat(parts, dim=1) for parts in zip(*segs)]]
                if not on_ranks:
                    ckpt.save(ci, dict(zip(names, segs[0])), meta)
                commits += 1
        tail = segs[-1]     # the last segment's blocks: not committed yet
        # shard-major reassembly: the [S * ns, ...] row order of one sweep
        out = [shard_major(parts) for parts in zip(*segs)]
        extra_stats = dict(checkpoint_commits=commits,
                           resumed_at_chunk=start_chunk)
    values, indices, kept_rows, dropped_rows = out[:4]
    touch = out[4] if touch_bits else None
    if on_ranks:    # every shard's rows, summed as the stacked build sums
        kept_all, dropped_all = (
            mesh.all_gather(x[None, None], "model").reshape(n_pad)
            for x in (kept_rows, dropped_rows))
    else:
        kept_all, dropped_all = kept_rows, dropped_rows
    kept = float(kept_all.sum())
    dropped = float(dropped_all.sum())
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
    stats.update(extra_stats)
    if ckpt is not None:
        meta = dict(signature=signature, complete=True, next_chunk=n_chunks,
                    n_chunks=n_chunks, stats=dict(stats))
        if on_ranks:
            ranks.commit(n_chunks, tail, meta, whole=True)
        else:
            tree = dict(vals=values, idxs=indices, kept=kept_rows,
                        dropped=dropped_rows)
            if touch is not None:
                tree["touch"] = touch
            ckpt.save(n_chunks, tree, meta)
    return finish(values, indices, stats, touch)


def _restore_complete(checkpoint_dir: str) -> Tuple[dict, dict]:
    """``(tree, extra)`` of the newest *complete* committed build step;
    partial steps, ``.tmp`` dirs and corrupt steps are never candidates."""
    hit = Checkpointer(checkpoint_dir).restore_latest(
        predicate=lambda extra: bool(extra.get("complete")))
    if hit is None:
        raise FileNotFoundError(
            f"no complete committed index checkpoint under {checkpoint_dir}")
    return hit[1], hit[2]


def _index_from_tree(tree: dict, extra: dict, device, mesh=None
                     ) -> Tuple[PPRIndex, dict]:
    """The index (and filters) of a complete step; on a ``RankMesh`` the
    rank's own block of an even split of its rows, as a :class:`RankIndex`
    on the mesh's device."""
    stats = dict(extra["stats"])
    if isinstance(mesh, RankMesh):
        dev = mesh.device
        own = rank_block(mesh, tree["vals"].shape[0])
        n = int(tree["vals"].shape[0])
        tree = {k: np.ascontiguousarray(v[own]) for k, v in tree.items()
                if k in ("vals", "idxs", "touch")}
    else:
        dev = resolve_device(device)
        n = None
    values = torch.from_numpy(tree["vals"]).to(dev)
    indices = torch.from_numpy(tree["idxs"]).to(dev)
    rows, l = values.shape
    if "touch" in tree:
        stats["touch"] = torch.from_numpy(tree["touch"]).to(dev)
        stats["touch_bits"] = int(tree["touch"].shape[1])
    index = PPRIndex(values=values, indices=indices, l=int(l),
                     n=int(rows) if n is None else n)
    if n is None:
        return index, stats
    offset = mesh.local_model[0] * int(rows)
    stats.update(row_offset=offset, nbytes=int(rows) * int(l) * 8)
    return RankIndex(rows=index, row_offset=offset, mesh=mesh), stats


def load_index_checkpoint(checkpoint_dir: str, device="cuda", mesh=None
                          ) -> Tuple[PPRIndex, dict]:
    """The serving boot path: the index and the JSON-safe build stats of
    the newest *complete* committed step under ``checkpoint_dir`` (with
    ``stats["touch"]`` where the build recorded filters), on ``device``,
    without simulating a walk.  Corrupt steps fall back to the prior
    complete one; none raises ``FileNotFoundError``.  Reads the
    reference's build checkpoints too.  With a ``RankMesh`` each rank
    boots its own model shard's block (a :class:`RankIndex`); every rank
    reads the step's whole files."""
    return _index_from_tree(*_restore_complete(checkpoint_dir), device,
                            mesh)


# ---------------------------------------------------------------------------
# Memory-budget planning (paper Section 3: the offline/online trade-off)
# ---------------------------------------------------------------------------

# Paper Figure 5 / Section 4.2: iterations needed for RAG > 0.99 at R.
_PAPER_T_FOR_R = ((0, 7), (10, 5), (100, 2))


@dataclasses.dataclass(frozen=True)
class IndexPlan:
    r: int              # walks per vertex offline
    l: int              # index width (top-L)
    t_online: int       # VERD iterations online
    index_bytes: int
    budget_bytes: int
    walk_state_bytes: int = 0   # per-chunk walk/event state priced in
    respawn: bool = True        # scheduling mode the plan was priced for


# Walk-state pricing per slot: a live slot holds its cursor (int32) and
# alive flag (bool); each round also holds, per slot-step, the two drawn
# uniforms (2 x f32) and the stacked (af, pos, tf) event columns (f32 +
# int32 + f32) the sketch folds consume.
_SLOT_BYTES = 5
_SLOT_STEP_BYTES = 20


def walk_state_cost(
    r: int,
    *,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    compact_every: int = 8,
    source_batch: int = 256,
    respawn: bool = True,
) -> dict:
    """Device cost of one source chunk's walk pass, priced at the static
    schedule the engine runs (respawn mode's narrow fixed-width rounds, or
    the decay schedule starting at width ``r``): per-row ``slot_area``
    (slot-steps, :func:`~repro_torch.core.walks.schedule_slot_area`), the
    peak ``max_width``, the pass's ``total_steps`` and the
    ``walk_state_bytes`` of a ``source_batch``-row chunk."""
    if r <= 0:
        return dict(max_width=0, slot_area=0, total_steps=0,
                    walk_state_bytes=0)
    if respawn:
        widths, total_steps = respawn_schedule(
            r, c=c, max_steps=max_steps, compact_every=compact_every)
    else:
        widths = compaction_schedule(
            r, c=c, max_steps=max_steps, compact_every=compact_every)
        total_steps = max_steps
    area = schedule_slot_area(widths, total_steps, compact_every)
    w_max = max(widths)
    per_slot = _SLOT_BYTES + _SLOT_STEP_BYTES * min(compact_every,
                                                    total_steps)
    return dict(
        max_width=w_max,
        slot_area=area,
        total_steps=total_steps,
        walk_state_bytes=int(source_batch * w_max * per_slot),
    )


def plan_for_budget(
    n: int,
    budget_bytes: int,
    *,
    c: float = DEFAULT_C,
    bytes_per_entry: int = 8,
    max_steps: int = 64,
    compact_every: int = 8,
    source_batch: int = 256,
    respawn: bool = True,
) -> IndexPlan:
    """Choose ``(R, L, T)`` for a memory budget: ``L`` is the largest width
    whose index bytes ``n * L * 8`` plus one build chunk's walk state
    (:func:`walk_state_cost`) fit, ``R = floor(c * L)`` saturates it (an
    MCFP row from ``R`` walks has at most ``R / c`` nonzeros), and ``T``
    follows the paper's measured ``R -> T`` table."""
    def state_bytes(l: int) -> int:
        return walk_state_cost(
            int(c * l), c=c, max_steps=max_steps,
            compact_every=compact_every, source_batch=source_batch,
            respawn=respawn,
        )["walk_state_bytes"]

    def fits(l: int) -> bool:
        return n * bytes_per_entry * l + state_bytes(l) <= budget_bytes

    # both cost terms are monotone in l: binary-search the largest width
    # that fits, starting from the index-only cap
    lo, hi = 0, max(int(budget_bytes // (max(n, 1) * bytes_per_entry)), 0)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    l = lo
    r = int(c * l)
    t = 7
    for r_ref, t_ref in _PAPER_T_FOR_R:
        if r >= r_ref:
            t = t_ref
    return IndexPlan(
        r=r, l=l, t_online=t,
        index_bytes=n * l * bytes_per_entry, budget_bytes=budget_bytes,
        walk_state_bytes=state_bytes(l), respawn=bool(respawn),
    )


def preprocessing_cost_model(
    n: int,
    r: int,
    *,
    c: float = DEFAULT_C,
    step_rate: float = 5e8,
    max_steps: int = 64,
    compact_every: int = 8,
    source_batch: int = 256,
    respawn: bool = True,
) -> dict:
    """Analytic preprocessing cost (the paper's Table 2 extrapolation):
    ``n * R / c`` walk positions at ``step_rate`` positions a second, the
    uncapped index bytes ``n * (R / c) * 8``, and the device slot-steps,
    slot occupancy and per-chunk walk state of the schedule the engine
    runs (:func:`walk_state_cost`)."""
    positions = n * r / c
    sc = walk_state_cost(
        r, c=c, max_steps=max_steps, compact_every=compact_every,
        source_batch=source_batch, respawn=respawn,
    )
    slot_positions = n * sc["slot_area"]
    return dict(
        walk_positions=positions,
        est_seconds=positions / step_rate,
        index_bytes_uncapped=int(n * (r / c) * 8),
        respawn=bool(respawn),
        max_slot_width=sc["max_width"],
        slot_positions=slot_positions,
        slot_occupancy=positions / max(slot_positions, 1),
        walk_state_bytes=sc["walk_state_bytes"],
    )


# ---------------------------------------------------------------------------
# Contract-auditor entry point (repro_torch.analysis): the sparse build's
# per-chunk computation holds no f32[rows, n] intermediate — peak device
# memory is O(rows * sketch_l), independent of n beyond the CSR itself.
# The graph, shapes and budget are the reference's.
# ---------------------------------------------------------------------------

from repro_torch.analysis.registry import register_entry_point as _register_ep


def _contract_spec_sparse_walk_chunk(device):
    from repro_torch.analysis.trace import record
    from repro_torch.graphs import synthetic

    g = synthetic.rmat(12, avg_deg=6.0, seed=5, device=device)   # n = 4096
    rows, r, l = 64, 16, 32
    sketch_l = max(2 * l, l + 32)
    chunk = torch.arange(rows, dtype=torch.int32, device=g.device)
    _, records = record(sparse_chunk_estimates, g, chunk, rng.prng_key(0),
                        r=r, l=l, sketch_l=sketch_l)
    # widest fold candidate row: sketch + a full pending buffer + the last
    # event segment that tipped it over (<= compact_every * r wide)
    budget = rows * (sketch_l + max(4 * sketch_l, 512) + 8 * r + 8)
    return dict(records=records, budget=budget, floor=rows * g.n)


_register_ep("sparse-walk-chunk", "dense-state-bound",
             "src/repro_torch/core/index.py", _contract_spec_sparse_walk_chunk)
