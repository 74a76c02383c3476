"""Random-walk engines: the dense one and the compacted sparse-sketch one.

Every walk terminates with probability ``c`` per position and a walk on a
dangling vertex jumps home (paper Section 2.1); every draw comes from the
same threefry stream as the reference's (``repro.core.walks``), so the same
key gives the same counts bit for bit.

* :func:`simulate_walks` is the dense engine: one cursor per walk, advanced
  for ``max_steps`` positions, counts scattered into ``f32[rows, n]``
  full-path (MCFP) and end-point (MCEP) accumulators.  Its moves draw with
  ``jax.random.randint``'s law (:func:`repro_torch.rng.randint`); it is
  gathers, RNG and scatter-adds in plain PyTorch, as the reference's is
  XLA with no Pallas kernel.
* :func:`simulate_walks_sparse` is the offline phase of PowerWalk: ``r``
  walks per source, visits folded into per-row top-``L`` count sketches.
  Live-walk compaction follows the static ``(1-c)^t`` bucket schedule of
  :func:`compaction_schedule`, or, in respawn mode, the narrow fixed-width
  rounds of :func:`respawn_schedule`.  The reference's ``lax.scan`` over
  steps is a Python loop here; the cursor advance goes through the
  ``walk_step`` kernel on CUDA tensors.  With ``touch_bits`` it also
  records each row's walks-through Bloom filter (:func:`touch_hash_bits`),
  the invalidation sketch of incremental repair (``core/updates.py``).
* :class:`BuildLedger` keeps a streaming build's kept/dropped mass, one
  entry per chunk, exportable into a checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.core import frontier as frontier_mod
from repro_torch.core.graph import Graph
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.walk_step import sample_edge_offsets  # noqa: F401

DEFAULT_C = 0.15


@dataclasses.dataclass(frozen=True)
class WalkCounts:
    """Aggregated walk statistics grouped into ``rows`` source rows.

    fp_counts: f32[rows, n] full-path visit counts (MCFP numerator).
    ep_counts: f32[rows, n] end-point counts (MCEP numerator).
    moves:     f32[rows]    total counted positions per row (MCFP denom).
    walks:     f32[rows]    number of walks per row (MCEP denominator).
    """

    fp_counts: torch.Tensor
    ep_counts: torch.Tensor
    moves: torch.Tensor
    walks: torch.Tensor


def host_step_key_words(key, steps: int, fold: Optional[int] = None
                        ) -> torch.Tensor:
    """The key words of every step of a dense walk pass, ``int64[steps, 3,
    2]`` on the host: per step ``t``, ``k_move, k_term = split(fold_in(key,
    t))`` (``fold`` folded into the step key first when given: a data
    shard's index), then ``randint``'s own split of ``k_move``, stacked as
    ``(k_term, k_move halves)``."""
    step = rng.fold_in(rng.key_data(key).cpu(), torch.arange(steps))
    if fold is not None:
        step = rng.fold_in(step, fold)
    step = rng.split(step)                                      # [T, 2, 2]
    halves = rng.split(step[:, 0])                              # [T, 2, 2]
    return torch.cat([step[:, 1:2], halves], dim=1)


def step_key_words(key, steps: int, device, fold: Optional[int] = None
                   ) -> torch.Tensor:
    """:func:`host_step_key_words` on ``device``, sent in one copy, so the
    steps make no host round trip."""
    words = host_step_key_words(key, steps, fold)
    if torch.device(device).type == "cuda":
        return words.pin_memory().to(device, non_blocking=True)
    return words.to(device)


def advance_walks(row_ptr, col_idx, out_deg, cursors: torch.Tensor,
                  sources: torch.Tensor, higher: torch.Tensor,
                  lower: torch.Tensor) -> torch.Tensor:
    """Move every walk one edge: ``randint``'s draw from the words
    ``(higher, lower)`` picks the out-edge; a dangling vertex jumps to its
    source (its gather, which may point past the last edge, is clamped and
    then replaced)."""
    cur = cursors.long()
    deg = out_deg[cur]
    if col_idx.shape[0] == 0:
        return sources
    off = rng.bits_to_randint(higher, lower, 0, torch.clamp(deg, min=1))
    edge = torch.clamp(row_ptr[cur] + off, max=col_idx.shape[0] - 1)
    return torch.where(deg == 0, sources, col_idx[edge.long()])


def simulate_walks(
    graph: Graph,
    walk_sources: torch.Tensor,
    walk_rows: torch.Tensor,
    key,
    *,
    n_rows: int,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    words: Optional[torch.Tensor] = None,
) -> WalkCounts:
    """Run one walk per entry of ``walk_sources`` and aggregate counts, on
    the graph's device.  ``words`` (:func:`step_key_words` of ``key``, on
    that device) replaces ``key``: a captured CUDA graph takes them as an
    input, since computing them reads the host.

    walk_sources: int32[W] start (= personalization) vertex of each walk.
    walk_rows:    int32[W] output row each walk accumulates into (so ``R``
                  walks of one source share a row).

    Per step ``t``, in the reference's order: count every active walk's
    position, draw termination (``uniform(k_term) < c``) and count the
    terminated walks' endpoints, then move every walk (``randint(k_move)``
    picks the out-edge; a dangling vertex jumps to its source).  Walks
    still active after ``max_steps`` positions count their position as
    their endpoint.  The counts are integers below 2**24, so the f32
    scatter-adds are exact in any order: the card and the CPU give the
    same bytes.
    """
    dev = graph.device
    w = int(walk_sources.shape[0])
    src = walk_sources.to(dev, torch.int32)
    rows = walk_rows.to(dev).long()
    if words is None:
        words = step_key_words(key, max_steps, dev)
    c32 = torch.full((), c, dtype=torch.float32, device=dev)
    fp = torch.zeros((n_rows, graph.n), dtype=torch.float32, device=dev)
    ep = torch.zeros_like(fp)
    moves = torch.zeros((n_rows,), dtype=torch.float32, device=dev)
    walks_done = torch.zeros_like(moves)
    cursors = src
    active = torch.ones((w,), dtype=torch.bool, device=dev)
    for t in range(max_steps):
        bits = rng.random_bits(words[t], (w,), dev)             # [3, W]
        cur = cursors.long()
        af = active.to(torch.float32)
        fp.index_put_((rows, cur), af, accumulate=True)
        moves.index_put_((rows,), af, accumulate=True)
        terminate = active & (rng.bits_to_uniform(bits[0]) < c32)
        tf = terminate.to(torch.float32)
        ep.index_put_((rows, cur), tf, accumulate=True)
        walks_done.index_put_((rows,), tf, accumulate=True)
        active = active & ~terminate
        cursors = advance_walks(graph.row_ptr, graph.col_idx, graph.out_deg,
                                cursors, src, bits[1], bits[2])
    af = active.to(torch.float32)
    ep.index_put_((rows, cursors.long()), af, accumulate=True)
    walks_done.index_put_((rows,), af, accumulate=True)
    return WalkCounts(fp_counts=fp, ep_counts=ep, moves=moves,
                      walks=walks_done)


def walks_for_sources(sources: torch.Tensor, r: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand ``sources int32[S]`` into ``(walk_sources, walk_rows)`` with
    ``r`` walks per source, on the sources' device."""
    s = int(sources.shape[0])
    walk_sources = sources.to(torch.int32)[:, None].expand(s, r).reshape(-1)
    walk_rows = torch.arange(s, dtype=torch.int32, device=sources.device)[
        :, None].expand(s, r).reshape(-1)
    return walk_sources, walk_rows


def sample_walk_lengths(key, w: int, c: float = DEFAULT_C,
                        max_steps: int = 64, device="cpu") -> torch.Tensor:
    """Walk lengths only (positions per walk, ``int32[w]``): the geometric(c)
    law the theory relies on."""
    u = rng.uniform(key, (w, max_steps), device)
    c32 = torch.tensor(c, dtype=torch.float32, device=u.device)
    alive = torch.cumprod((u >= c32).to(torch.int32), dim=1)
    return (1 + alive.sum(dim=1)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SparseWalkCounts:
    """Sketched walk statistics grouped into ``rows`` source rows.

    fp/ep: top-L visit / endpoint count sketches; moves/walks: MCFP/MCEP
    denominators; truncated: walks cut short by the schedule;
    fp_dropped/ep_dropped: mass truncated out of each sketch; touch: the
    rows' walks-through Bloom filters, ``bool[rows, touch_bits]`` (None
    unless asked for).  Conservation: ``fp.mass() + fp_dropped == moves``
    and ``ep.mass() + ep_dropped == walks == r`` per row.
    """

    fp: frontier_mod.SparseFrontier
    ep: frontier_mod.SparseFrontier
    moves: torch.Tensor
    walks: torch.Tensor
    truncated: torch.Tensor
    fp_dropped: torch.Tensor
    ep_dropped: torch.Tensor
    touch: Optional[torch.Tensor] = None


def compaction_schedule(
    r: int,
    *,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    compact_every: int = 8,
    margin: float = 1.35,
    floor: int = 8,
    lane: int = 8,
) -> Tuple[int, ...]:
    """Static per-round slot widths: round ``j`` covers steps ``[j *
    compact_every, (j+1) * compact_every)`` at width ``min(r, max(floor,
    margin * r * (1-c)^t))`` rounded up to a ``lane`` multiple; round 0 is
    exactly ``r``."""
    if r <= 0:
        raise ValueError(f"r must be positive, got {r}")
    widths = []
    t = 0
    while t < max_steps:
        live = r * (1.0 - c) ** t
        w = int(math.ceil(margin * live))
        w = ((w + lane - 1) // lane) * lane
        w = min(r, max(floor, w)) if t else r
        widths.append(w)
        t += compact_every
    return tuple(widths)


def respawn_schedule(
    r: int,
    *,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    compact_every: int = 8,
    margin: float = 1.35,
    width: int = 0,
    slack: float = 1.15,
    floor: int = 4,
    lane: int = 4,
    drain_eps: float = 0.02,
) -> Tuple[Tuple[int, ...], int]:
    """Static rounds of respawn-mode scheduling: ``(widths, total_steps)``.

    ``launch`` rounds at a fixed width ``w0`` (``width``, 0 = ``ceil(r /
    3)``, lane-rounded), enough that ``c * w0`` launches per step cover the
    quota ``r - w0`` with ``slack`` (at most ``4 * max_steps /
    compact_every`` rounds), then a :func:`compaction_schedule` drain from
    ``w0`` cut once ``(1-c)^t`` falls below ``drain_eps``.  Slots freed by
    termination refill from each row's quota at every step; quota still
    unspent at the end is flushed as length-1 walks."""
    if r <= 0:
        raise ValueError(f"r must be positive, got {r}")
    w0 = width if width > 0 else int(math.ceil(r / 3))
    w0 = ((w0 + lane - 1) // lane) * lane
    w0 = min(r, max(floor, w0))
    quota = r - w0
    if quota > 0:
        per_round = max(c * w0 * compact_every, 1e-9)
        launch_rounds = int(math.ceil(slack * quota / per_round))
        launch_rounds = min(
            launch_rounds,
            int(math.ceil(4 * max_steps / max(compact_every, 1))),
        )
    else:
        launch_rounds = 0
    drain_target = int(math.ceil(math.log(drain_eps) / math.log(1.0 - c))) \
        if 0.0 < c < 1.0 else max_steps
    drain_steps = min(
        max_steps,
        ((max(drain_target, 1) + compact_every - 1) // compact_every)
        * compact_every,
    )
    drain = compaction_schedule(
        w0, c=c, max_steps=drain_steps, compact_every=compact_every,
        margin=margin, floor=floor, lane=lane,
    )
    widths = (w0,) * launch_rounds + drain
    return widths, launch_rounds * compact_every + drain_steps


def schedule_slot_area(
    widths: Tuple[int, ...], total_steps: int, compact_every: int = 8
) -> int:
    """Slot-steps one source row spends on one pass of a schedule: round
    ``j`` runs at width ``w_j`` for ``min(compact_every, total_steps -
    t0_j)`` steps."""
    area, t0 = 0, 0
    for w in widths:
        steps = min(compact_every, total_steps - t0)
        if steps <= 0:
            break
        area += w * steps
        t0 += steps
    return area


TOUCH_HASHES = 4
_HASH_MULS = (0x85EBCA6B, 0xC2B2AE35)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for ``h`` in ``[0, 2**32)``, in int64 without
    overflow: the constant's two 16-bit halves multiply separately, so no
    product passes 2**48."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & rng.MASK


def touch_hash_bits(vertices: torch.Tensor, n_bits: int,
                    k: int = TOUCH_HASHES) -> torch.Tensor:
    """Bloom bit positions of each vertex id, ``vertices.shape + (k,)``
    int32: ``k`` streams of fmix32 over the id xor a per-hash odd constant,
    mod ``n_bits``.  The uint32 arithmetic runs in int64 with a mask after
    every multiply, so it equals ``repro.core.walks.touch_hash_bits`` bit
    for bit; a negative id hashes as its uint32 bits, as there."""
    v = vertices.to(torch.int64) & rng.MASK
    outs = []
    for j in range(k):
        h = v ^ (((2 * j + 1) * 0x9E3779B9) & rng.MASK)
        h = _mul32(h ^ (h >> 16), _HASH_MULS[0])
        h = _mul32(h ^ (h >> 13), _HASH_MULS[1])
        h = h ^ (h >> 16)
        outs.append((h % n_bits).to(torch.int32))
    return torch.stack(outs, dim=-1)


def advance_cursors(
    graph: Graph, cursors: torch.Tensor, sources: torch.Tensor,
    u: torch.Tensor,
) -> torch.Tensor:
    """Advance every cursor one edge (dangling vertices jump to
    ``sources``, which broadcasts against ``cursors``) through the
    ``walk_step`` kernel wrapper."""
    return kernel_ops.walk_step(
        cursors, sources, u, graph.row_ptr, graph.out_deg, graph.col_idx)


def _compact_slots(
    cursors: torch.Tensor, alive: torch.Tensor, w_new: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact surviving cursors into the low slots of a width-``w_new``
    row; survivors ranked past ``w_new`` overflow and come back as
    ``(weight, cursor)`` events.  Returns ``(cursors, alive, overflow_w,
    overflow_i)``."""
    rows, _ = cursors.shape
    rank = torch.cumsum(alive.to(torch.int32), dim=1, dtype=torch.int32)
    keep = alive & (rank <= w_new)
    tgt = torch.where(keep, rank - 1, w_new).long()
    packed = torch.zeros((rows, w_new + 1), dtype=cursors.dtype,
                         device=cursors.device)
    packed.scatter_(1, tgt, torch.where(keep, cursors, 0))
    n_kept = torch.clamp(rank[:, -1], max=w_new)
    new_alive = (torch.arange(w_new, device=cursors.device)[None, :]
                 < n_kept[:, None])
    over = alive & (rank > w_new)
    return (
        packed[:, :w_new].contiguous(),
        new_alive,
        over.to(torch.float32),
        torch.where(over, cursors, 0),
    )


class _EventSketch:
    """Running top-``k`` sketch fed by buffered event segments: segments
    queue until their width reaches ``fold_width``, then one
    :func:`frontier.fold_topk` folds them in.  Disabled, every event lands
    in ``dropped``."""

    def __init__(self, rows: int, k: int, fold_width: int, device,
                 enabled: bool = True):
        self.k = k
        self.enabled = enabled
        self.fold_width = fold_width
        self.values = torch.zeros((rows, k), dtype=torch.float32, device=device)
        self.indices = torch.zeros((rows, k), dtype=torch.int32, device=device)
        self.dropped = torch.zeros((rows,), dtype=torch.float32, device=device)
        self._pend_v: list = []
        self._pend_i: list = []
        self._pend_w = 0

    def add(self, ev_w: torch.Tensor, ev_i: torch.Tensor) -> None:
        if not self.enabled:
            self.dropped = self.dropped + ev_w.sum(dim=1)
            return
        self._pend_v.append(ev_w)
        self._pend_i.append(ev_i)
        self._pend_w += ev_w.shape[1]
        if self._pend_w >= self.fold_width:
            self.flush()

    def flush(self) -> None:
        if not self._pend_w:
            return
        self.values, self.indices, d = frontier_mod.fold_topk(
            self.values, self.indices,
            torch.cat(self._pend_v, dim=1), torch.cat(self._pend_i, dim=1),
            self.k,
        )
        self.dropped = self.dropped + d
        self._pend_v, self._pend_i, self._pend_w = [], [], 0


def round_uniforms(key, t0: int, steps: int, rows: int, w: int, device):
    """The round's step uniforms ``(u_move, u_term)``, each ``[steps, rows,
    w]``: per step ``t`` the two halves of ``split(fold_in(key, t))`` each
    drawn at shape ``(rows, w)`` — the reference's ``round_uniforms``."""
    step_keys = rng.split(rng.fold_in(key, torch.arange(t0, t0 + steps)))
    u = rng.uniform(step_keys, (rows, w), device)    # [steps, 2, rows, w]
    return u[:, 0], u[:, 1]


def simulate_walks_sparse(
    graph: Graph,
    sources: torch.Tensor,
    r: int,
    key,
    *,
    l: int,
    ep_l: Optional[int] = None,
    c: float = DEFAULT_C,
    max_steps: int = 64,
    compact_every: int = 8,
    margin: float = 1.35,
    fold_width: int = 0,
    respawn: bool = False,
    respawn_width: int = 0,
    touch_bits: int = 0,
) -> SparseWalkCounts:
    """Run ``r`` walks per source through the compacted sketch engine.

    ``sources int32[rows]`` on the graph's device; ``l``/``ep_l`` are the
    fp/ep sketch widths (0 disables that sketch: its mass lands in the
    ``*_dropped`` ledger); ``fold_width`` batches events before each fold
    (0 = ``max(4 * l, 512)``).  Walks surviving ``max_steps`` positions are
    truncated to their endpoint.

    ``respawn=True`` runs :func:`respawn_schedule` (width
    ``respawn_width``, 0 = auto): before every step, dead slots (ranked by
    a cumsum) refill at the source from the row's remaining quota; quota
    left at the end is flushed as length-1 walks (one counted position at
    the source, ledgered in ``truncated``), so every row finishes ``r``
    walks.

    ``touch_bits > 0`` also records each row's Bloom filter over every
    counted position (``counts.touch``, ``bool[rows, touch_bits]``,
    :data:`TOUCH_HASHES` hashes): a row whose filter misses every vertex
    an edge update touched re-simulates bit-identically on the new graph.
    Dead events set a spare column past the filter, sliced away at the end
    (an out-of-range scatter index would be a device assert on CUDA).
    """
    dev = graph.device
    rows = sources.shape[0]
    n = graph.n
    l = min(l, n)
    ep_l = min(ep_l if ep_l is not None else l, n)
    if fold_width <= 0:
        fold_width = max(4 * l, 512)
    if respawn:
        schedule, total_steps = respawn_schedule(
            r, c=c, max_steps=max_steps, compact_every=compact_every,
            margin=margin, width=respawn_width,
        )
    else:
        schedule = compaction_schedule(
            r, c=c, max_steps=max_steps, compact_every=compact_every,
            margin=margin,
        )
        total_steps = max_steps
    src2d = sources.to(torch.int32).reshape(rows, 1)
    c32 = torch.tensor(c, dtype=torch.float32, device=dev)

    w0 = schedule[0]
    cursors = src2d.expand(rows, w0).contiguous()
    alive = (torch.arange(w0, device=dev)[None, :] < min(r, w0)).expand(
        rows, w0)
    quota = torch.full((rows,), r - min(r, w0), dtype=torch.int32,
                       device=dev)
    fp = _EventSketch(rows, max(l, 1), fold_width, dev, enabled=l > 0)
    ep = _EventSketch(rows, max(ep_l, 1), fold_width, dev, enabled=ep_l > 0)
    moves = torch.zeros((rows,), dtype=torch.float32, device=dev)
    walks_done = torch.zeros_like(moves)
    truncated = torch.zeros_like(moves)
    touch = (torch.zeros((rows, touch_bits + 1), dtype=torch.bool,
                         device=dev) if touch_bits > 0 else None)

    def record_touch(ev_i, ev_live):
        # the k bits of every live event's vertex; dead events park at the
        # spare column ``touch_bits``
        bits = touch_hash_bits(ev_i, touch_bits)
        bits = torch.where(ev_live[..., None], bits, touch_bits)
        touch.scatter_(1, bits.reshape(rows, -1).long(), True)

    def per_row(ev):
        # [steps, rows, w] -> per-row event columns [rows, steps * w]
        return ev.transpose(0, 1).reshape(rows, -1)

    t0 = 0
    for w in schedule:
        if w < cursors.shape[1]:
            cursors, alive, ov_w, ov_i = _compact_slots(cursors, alive, w)
            n_over = ov_w.sum(dim=1)
            walks_done = walks_done + n_over
            truncated = truncated + n_over
            ep.add(ov_w, ov_i)
        steps = min(compact_every, total_steps - t0)
        u_move, u_term = round_uniforms(key, t0, steps, rows, w, dev)
        vis_w, vis_i, term_w = [], [], []
        for s in range(steps):
            if respawn:  # refill dead slots at the source from the quota
                dead = ~alive
                rank = torch.cumsum(dead.to(torch.int32), dim=1,
                                    dtype=torch.int32)
                spawn = dead & (rank <= quota[:, None])
                quota = quota - spawn.sum(dim=1, dtype=torch.int32)
                cursors = torch.where(spawn, src2d, cursors)
                alive = alive | spawn
            af = alive.to(torch.float32)
            vis_w.append(af)
            vis_i.append(cursors)
            moves = moves + af.sum(dim=1)
            terminate = alive & (u_term[s] < c32)
            tf = terminate.to(torch.float32)
            term_w.append(tf)
            walks_done = walks_done + tf.sum(dim=1)
            alive = alive & ~terminate
            nxt = advance_cursors(graph, cursors, src2d, u_move[s])
            cursors = torch.where(alive, nxt, cursors)
        vis_i = per_row(torch.stack(vis_i))
        vis_w = per_row(torch.stack(vis_w))
        fp.add(vis_w, vis_i)
        ep.add(per_row(torch.stack(term_w)), vis_i)
        if touch is not None:
            record_touch(vis_i, vis_w > 0)
        t0 += steps

    af = alive.to(torch.float32)
    n_trunc = af.sum(dim=1)
    walks_done = walks_done + n_trunc
    truncated = truncated + n_trunc
    ep.add(af, torch.where(alive, cursors, 0))
    if respawn:  # quota never launched: length-1 walks at the source
        q_rem = quota.to(torch.float32)
        moves = moves + q_rem
        walks_done = walks_done + q_rem
        truncated = truncated + q_rem
        fp.add(q_rem[:, None], src2d)
        ep.add(q_rem[:, None], src2d)
        if touch is not None:
            record_touch(src2d, q_rem[:, None] > 0)
    fp.flush()
    ep.flush()
    return SparseWalkCounts(
        fp=frontier_mod.SparseFrontier(
            values=fp.values, indices=fp.indices, k=max(l, 1), n=n),
        ep=frontier_mod.SparseFrontier(
            values=ep.values, indices=ep.indices, k=max(ep_l, 1), n=n),
        moves=moves,
        walks=walks_done,
        truncated=truncated,
        fp_dropped=fp.dropped,
        ep_dropped=ep.dropped,
        touch=None if touch is None else touch[:, :touch_bits].contiguous(),
    )


class BuildLedger:
    """The conservation ledger of a streaming index build: one kept and
    one dropped estimate-mass entry per swept chunk, summed once at the
    end.  A checkpointed build exports it with the partial index rows, so
    a resumed run sums the same f32 entries in the same order and
    reproduces the uninterrupted run's totals bit for bit.

    Entries may be device scalars, per-row device vectors or restored
    numpy arrays; every one is flattened onto ``device`` in order.
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._kept: list = []
        self._dropped: list = []

    def append(self, kept, dropped) -> None:
        self._kept.append(kept)
        self._dropped.append(dropped)

    @property
    def empty(self) -> bool:
        return not self._kept

    def _flat(self, parts) -> torch.Tensor:
        return torch.cat([torch.as_tensor(p).to(self.device, torch.float32)
                          .reshape(-1) for p in parts])

    def export(self):
        """``(kept, dropped)`` as flat f32 numpy arrays, the checkpoint
        payload (f32 round-trips ``np.save`` exactly)."""
        import numpy as np

        if self.empty:
            z = np.zeros(0, np.float32)
            return z, z
        return (self._flat(self._kept).cpu().numpy(),
                self._flat(self._dropped).cpu().numpy())

    @classmethod
    def restore(cls, kept, dropped, device="cpu") -> "BuildLedger":
        """A ledger of one entry a side from exported arrays: its flat
        stream equals the one it was exported from."""
        led = cls(device)
        led.append(kept, dropped)
        return led

    def totals(self):
        """``(kept, dropped)`` as floats: one sum over each side's flat
        entry stream, one host sync."""
        if self.empty:
            return 0.0, 0.0
        kept, dropped = torch.stack([self._flat(self._kept).sum(),
                                     self._flat(self._dropped).sum()]).tolist()
        return kept, dropped
