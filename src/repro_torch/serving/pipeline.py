"""Async serving pipeline: batches in flight on the CUDA stream + a
completion queue.

PyTorch enqueues CUDA work and returns, so serving splits into two phases
as in ``repro.serving.pipeline``:

* **dispatch** — drain the request buffer, pad to a stable width, launch
  ``engine.query_topk_async`` (no sync; on the card one CUDA graph replay
  per batch), enqueue the top-k's copy into pinned host buffers
  (``non_blocking``) right behind it, record a ``torch.cuda.Event`` behind
  the copy, and push a :class:`PendingBatch` ticket onto a bounded
  :class:`CompletionQueue`;
* **harvest** — pop tickets whose event has completed
  (``Event.query()``): their host buffers already hold the answers, so
  harvesting slices off the pad rows without touching the stream.

The queue depth bounds the batches in flight; a full queue makes the
dispatcher block on its head (backpressure).  ``depth=1`` is the blocking
baseline.  On the CPU every ticket is ready at once.

With ``reuse_buffers`` (the default, as in the reference) the result
buffers ring per ``(padded width, k)``: the pinned host pairs that the
answers' copies land in on the card, the result pairs the engine writes
into (``out=``) on the CPU.  A pair goes back on its ring once its batch
has been harvested, so a steady-state loop allocates none
(``stats["buffers_allocated"]`` plateaus at the depth per width).  Stream
order keeps a width's graph outputs safe: its next replay is enqueued
behind the copy of its last answer.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.batching import Request, RequestBuffer


@dataclasses.dataclass
class PipelineConfig:
    depth: int = 4                # max batches in flight (1 = blocking)
    dispatch: str = "fused"       # fused (query_topk_async) | legacy
                                  # (query_topk + synchronize per batch)
    reuse_buffers: bool = True    # ring harvested result buffers back
                                  # into dispatch (per padded width)
    stall_timeout_s: Optional[float] = None  # stuck-ticket watchdog

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {self.depth}")
        if self.dispatch not in ("fused", "legacy"):
            raise ValueError(f"unknown dispatch {self.dispatch!r}")
        if self.stall_timeout_s is not None and self.stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be positive, got {self.stall_timeout_s}")


@dataclasses.dataclass
class PendingBatch:
    """One in-flight batch: host result tensors (pinned, filled by a copy
    still in flight on the CUDA stream), the event recorded behind that
    copy (None on the CPU), and the request metadata."""
    seq: int
    requests: List[Request]
    padded: int
    values: torch.Tensor          # [padded, k] f32 on the host
    indices: torch.Tensor         # [padded, k] int32 on the host
    dispatched_at: float
    event: Optional[torch.cuda.Event] = None
    epoch: int = 0                # cache epoch at dispatch (invalidate fence)
    stall_warned: bool = False
    engine: object = None         # keeps a swapped-out engine's graphs and
                                  # their pool alive while this is in flight
    ringed: bool = False          # values/indices return to the ring

    def is_ready(self) -> bool:
        """Non-blocking completion probe."""
        return self.event is None or bool(self.event.query())

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


@dataclasses.dataclass
class CompletedBatch:
    """A harvested batch: host arrays sliced to the real rows."""
    seq: int
    requests: List[Request]
    padded: int
    values: np.ndarray            # [n_real, k]
    indices: np.ndarray           # [n_real, k]
    dispatched_at: float
    completed_at: float
    epoch: int = 0


class CompletionQueue:
    """Bounded FIFO of in-flight batches; one stream completes in dispatch
    order, so harvesting from the head is correct."""

    def __init__(self, depth: int):
        self.depth = depth
        self._q: Deque[PendingBatch] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def full(self) -> bool:
        return len(self._q) >= self.depth

    def push(self, ticket: PendingBatch) -> None:
        if self.full():
            raise RuntimeError(
                f"completion queue full (depth={self.depth}); harvest first")
        self._q.append(ticket)

    def pop(self, block: bool = False) -> Optional[PendingBatch]:
        """Pop the head ticket if finished (or waiting for it when
        ``block``); ``None`` when nothing is harvestable."""
        if not self._q:
            return None
        head = self._q[0]
        if block:
            head.wait()
        elif not head.is_ready():
            return None
        return self._q.popleft()

    def head(self) -> Optional[PendingBatch]:
        return self._q[0] if self._q else None


class ServingPipeline:
    """Glue between a :class:`RequestBuffer` and a query engine: dispatch
    sequence, completion queue and pipeline telemetry."""

    def __init__(self, engine, buffer: RequestBuffer, cfg: PipelineConfig,
                 clock: Optional[Callable[[], float]] = None,
                 epoch_fn: Optional[Callable[[], int]] = None):
        self.engine = engine
        self.buffer = buffer
        self.cfg = cfg
        self.clock = clock or time.monotonic
        self.epoch_fn = epoch_fn
        self.queue = CompletionQueue(cfg.depth)
        self._seq = 0
        self.stats: Dict[str, float] = dict(
            dispatched=0, harvested=0, queue_full_stalls=0, in_flight_peak=0,
            buffers_allocated=0, buffers_reused=0, stalled=0,
        )
        self.batch_hist: Dict[int, int] = collections.Counter()
        # (padded, k) -> harvested result pairs for the next dispatch
        self._ring: Dict[Tuple[int, int], Deque] = {}

    @property
    def in_flight(self) -> int:
        return len(self.queue)

    def _should_dispatch(self, force: bool) -> bool:
        if not len(self.buffer):
            return False
        if force or self.buffer.size_ready():
            return True
        # deadline-fired partial batches launch only into an idle pipeline:
        # behind a busy stream they start no sooner and waste pad rows
        return self.in_flight == 0 and self.buffer.ready()

    def dispatch(self, force: bool = False) -> List[CompletedBatch]:
        """Drain-and-launch until the buffer is quiet; returns batches that
        had to be harvested to make room (callers must not drop them)."""
        out: List[CompletedBatch] = []
        while self._should_dispatch(force):
            out.extend(self._dispatch_one())
        return out

    def _batch_arrays(self, requests: List[Request], padded: int):
        """The engine's input arrays: a vertex vector, or ``[padded,
        S_max]`` seeds + weights for seed-set engines (pad rows all-zero)."""
        max_seeds = getattr(getattr(self.engine, "config", None),
                            "max_seeds", 1)
        if max_seeds <= 1:
            verts = np.array([r.vertex for r in requests], dtype=np.int32)
            if padded > len(requests):
                verts = np.concatenate(
                    [verts, np.zeros(padded - len(requests), np.int32)])
            return verts, None
        seeds = np.zeros((padded, max_seeds), np.int32)
        weights = np.zeros((padded, max_seeds), np.float32)
        for j, r in enumerate(requests):
            if r.seeds is not None:
                s = r.seeds[:max_seeds]
                seeds[j, : len(s)] = s
                weights[j, : len(s)] = r.weights[: len(s)]
            else:
                seeds[j, 0] = r.vertex
                weights[j, 0] = 1.0
        return seeds, weights

    def _result_pair(self, padded: int, k: int, pinned: bool):
        """A result pair ``(f32[padded, k], int32[padded, k])`` on the
        host: off the ring when one is there, else a fresh one."""
        ring = self._ring.get((padded, k))
        if ring:
            self.stats["buffers_reused"] += 1
            return ring.popleft()
        self.stats["buffers_allocated"] += 1
        return (torch.empty((padded, k), dtype=torch.float32,
                            pin_memory=pinned),
                torch.empty((padded, k), dtype=torch.int32,
                            pin_memory=pinned))

    def _dispatch_one(self) -> List[CompletedBatch]:
        out: List[CompletedBatch] = []
        if self.queue.full():  # backpressure: block on the oldest batch
            self.stats["queue_full_stalls"] += 1
            out.append(self._complete(self.queue.pop(block=True)))
        requests, padded = self.buffer.drain()
        verts, weights = self._batch_arrays(requests, padded)
        # stamped before the launch: a shape's first dispatch captures
        # its graph, and that time is the batch's
        dispatched_at = self.clock()
        engine = self.engine
        ring = self.cfg.reuse_buffers and self.cfg.dispatch == "fused"
        if self.cfg.dispatch == "legacy":
            vals, idx = engine.query_topk(verts, weights=weights)
            if vals.is_cuda:
                torch.cuda.synchronize(vals.device)
        else:
            key = engine.dispatch_key(self._seq) if engine.uses_key else None
            host = None
            if ring and engine.device.type != "cuda":  # written in place
                host = self._result_pair(padded, engine.effective_top_k,
                                         pinned=False)
            vals, idx = engine.query_topk_async(verts, key=key,
                                                weights=weights, out=host)
        event = None
        if vals.is_cuda:
            # the answers' copy rides the stream right behind the query,
            # so a harvest never enqueues anything behind later batches
            # and the graph's next replay cannot overwrite them first
            if ring:
                hv, hi = self._result_pair(padded, vals.shape[1], pinned=True)
            else:
                hv = torch.empty(vals.shape, dtype=vals.dtype,
                                 pin_memory=True)
                hi = torch.empty(idx.shape, dtype=idx.dtype, pin_memory=True)
            vals = hv.copy_(vals, non_blocking=True)
            idx = hi.copy_(idx, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        ticket = PendingBatch(
            self._seq, requests, padded, vals, idx, dispatched_at, event,
            epoch=self.epoch_fn() if self.epoch_fn is not None else 0,
            engine=engine, ringed=ring,
        )
        self._seq += 1
        self.queue.push(ticket)
        self.stats["dispatched"] += 1
        self.stats["in_flight_peak"] = max(
            self.stats["in_flight_peak"], len(self.queue))
        self.batch_hist[padded] += 1
        return out

    def harvest(self, drain: bool = False) -> List[CompletedBatch]:
        """Pop finished batches from the head; ``drain`` blocks until
        everything in flight has completed."""
        out: List[CompletedBatch] = []
        while len(self.queue):
            ticket = self.queue.pop(block=drain)
            if ticket is None:
                self._watch_stall()
                break
            out.append(self._complete(ticket))
        return out

    def _watch_stall(self) -> None:
        """Count (and warn once for) a head ticket older than
        ``stall_timeout_s``; detection only, the ticket stays in flight."""
        if self.cfg.stall_timeout_s is None:
            return
        head = self.queue.head()
        if head is None or head.stall_warned:
            return
        age = self.clock() - head.dispatched_at
        if age >= self.cfg.stall_timeout_s:
            head.stall_warned = True
            self.stats["stalled"] += 1
            warnings.warn(
                f"serving pipeline batch seq={head.seq} "
                f"({len(head.requests)} requests) has been in flight for "
                f"{age:.3f}s (stall_timeout_s={self.cfg.stall_timeout_s}) "
                "— device stream may be stuck",
                RuntimeWarning, stacklevel=3,
            )

    def flush(self) -> List[CompletedBatch]:
        """Dispatch whatever is buffered, then block for all of it."""
        out = self.dispatch(force=True)
        out.extend(self.harvest(drain=True))
        return out

    def _complete(self, ticket: PendingBatch) -> CompletedBatch:
        # the ticket's event has completed: its host buffers are filled
        n_real = len(ticket.requests)
        vals = ticket.values[:n_real].numpy().copy()
        idx = ticket.indices[:n_real].numpy().copy()
        self.stats["harvested"] += 1
        if ticket.ringed:  # copied out: the pair serves the next dispatch
            self._ring.setdefault(
                tuple(ticket.values.shape), collections.deque()
            ).append((ticket.values, ticket.indices))
        ticket.engine = None
        return CompletedBatch(
            ticket.seq, ticket.requests, ticket.padded, vals, idx,
            ticket.dispatched_at, self.clock(), epoch=ticket.epoch,
        )
