"""Request buffering (paper Section 3.3: "PowerWalk buffers the incoming
PPR queries and computes a batch of PPR queries at a time").

The buffer flushes on either (a) reaching ``max_batch`` or (b) a deadline —
the standard latency/throughput knob for online services.  Requests carry a
tier (``interactive`` | ``bulk``), each with its own deadline/batch policy;
drains take interactive requests first so bulk traffic cannot starve the
latency-sensitive class — unless a bulk deadline has already fired, in
which case the drain goes oldest-deadline-first so sustained interactive
load cannot starve bulk indefinitely (the tier deadline is an *aging
bound*, not a hint).  Deterministic and clock-injectable for tests.

Requests are single vertices or weighted seed sets (``seeds``/``weights``
arrays); the buffer treats both identically — seed-set padding to the
engine's ``S_max`` happens at dispatch (``serving/pipeline.py``), not here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

TIERS = ("interactive", "bulk")


class BufferOverloadError(RuntimeError):
    """Raised by :meth:`RequestBuffer.submit` when admission control is on
    (``BatchingConfig.max_queue_depth``) and the buffer is full.  The
    service layer turns this into a *rejected* answer instead of queueing
    the request into a latency cliff (``PPRService.submit``)."""


@dataclasses.dataclass
class Request:
    request_id: int
    vertex: int                   # single-vertex queries; seed sets keep
                                  # their primary (first) seed here so
                                  # telemetry/answers stay uniform
    arrival: float
    tier: str = "interactive"
    seeds: Optional[np.ndarray] = None    # int[S] seed vertices (None =
                                          # classic single-vertex request)
    weights: Optional[np.ndarray] = None  # f32[S] nonnegative seed weights


@dataclasses.dataclass
class TierPolicy:
    """Per-tier batching knobs; ``None`` inherits the top-level value."""
    max_batch: Optional[int] = None
    max_wait_s: Optional[float] = None


@dataclasses.dataclass
class BatchingConfig:
    max_batch: int = 4096
    max_wait_s: float = 0.010     # flush deadline
    pad_to_power_of_two: bool = True   # pad drains to a closed set of jit
                                  # shapes (historical name; see pad_width —
                                  # widths above pad_quantum are bucketed to
                                  # multiples of the quantum, not pow2)
    pad_quantum: int = 64         # bucket size above which padded widths go
                                  # to the next multiple instead of the next
                                  # power of two (pow2 jumps waste ~25-30%
                                  # of batch capacity near saturation)
    min_pad: int = 1              # floor for the padded width (bounds the
                                  # set of jit shapes a service can compile)
    max_queue_depth: Optional[int] = None  # admission control: pending
                                  # requests beyond this are *shed*
                                  # (BufferOverloadError) instead of queued
                                  # — bounds worst-case queueing delay under
                                  # overload.  None = unbounded (legacy).
    # per-request-class overrides; by default both tiers inherit the
    # top-level deadline/batch so single-tier callers see one policy
    interactive: TierPolicy = dataclasses.field(default_factory=TierPolicy)
    bulk: TierPolicy = dataclasses.field(default_factory=TierPolicy)

    def tier_policy(self, tier: str) -> Tuple[int, float]:
        """Resolved ``(max_batch, max_wait_s)`` for ``tier``."""
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (expected one of {TIERS})")
        p: TierPolicy = getattr(self, tier)
        return (
            self.max_batch if p.max_batch is None else p.max_batch,
            self.max_wait_s if p.max_wait_s is None else p.max_wait_s,
        )

    def pad_width(self, n: int) -> int:
        """Padded jit width for a batch of ``n`` real requests.

        Powers of two up to ``pad_quantum``, then multiples of the quantum
        — the pow2 tail doubled the pad overhead right where saturated
        services live (a 129-row drain padded to 256; bucketing pads it to
        192), while the shape set stays closed and small:
        ``log2(quantum) + max_batch/quantum`` widths.  Clamped to
        ``[min_pad, max_batch]`` (a 3000-wide config must never compile a
        3072-wide jit shape).
        """
        if n <= 0 or not self.pad_to_power_of_two:
            return n
        q = max(1, self.pad_quantum)
        if n <= q:
            padded = 1
            while padded < n:
                padded *= 2
        else:
            padded = ((n + q - 1) // q) * q
        padded = max(padded, min(self.min_pad, self.max_batch))
        return min(padded, self.max_batch)

    def padded_shapes(self) -> List[int]:
        """The closed set of widths :meth:`pad_width` can emit — what a
        warmup loop should compile instead of guessing powers of two."""
        return sorted({self.pad_width(n) for n in range(1, self.max_batch + 1)})


class RequestBuffer:
    def __init__(self, cfg: BatchingConfig,
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.clock = clock or time.monotonic
        self._pending: Dict[str, List[Request]] = {t: [] for t in TIERS}
        self._next_id = 0
        self.stats: Dict[str, int] = dict(shed=0)

    def allocate_id(self) -> int:
        """Reserve a request id without enqueuing anything — cache-served
        answers (``serving/engine.py``) draw from the same sequence so ids
        stay unique across cached and computed responses."""
        rid = self._next_id
        self._next_id += 1
        return rid

    def submit(self, vertex: Optional[int] = None, tier: str = "interactive",
               arrival: Optional[float] = None,
               seeds: Optional[Sequence[int]] = None,
               weights: Optional[Sequence[float]] = None) -> int:
        """Enqueue one request; ``arrival`` defaults to the clock but an
        open-loop load generator may backdate it to the *scheduled* offer
        time so latency includes queueing delay under backpressure.

        Either ``vertex`` (single-vertex query) or ``seeds`` (weighted
        seed-set query; ``weights`` defaults to uniform) must be given.

        With ``cfg.max_queue_depth`` set, a submit that would push the
        pending count past the bound is shed: nothing is enqueued, the
        ``shed`` counter bumps, and :class:`BufferOverloadError` is raised
        (argument validation still runs first — a malformed request is a
        caller bug, not overload).
        """
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r} (expected one of {TIERS})")
        s_arr = w_arr = None
        if seeds is not None:
            s_arr = np.asarray(seeds, dtype=np.int32).reshape(-1)
            if s_arr.size == 0:
                raise ValueError("seed set must contain at least one vertex")
            w_arr = (
                np.ones(s_arr.shape, np.float32) if weights is None
                else np.asarray(weights, dtype=np.float32).reshape(-1)
            )
            if w_arr.shape != s_arr.shape:
                raise ValueError(
                    f"weights shape {w_arr.shape} != seeds shape {s_arr.shape}"
                )
            if vertex is None:  # primary seed labels answers/telemetry
                vertex = int(s_arr[0])
        elif vertex is None:
            raise ValueError("submit() needs a vertex or a seed set")
        depth = self.cfg.max_queue_depth
        if depth is not None and len(self) >= depth:
            self.stats["shed"] += 1
            raise BufferOverloadError(
                f"request buffer at max_queue_depth={depth}; request shed"
            )
        rid = self.allocate_id()
        t = self.clock() if arrival is None else arrival
        self._pending[tier].append(
            Request(rid, int(vertex), t, tier, seeds=s_arr, weights=w_arr)
        )
        return rid

    def size_ready(self) -> bool:
        """True when any tier (or the buffer overall) hit its batch size —
        the flush trigger that does *not* depend on the clock."""
        if sum(len(v) for v in self._pending.values()) >= self.cfg.max_batch:
            return True
        return any(
            len(self._pending[tier]) >= self.cfg.tier_policy(tier)[0]
            for tier in TIERS
        )

    def ready(self) -> bool:
        """True when any tier hit its batch size or its *oldest pending*
        request crossed that tier's deadline."""
        if self.size_ready():
            return True
        now = None
        for tier in TIERS:
            pending = self._pending[tier]
            if not pending:
                continue
            _, t_wait = self.cfg.tier_policy(tier)
            now = self.clock() if now is None else now
            if (now - pending[0].arrival) >= t_wait:
                return True
        return False

    def _drain_order(self) -> List[str]:
        """Tier drain order: interactive-first, *unless* some tier's oldest
        request has crossed its deadline — then fired tiers go first,
        oldest deadline first.  This is what makes ``max_wait_s`` an aging
        bound: under sustained interactive load a bulk request waits at
        most one deadline before it outranks fresher interactive traffic,
        instead of starving behind it forever.
        """
        fired: List[Tuple[float, str]] = []
        now = None
        for tier in TIERS:
            pending = self._pending[tier]
            if not pending:
                continue
            _, t_wait = self.cfg.tier_policy(tier)
            now = self.clock() if now is None else now
            deadline = pending[0].arrival + t_wait
            if now >= deadline:
                fired.append((deadline, tier))
        if not fired:
            return list(TIERS)
        fired.sort()
        fired_tiers = [t for _, t in fired]
        return fired_tiers + [t for t in TIERS if t not in fired_tiers]

    def drain(self) -> Tuple[List[Request], int]:
        """Pop up to max_batch requests (tier order: :meth:`_drain_order`);
        returns ``(requests, padded_size)`` with the bucketed padded width
        from :meth:`BatchingConfig.pad_width`."""
        batch: List[Request] = []
        room = self.cfg.max_batch
        for tier in self._drain_order():  # FIFO within a tier
            t_batch, _ = self.cfg.tier_policy(tier)
            take = min(room, t_batch)
            batch.extend(self._pending[tier][:take])
            self._pending[tier] = self._pending[tier][take:]
            room = self.cfg.max_batch - len(batch)
            if room <= 0:
                break
        return batch, self.cfg.pad_width(len(batch))

    def __len__(self) -> int:
        return sum(len(v) for v in self._pending.values())
