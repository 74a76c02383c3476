"""Open-loop load generation for the PPR service.

A closed-loop client (submit, wait, submit) hides saturation: when the
service slows down, the offered load slows down with it.  The open-loop
harness offers request ``i`` at its scheduled time ``t0 + i / qps``
whatever the service's backpressure, backdates the request's arrival to
that schedule and measures latency from it, so queueing delay under
overload shows in p99 as clients would see it.  ``qps=None`` is the
closed loop (offer as fast as the loop runs), which
``PPRService.run_closed_loop`` wraps.  The counterpart of
``repro.serving.loadgen``: the same schedule and the same workloads from
the same seed.

The clock is the service's (injectable for deterministic tests); ``sleep``
is injectable the same way.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

# a workload item is a vertex, a (vertex, tier) pair, or a seed-set dict
# {"seeds": [...], "weights": [...], "tier": "..."} (weights and tier
# optional: uniform weights, the interactive tier)
WorkItem = Union[int, Tuple[int, str], dict]


def _percentile(xs: List[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p)) if xs else 0.0


def _submit(service, item: WorkItem, arrival: Optional[float] = None) -> None:
    """Submit one work item of any spelling."""
    if isinstance(item, dict):
        service.submit(tier=item.get("tier", "interactive"), arrival=arrival,
                       seeds=item["seeds"], weights=item.get("weights"))
        return
    v, tier = item if isinstance(item, tuple) else (item, "interactive")
    service.submit(v, tier=tier, arrival=arrival)


def zipf_seed_workload(
    n_vertices: int, n_requests: int, *, skew: float = 1.1,
    max_seeds: int = 4, pool: int = 1024, singles_fraction: float = 0.0,
    tier: str = "interactive", seed: int = 0,
) -> List[WorkItem]:
    """Zipf-skewed hot-seed traffic, the answer-cache benchmark's stream.

    Draws a ``pool`` of weighted seed sets once, then each request's set
    from a Zipf(``skew``) rank law over the pool.  Repeated picks come
    with permuted seeds and rescaled weights, so a cache hit needs the
    canonical key, not equal bytes.  ``singles_fraction`` of the requests
    are the set's first seed alone."""
    rng = np.random.default_rng(seed)
    pool = max(1, pool)
    sizes = rng.integers(1, max_seeds + 1, pool)
    pool_seeds = [rng.integers(0, n_vertices, int(sz)).tolist()
                  for sz in sizes]
    pool_weights = [(rng.random(int(sz)) + 0.1).tolist() for sz in sizes]
    ranks = np.arange(1, pool + 1, dtype=np.float64) ** (-skew)
    picks = rng.choice(pool, size=n_requests, p=ranks / ranks.sum())
    items: List[WorkItem] = []
    for j in picks:
        s = pool_seeds[j]
        w = pool_weights[j]
        if singles_fraction > 0 and rng.random() < singles_fraction:
            items.append(int(s[0]))
            continue
        perm = rng.permutation(len(s))
        scale = float(rng.uniform(0.5, 2.0))
        items.append(dict(seeds=[s[i] for i in perm],
                          weights=[w[i] * scale for i in perm], tier=tier))
    return items


def run_open_loop(
    service, vertices: Sequence[WorkItem], qps: Optional[float] = None, *,
    sleep: Callable[[float], None] = time.sleep, max_sleep_s: float = 0.002,
) -> Tuple[list, dict]:
    """Offer ``vertices`` at ``qps`` (None: as fast as the loop runs);
    returns ``(answers, stats)`` once every request has been served.

    While the next arrival is not due the loop keeps polling, so finished
    batches are harvested and deadline-expired buffers flushed in the
    gaps.  Every request already due is submitted before the next poll,
    so a service that falls behind sees them arrive together.  Latency is
    measured from the scheduled offer time."""
    clock = service.clock
    answers: list = []
    t0 = clock()
    i = 0
    while i < len(vertices):
        if qps:
            now = clock()
            if now < t0 + i / qps:   # next arrival not due yet: keep serving
                answers.extend(service.poll())
                now = clock()
                t_sched = t0 + i / qps
                if now < t_sched:
                    sleep(min(t_sched - now, max_sleep_s))
                continue
            while i < len(vertices) and t0 + i / qps <= now:
                _submit(service, vertices[i], arrival=t0 + i / qps)
                i += 1
        else:
            _submit(service, vertices[i])
            i += 1
        answers.extend(service.poll())
    answers.extend(service.poll(force=True))
    wall = clock() - t0

    s = service.snapshot_stats()
    lat = [a.latency_s for a in answers]
    s["wall_s"] = wall
    # a cold service's first batch carries its graph captures: report the
    # throughput with and without it
    s["wall_s_excl_first_batch"] = max(wall - s["first_batch_service_s"],
                                       1e-9)
    s["offered_qps"] = float(qps) if qps else 0.0
    s["qps"] = len(answers) / max(wall, 1e-9)
    s["qps_excl_first_batch"] = len(answers) / s["wall_s_excl_first_batch"]
    s["latency_p50"] = _percentile(lat, 50)
    s["latency_p99"] = _percentile(lat, 99)
    return answers, s


def run_closed_loop(service, vertices: Sequence[WorkItem]
                    ) -> Tuple[list, dict]:
    """Serve a fixed workload to completion with no rate control."""
    return run_open_loop(service, vertices, qps=None)
