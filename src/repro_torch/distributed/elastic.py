"""Elastic scaling and straggler mitigation planning (the reference's
``distributed/elastic.py``, pure Python, copied).

Elasticity is a restart onto a new mesh from the latest committed
checkpoint:

  1. the watchdog (:class:`StepTimer`) detects a failure or a persistent
     straggler,
  2. :func:`plan_mesh` picks the largest usable (data x model) grid for the
     surviving device count, holding the model axis fixed if possible,
  3. the checkpoint is restored with ``shard_fn`` placing the leaves for
     the new mesh (``Checkpointer.restore``),
  4. the per-step batch is kept by raising gradient accumulation
     (``microbatches``) to cover the lost data-parallel ranks.

The restart loop lives in ``launch/train.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices_used: int
    devices_idle: int
    microbatch_scale: int      # grad-accum multiplier to keep global batch


def plan_mesh(
    n_devices: int,
    *,
    model_parallel: int = 16,
    prior_data_parallel: Optional[int] = None,
    pods: int = 1,
) -> MeshPlan:
    """Largest (pod, data, model) grid that fits ``n_devices``.

    The model axis is held at ``model_parallel`` (param shardings survive);
    data parallelism shrinks to the largest multiple that fits.  If fewer
    than one model group survives, model_parallel halves until it fits —
    that changes param shardings but restore handles it (host resharding).
    """
    mp = model_parallel
    while mp > 1 and n_devices < mp:
        mp //= 2
    per_pod = n_devices // pods
    dp = max(per_pod // mp, 1)
    used = pods * dp * mp
    scale = 1
    if prior_data_parallel is not None and dp * pods < prior_data_parallel:
        scale = math.ceil(prior_data_parallel / (dp * pods))
    if pods > 1:
        return MeshPlan((pods, dp, mp), ("pod", "data", "model"),
                        used, n_devices - used, scale)
    return MeshPlan((dp, mp), ("data", "model"), used, n_devices - used, scale)


def degraded_sequence(
    total: int, failures: Sequence[int], **kw
) -> List[MeshPlan]:
    """Mesh plans after each cumulative failure count (capacity ladder)."""
    plans = []
    n = total
    for f in failures:
        n -= f
        plans.append(plan_mesh(max(n, 1), **kw))
    return plans


# ---------------------------------------------------------------------------
# Straggler watchdog
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepTimer:
    """Deterministic step-time watchdog.

    Rolling median of step times; a step slower than ``threshold`` x median
    raises a straggler flag.  Two standard mitigations are encoded as
    recommendations the trainer acts on:
      * ``"checkpoint"`` — persistent slowness: snapshot now, plan restart,
      * ``"rebalance"`` — transient: re-issue the same step (XLA retries) /
        shift the data shard (for host-side input stalls).
    """

    window: int = 32
    threshold: float = 2.0
    _times: list = dataclasses.field(default_factory=list)
    slow_streak: int = 0

    def record(self, seconds: float) -> Optional[str]:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 8:
            return None
        med = sorted(self._times)[len(self._times) // 2]
        if seconds > self.threshold * med:
            self.slow_streak += 1
        else:
            self.slow_streak = 0
        if self.slow_streak >= 3:
            return "checkpoint"   # persistent straggler: snapshot + replan
        if self.slow_streak == 1:
            return "rebalance"
        return None

    @property
    def median(self) -> float:
        ts = sorted(self._times)
        return ts[len(ts) // 2] if ts else 0.0
