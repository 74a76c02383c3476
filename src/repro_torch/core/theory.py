"""Theorem 2.1 machinery: concentration bound and walk planning.

    Pr[p_hat_u(v) - p_u(v) >= g] <= (1/sqrt(c)) (1 + g c / 10) exp(-g^2 R / 20)

The bound is *per entry* and symmetric (same for under-estimation).  The
planner inverts it: the number of walks needed for additive error ``g`` with
failure probability ``delta``.  ``mcep_equivalent_walks`` reproduces the
paper's headline ratio (1000 MCFP walks ~ 6700 MCEP walks): MCFP sees
``R / c`` positions per ``R`` walks, so sample efficiency scales by ``1/c``.

Host arithmetic only: the port's copy of ``repro.core.theory``.
"""

from __future__ import annotations

import math

from repro_torch.core.walks import DEFAULT_C


def overestimate_bound(gamma: float, r: int, c: float = DEFAULT_C) -> float:
    """RHS of Theorem 2.1 (also the under-estimation bound)."""
    if gamma < 0:
        raise ValueError("gamma must be >= 0")
    return (
        (1.0 / math.sqrt(c))
        * (1.0 + gamma * c / 10.0)
        * math.exp(-(gamma ** 2) * r / 20.0)
    )


def two_sided_bound(gamma: float, r: int, c: float = DEFAULT_C) -> float:
    return min(1.0, 2.0 * overestimate_bound(gamma, r, c))


def walks_required(
    gamma: float, delta: float, c: float = DEFAULT_C
) -> int:
    """Smallest R with two_sided_bound(gamma, R) <= delta (closed form)."""
    if not (0 < delta < 1):
        raise ValueError("delta in (0,1)")
    coeff = 2.0 * (1.0 + gamma * c / 10.0) / math.sqrt(c)
    r = 20.0 / (gamma ** 2) * math.log(coeff / delta)
    return max(int(math.ceil(r)), 1)


def mcep_equivalent_walks(r_mcfp: int, c: float = DEFAULT_C) -> int:
    """MCEP walks matching the sample count of ``r_mcfp`` MCFP walks.

    Each MCFP walk contributes ``1/c`` (dependent) sample positions versus
    MCEP's single endpoint; the paper measures the dependent samples to be
    nearly as informative (Section 4.2: 1000 vs 6700 at c = 0.15).
    """
    return int(round(r_mcfp / c))


def expected_walk_length(c: float = DEFAULT_C) -> float:
    """Mean positions per walk: geometric(c) => 1/c."""
    return 1.0 / c


def max_steps_for_tail(tail: float, c: float = DEFAULT_C) -> int:
    """Steps needed so the truncated tail mass (1-c)^T <= tail."""
    return int(math.ceil(math.log(tail) / math.log(1.0 - c)))


def index_error_bound(
    r: int, gamma: float, c: float = DEFAULT_C
) -> float:
    """Union-style heuristic for the top-L index: per-entry failure prob at
    additive error gamma, given R walks (used by the budget planner to
    annotate plans)."""
    return two_sided_bound(gamma, r, c)


def verd_error_factor(t: int, c: float = DEFAULT_C) -> float:
    """Per-iteration error contraction of the decomposition (Section 2.3):
    after T unfoldings the index error enters scaled by (1-c)^T."""
    return (1.0 - c) ** t
