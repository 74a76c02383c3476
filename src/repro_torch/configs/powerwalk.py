"""The paper's own workload configs (Table 1 graphs + engine settings).

The small graphs run for real (accuracy benchmarks); the billion-edge
graphs exist as *shape* configs for the dry-run/roofline of the PPR engine
itself (walk engine + VERD batch query on the production mesh).

The port's own copy of the reference's data, field for field; like the
reference's, it stays out of ``configs.REGISTRY``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    n: int
    m: int
    runnable: bool          # small enough to materialize in this container


# Paper Table 1
PAPER_GRAPHS: Dict[str, GraphShape] = {
    "wiki-Vote": GraphShape("wiki-Vote", 7_115, 103_689, True),
    "web-BerkStan": GraphShape("web-BerkStan", 685_230, 7_600_595, False),
    "web-Google": GraphShape("web-Google", 875_713, 5_105_039, False),
    "uk-1m": GraphShape("uk-1m", 1_000_000, 41_247_159, False),
    "twitter-2010": GraphShape("twitter-2010", 41_652_230, 1_468_365_182, False),
    "uk-union": GraphShape("uk-union", 133_633_040, 5_507_679_822, False),
}


@dataclasses.dataclass(frozen=True)
class PowerWalkEngineConfig:
    """Engine knobs (paper defaults)."""
    c: float = 0.15
    r_offline: int = 100          # walks/vertex for the index (paper's sweet spot)
    index_l: int = 667            # ~R/c nonzeros per fingerprint
    t_online: int = 2             # VERD iterations at R=100 (paper 4.2)
    max_walk_steps: int = 64      # tail (1-c)^64 ~ 3e-5
    query_batch: int = 10_000     # paper's headline batch size
    top_k: int = 200


@dataclasses.dataclass(frozen=True)
class PPRDryRunShape:
    """Shape cell for the distributed PPR engine dry-run."""
    name: str
    n: int                        # vertices
    ell_rows: int                 # chunked-ELL rows (~m / k + n)
    ell_k: int
    queries: int
    index_l: int
    walks_per_shard: int


def engine_dryrun_shapes() -> Tuple[PPRDryRunShape, ...]:
    """twitter-2010-scale VERD batch query + MCFP walk cells."""
    tw = PAPER_GRAPHS["twitter-2010"]
    uk = PAPER_GRAPHS["uk-union"]
    return (
        PPRDryRunShape(
            name="twitter_q10k",
            n=tw.n, ell_rows=tw.m // 16 + tw.n, ell_k=16,
            queries=10_000, index_l=667, walks_per_shard=1 << 20,
        ),
        PPRDryRunShape(
            name="ukunion_q10k",
            n=uk.n, ell_rows=uk.m // 32 + uk.n, ell_k=32,
            queries=10_000, index_l=667, walks_per_shard=1 << 20,
        ),
    )
