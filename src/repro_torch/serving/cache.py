"""LRU answer cache keyed on canonicalized seed sets.

PPR is scale-invariant in its restart distribution and blind to seed
order, so ``{a: 2, b: 1}``, ``[(b, 0.5), (a, 1.0)]``, and ``[a, a, b]``
(uniform) are all the *same* query.  :func:`canonicalize_seed_set` maps
every spelling onto one key — dedup-sum duplicate vertices, sort by vertex
id, normalize weights to sum 1, quantize — so hot seed sets hit one cache
entry no matter how clients spell them.  The quantization step
(``CacheConfig.weight_quantum``) bounds how far two weight vectors may
drift while still sharing an entry; the served answer is whichever
canonical-equivalent query was computed first, exact for every spelling
because the engine normalizes weights the same way.

The cache is consulted in ``PPRService.submit`` *before* a request reaches
the ``RequestBuffer`` — a hit skips batching, dispatch, and the device
entirely — and filled when computed answers are absorbed.  ``invalidate``
removes exactly the entries touching given vertices (the hook an evolving-
graph index update will call; today's staleness counter tracks how much it
drops).  Host-side and tiny: capacity entries of ``2 * k`` numbers each.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, Optional, OrderedDict, Sequence, Set, Tuple

import numpy as np

# (sorted unique vertex ids, matching quantized normalized weights)
CacheKey = Tuple[Tuple[int, ...], Tuple[int, ...]]


@dataclasses.dataclass
class CacheConfig:
    capacity: int = 0             # max cached answers; 0 disables the cache
    weight_quantum: float = 1e-4  # normalized-weight quantization step for
                                  # the cache key (1e-4 ~ 0.01% of restart
                                  # mass: far below any top-k rank change)


def canonicalize_seed_set(
    seeds: Sequence[int],
    weights: Optional[Sequence[float]] = None,
    *,
    weight_quantum: float = 1e-4,
) -> CacheKey:
    """Canonical cache key of a weighted seed set.

    Dedup-sums duplicate vertices (a vertex listed twice carries the sum of
    its weights — same semantics as the engine's scatter-add seeding),
    drops weight-0 pad slots, sorts by vertex id, normalizes to sum 1, and
    quantizes to ``weight_quantum`` steps.  Permutations, rescalings, and
    duplicate spellings of one distribution all map to the same key.
    ``weights=None`` means uniform.  All-zero / empty seed sets map to the
    empty key ``((), ())`` (never cached — nothing to answer).
    """
    s = np.asarray(seeds, dtype=np.int64).reshape(-1)
    w = (
        np.ones(s.shape, np.float64) if weights is None
        else np.asarray(weights, dtype=np.float64).reshape(-1)
    )
    if w.shape != s.shape:
        raise ValueError(f"weights shape {w.shape} != seeds shape {s.shape}")
    keep = w > 0
    s, w = s[keep], w[keep]
    if s.size == 0:
        return ((), ())
    uniq, inv = np.unique(s, return_inverse=True)
    acc = np.zeros(uniq.shape, np.float64)
    np.add.at(acc, inv, w)
    acc /= acc.sum()
    q = np.round(acc / max(weight_quantum, 1e-30)).astype(np.int64)
    return (
        tuple(int(v) for v in uniq),
        tuple(int(x) for x in q),
    )


class AnswerCache:
    """LRU map ``CacheKey -> (top_vertices, top_scores)`` with a reverse
    vertex index for exact invalidation.

    Counters (all monotonic): ``hits`` / ``misses`` (get outcomes),
    ``evictions`` (capacity pressure), ``invalidated`` (entries dropped by
    :meth:`invalidate` — the staleness ledger for index updates).
    """

    def __init__(self, cfg: Optional[CacheConfig] = None):
        self.cfg = cfg or CacheConfig()
        self._data: OrderedDict[CacheKey, Tuple[np.ndarray, np.ndarray]] = (
            collections.OrderedDict()
        )
        # seed vertex -> keys of cached entries whose seed set contains it
        self._by_vertex: Dict[int, Set[CacheKey]] = {}
        self.stats: Dict[str, int] = dict(
            hits=0, misses=0, evictions=0, invalidated=0,
        )
        # bumped whenever cached semantics change (invalidate / clear /
        # an index update): in-flight batches dispatched under an older
        # epoch must not be absorbed (the invalidate-vs-in-flight race —
        # see ServingPipeline's epoch stamping and PPRService._absorb)
        self.epoch: int = 0

    @property
    def enabled(self) -> bool:
        return self.cfg.capacity > 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: CacheKey) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Answer for ``key`` (freshening its LRU position), or None."""
        if not self.enabled:
            return None
        hit = self._data.get(key)
        if hit is None:
            self.stats["misses"] += 1
            return None
        self._data.move_to_end(key)
        self.stats["hits"] += 1
        return hit

    def put(
        self, key: CacheKey, top_vertices: np.ndarray, top_scores: np.ndarray
    ) -> None:
        """Insert/refresh an answer; evicts LRU entries over capacity."""
        if not self.enabled or not key[0]:
            return
        # copies: cached answers must not alias the (reused) batch buffers
        self._data[key] = (
            np.array(top_vertices, copy=True),
            np.array(top_scores, copy=True),
        )
        self._data.move_to_end(key)
        for v in key[0]:
            self._by_vertex.setdefault(v, set()).add(key)
        while len(self._data) > self.cfg.capacity:
            old_key, _ = self._data.popitem(last=False)
            self._unindex(old_key)
            self.stats["evictions"] += 1

    def invalidate(self, vertices: Iterable[int]) -> int:
        """Drop every cached entry whose *seed set* contains any of
        ``vertices``; returns how many entries were removed.

        This is the hook an index/graph update calls: an answer is stale
        once any of its seeds' fingerprints changed.  (Answers whose *top-k
        results* mention a vertex are not tracked — that inversion costs
        k entries per answer; seed-level invalidation is the conservative
        contract the evolving-graph follow-up needs first.)
        """
        doomed: Set[CacheKey] = set()
        for v in vertices:
            doomed |= self._by_vertex.get(int(v), set())
        removed = 0
        for key in doomed:
            # count only entries actually live in the LRU map: a reverse-
            # index entry without a live answer (were the index ever to
            # drift) must not inflate the staleness ledger
            if self._data.pop(key, None) is not None:
                removed += 1
            self._unindex(key)
        self.stats["invalidated"] += removed
        self.epoch += 1
        return removed

    def clear(self) -> None:
        self._data.clear()
        self._by_vertex.clear()
        self.epoch += 1

    def reverse_index_entries(self) -> int:
        """Total ``(vertex -> key)`` links — must equal the live entries'
        seed-set sizes (see :meth:`check_integrity`)."""
        return sum(len(ks) for ks in self._by_vertex.values())

    def check_integrity(self) -> None:
        """Assert the reverse index exactly mirrors the live entries.

        Every live key contributes one bucket link per seed vertex and
        nothing else: ``sum(len(bucket)) == sum(len(key.seeds))``, no
        empty buckets linger, and every bucket link points at a live
        entry that really contains the bucket's vertex.  O(entries * S);
        called from ``PPRService.snapshot_stats`` so churn regressions
        (eviction or invalidation leaving stale links) fail loudly.
        """
        live_links = sum(len(key[0]) for key in self._data)
        got = self.reverse_index_entries()
        assert got == live_links, (
            f"reverse index holds {got} links, live entries imply "
            f"{live_links}")
        for v, ks in self._by_vertex.items():
            assert ks, f"empty bucket left behind for vertex {v}"
            for key in ks:
                assert key in self._data, (
                    f"stale bucket link {key} for vertex {v}")
                assert v in key[0], (
                    f"bucket {v} links key {key} that does not seed it")

    def _unindex(self, key: CacheKey) -> None:
        for v in key[0]:
            ks = self._by_vertex.get(v)
            if ks is not None:
                ks.discard(key)
                if not ks:
                    del self._by_vertex[v]
