"""Fixed-width sparse frontiers: ``values f32[Q, K]`` + ``indices int32[Q, K]``.

Empty slots carry ``(0.0, 0)``.  :func:`compact_arrays` (dedup ->
threshold -> top-K) is the one re-compaction law every push, combine and
sketch fold applies; the CUDA kernels implement the same law.

Order contract (``jax.lax.top_k``'s): positive entries by value descending,
ties by column ascending, then ``(0.0, 0)`` pads.  ``torch.topk`` does not
keep that order, so the top-k here is a stable descending sort over the
column-sorted merge.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SparseFrontier:
    """Batch of fixed-width sparse row vectors (values f32, indices int32)."""

    values: torch.Tensor
    indices: torch.Tensor
    k: int
    n: int

    @property
    def nbytes(self) -> int:
        return self.values.shape[0] * self.k * 8

    def mass(self) -> torch.Tensor:
        return self.values.sum(dim=1)

    def densify(self) -> torch.Tensor:
        """Scatter back to ``f32[Q, n]`` (oracle / error measurement)."""
        q = self.values.shape[0]
        out = torch.zeros((q, self.n), dtype=self.values.dtype,
                          device=self.values.device)
        return out.scatter_add_(1, self.indices.long(), self.values)


def from_sources(sources: torch.Tensor, n: int) -> SparseFrontier:
    """Width-1 one-hot frontier: each query starts at its source vertex."""
    fv = torch.ones((sources.shape[0], 1), dtype=torch.float32,
                    device=sources.device)
    fi = sources.reshape(-1, 1).to(torch.int32)
    return SparseFrontier(values=fv, indices=fi, k=1, n=n)


def from_seed_sets(
    seeds: torch.Tensor, weights: torch.Tensor, n: int
) -> SparseFrontier:
    """Width-``S`` weighted frontier: each query starts at its seed set
    (weight-0 pad slots are the empty-slot convention)."""
    return SparseFrontier(
        values=weights.to(torch.float32), indices=seeds.to(torch.int32),
        k=int(seeds.shape[1]), n=n,
    )


def merge_duplicates(
    values: torch.Tensor, indices: torch.Tensor, *, ordered: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold duplicate column hits within each row into one slot: stable
    sort by column, sum each run into its leader, zero the rest.  Width is
    preserved; empty slots stay ``(0.0, 0)``.  A run sums in slot order
    (``scatter_add_``: on CUDA its atomics add in no fixed order, so a run
    of inexact sums can round differently from run to run); ``ordered``
    sums each run as a difference of float64 prefix sums, rounded once:
    the same bits on every run on any device, equal to the slot-order sum
    wherever that is exact and within its rounding otherwise."""
    q, w = values.shape
    if w == 0:
        return values, indices
    si, order = torch.sort(indices, dim=1, stable=True)
    sv = torch.gather(values, 1, order)
    is_new = torch.ones_like(si, dtype=torch.bool)
    is_new[:, 1:] = si[:, 1:] != si[:, :-1]
    pos = torch.arange(w, device=values.device).expand(q, w)
    leader = torch.cummax(torch.where(is_new, pos, 0), dim=1).values
    if ordered:
        # a run's sum is the difference of float64 prefix sums at its ends,
        # rounded once, added to its leader by the run's last slot alone
        # (the others add +0.0): exact whatever order the adds land in
        cs = torch.cumsum(sv.to(torch.float64), dim=1)
        before = torch.where(leader > 0,
                             cs.gather(1, (leader - 1).clamp(min=0)), 0.0)
        is_last = torch.ones_like(is_new)
        is_last[:, :-1] = is_new[:, 1:]
        sv = torch.where(is_last, (cs - before).to(sv.dtype), 0.0)
    summed = torch.zeros_like(sv).scatter_add_(1, leader, sv)
    out_v = torch.where(is_new, summed, 0.0)
    out_i = torch.where(is_new & (out_v > 0), si, 0)
    return out_v, out_i


def topk_compact(
    values: torch.Tensor, indices: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` entries of each row, descending (ties: lower slot first),
    no dedup; rows narrower than ``k`` are right-padded with empty slots."""
    q, w = values.shape
    kk = min(k, w)
    vals, sel = torch.sort(values, dim=1, descending=True, stable=True)
    vals, sel = vals[:, :kk], sel[:, :kk]
    idxs = torch.gather(indices, 1, sel)
    idxs = torch.where(vals > 0, idxs, 0).to(torch.int32)
    if w < k:
        pv = torch.zeros((q, k - w), dtype=vals.dtype, device=vals.device)
        pi = torch.zeros((q, k - w), dtype=torch.int32, device=vals.device)
        return torch.cat([vals, pv], dim=1), torch.cat([idxs, pi], dim=1)
    return vals, idxs


def topk_dense(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of dense rows: the ``k`` largest values per row,
    ties by column ascending, indices int32 (``k <= x.shape[-1]``).

    One ``torch.topk`` over unique int64 keys: the f32 value's bits mapped
    to an order-preserving int32 in the high word, the complemented column
    in the low word, so equal values rank by lower column first, exactly
    on ties (cheaper than a stable descending sort of the whole row).
    """
    keys = x.contiguous().view(torch.int32).to(torch.int64)
    keys ^= (keys >> 31) & 0x7FFFFFFF          # negative floats: flip order
    keys <<= 32
    keys |= 0xFFFFFFFF - torch.arange(x.shape[-1], dtype=torch.int64,
                                      device=x.device)
    top = torch.topk(keys, k, dim=-1, sorted=True).values
    idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def threshold_values(values: torch.Tensor, threshold: float) -> torch.Tensor:
    """Epsilon sparsification (paper Section 3.3): zero entries below eps."""
    if threshold <= 0.0:
        return values
    return torch.where(values >= threshold, values, 0.0)


def compact_arrays(
    values: torch.Tensor, indices: torch.Tensor, k: int,
    *, threshold: float = 0.0, ordered: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedup -> epsilon-threshold -> top-K: the shared re-compaction law
    (``ordered``: :func:`merge_duplicates`')."""
    v, i = merge_duplicates(values, indices, ordered=ordered)
    v = threshold_values(v, threshold)
    return topk_compact(v, i, k)


def compact(
    values: torch.Tensor, indices: torch.Tensor, k: int, n: int,
    *, threshold: float = 0.0,
) -> SparseFrontier:
    """:func:`compact_arrays` wrapped into a :class:`SparseFrontier`."""
    v, i = compact_arrays(values, indices, k, threshold=threshold)
    return SparseFrontier(values=v, indices=i, k=v.shape[1], n=n)


def fold_topk(run_v, run_i, add_v, add_i, k: int):
    """Fold candidates into a running top-``k`` sketch; returns ``(values,
    indices, dropped)`` with ``dropped`` the mass this fold truncated."""
    cand_v = torch.cat([run_v, add_v], dim=1)
    cand_i = torch.cat([run_i, add_i], dim=1)
    out_v, out_i = compact_arrays(cand_v, cand_i, k)
    dropped = cand_v.sum(dim=1) - out_v.sum(dim=1)
    return out_v, out_i, torch.clamp(dropped, min=0.0)


def merge_sketch_parts(values, indices, dropped, k: int):
    """Dedup-merge concatenated sketch parts back to width ``k``, adding
    this merge's truncation to the running ``dropped`` ledger."""
    out_v, out_i = compact_arrays(values, indices, k)
    dropped = dropped + torch.clamp(
        values.sum(dim=1) - out_v.sum(dim=1), min=0.0
    )
    return out_v, out_i, dropped


def bucket_by_owner(
    values: torch.Tensor, indices: torch.Tensor, ep: int, n_shard: int,
    k: int, *, to_local: bool = True, ordered: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, owner) top-``k`` buckets: the distributed wire format.

    ``indices`` are global columns in ``[0, ep * n_shard)``, owner ``o``
    holding ``[o * n_shard, (o + 1) * n_shard)``; ``values`` are f32
    masses (``>= 0``).  One global :func:`merge_duplicates`, then each owner's
    positive entries in descending value, ties in slot order (the order
    a masked :func:`topk_compact` of each owner gives), all owners from
    one sort of ``(owner, value)`` keys.  Returns ``(vals f32[Q, ep, k],
    idx int32[Q, ep, k])``, indices owner-local with ``to_local``; empty
    slots ``(0.0, 0)``.  Exact when ``k >= n_shard``.  ``ordered``:
    :func:`merge_duplicates`'.
    """
    values, indices = merge_duplicates(values, indices, ordered=ordered)
    q, dev = values.shape[0], values.device
    owner = torch.where(values > 0, torch.div(
        indices, n_shard, rounding_mode="floor"), ep).to(torch.int64)
    # a non-negative f32's bits order as its value: owner ascending, then
    # value descending, empty slots (owner ep) last; stable, so ties keep
    # their slot order
    bits = values.view(torch.int32).to(torch.int64)
    keys, order = torch.sort(owner * (1 << 31) + ((1 << 31) - 1 - bits),
                             dim=1, stable=True)
    values, indices = values.gather(1, order), indices.gather(1, order)
    # each owner's first sorted slot: its run starts where the keys pass it
    first = torch.searchsorted(keys, torch.arange(
        ep + 1, device=dev).expand(q, ep + 1).contiguous() * (1 << 31))
    live = first[:, 1:] - first[:, :-1]
    j = torch.arange(k, device=dev)
    take = j < live[:, :, None]                            # [Q, ep, k]
    slot = torch.where(take, first[:, :-1, None] + j, 0).reshape(q, ep * k)
    out_v = torch.where(take, values.gather(1, slot).reshape(q, ep, k), 0.0)
    out_i = indices.gather(1, slot).reshape(q, ep, k)
    if to_local:
        out_i = out_i - torch.arange(ep, device=dev)[:, None] * n_shard
    return out_v, torch.where(take, out_i, 0).to(torch.int32)
