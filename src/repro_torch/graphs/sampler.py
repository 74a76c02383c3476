"""Neighbour samplers for GNN minibatch training, host numpy.

The classic GraphSAGE uniform fanout sampler, and a PPR-importance sampler
on the PowerWalk index (the PPRGo lineage).  Sampling runs on the host and
emits fixed-shape padded blocks; it is deterministic given ``(seed,
step)``, so a data pipeline resumes by replaying its step.  The numpy
draws and arithmetic are the reference's (``repro.graphs.sampler``), so
both packages give the same arrays bit for bit; the importance sampler
keeps ``np.argsort``, whose tie order on the index's integer-count values
``torch.argsort`` would not reproduce.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One message-passing layer block, of fixed shapes.

    nodes:     int32[n_dst + n_dst * fanout] node ids of the block (the
               first n_dst are the destinations); a seed with no
               out-neighbour samples node 0, masked.
    edge_src:  int32[n_dst * fanout] positions into ``nodes``.
    edge_dst:  int32[n_dst * fanout] positions into the first n_dst entries.
    edge_mask: f32[n_dst * fanout] 1.0 for real sampled edges.
    """

    nodes: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray


def _sample_neighbors(row_ptr: np.ndarray, col_idx: np.ndarray,
                      seeds: np.ndarray, fanout: int,
                      rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform with-replacement fanout sample: ``(nbrs, mask)``."""
    deg = row_ptr[seeds + 1] - row_ptr[seeds]
    # random offsets in [0, deg); deg == 0 -> masked out
    offs = (rng.random((len(seeds), fanout))
            * np.maximum(deg, 1)[:, None]).astype(np.int64)
    nbrs = col_idx[row_ptr[seeds][:, None] + offs]
    mask = (deg > 0)[:, None].astype(np.float32) * np.ones(
        (1, fanout), np.float32)
    nbrs = np.where(mask > 0, nbrs, 0)
    return nbrs.astype(np.int32), mask


def fanout_sample(graph: Graph, batch_nodes: np.ndarray,
                  fanouts: Sequence[int], seed: int = 0,
                  step: int = 0) -> List[SampledBlock]:
    """Multi-hop fanout sampling, innermost layer first (GraphSAGE order):
    one :class:`SampledBlock` per fanout, the outermost hop last (the model
    consumes them in reverse).  Reads the graph's CSR to the host."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    row_ptr = graph.row_ptr.cpu().numpy().astype(np.int64)
    col_idx = graph.col_idx.cpu().numpy().astype(np.int64)
    blocks: List[SampledBlock] = []
    frontier = np.asarray(batch_nodes, dtype=np.int64)
    for fanout in fanouts:
        nbrs, mask = _sample_neighbors(row_ptr, col_idx, frontier, fanout,
                                       rng)
        n_dst = len(frontier)
        nodes = np.concatenate([frontier, nbrs.reshape(-1)])
        blocks.append(SampledBlock(
            nodes=nodes.astype(np.int32),
            edge_src=np.arange(n_dst, n_dst + n_dst * fanout,
                               dtype=np.int32),
            edge_dst=np.repeat(np.arange(n_dst, dtype=np.int32), fanout),
            edge_mask=mask.reshape(-1)))
        frontier = nodes  # the next hop expands from all block nodes
    return blocks


def ppr_importance_sample(index_values: np.ndarray,
                          index_indices: np.ndarray,
                          batch_nodes: np.ndarray,
                          budget: int) -> Tuple[np.ndarray, np.ndarray]:
    """PPRGo-style sampling: the ``budget`` highest-PPR neighbours of each
    seed in the top-L index ``index_values / index_indices [n, L]``
    (numpy).  Returns ``(nbr_ids int32[batch, budget], weights f32[batch,
    budget])``, the weights normalized to sum to one a row: a fixed-shape
    neighbourhood for one PPR-weighted aggregation
    (``models.gcn.ppr_propagate``)."""
    vals = index_values[batch_nodes]  # [b, L]
    idxs = index_indices[batch_nodes]
    b = min(budget, vals.shape[1])
    top = np.argsort(-vals, axis=1)[:, :b]
    rows = np.arange(len(batch_nodes))[:, None]
    w = vals[rows, top]
    nbr = idxs[rows, top]
    norm = np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return nbr.astype(np.int32), (w / norm).astype(np.float32)
