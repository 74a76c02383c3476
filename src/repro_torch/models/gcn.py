"""GCN (Kipf & Welling, arXiv:1609.02907): message passing as bag sums.

Three execution modes, as in the reference (``repro.models.gcn``):

* **full-batch** (cora, ogb_products): symmetric-normalized propagation
  ``H' = D~^-1/2 A~ D~^-1/2 H W`` over the full edge list;
* **sampled minibatch** (minibatch_lg): mean aggregation over the fixed
  shape blocks of ``graphs.sampler.fanout_sample``;
* **batched small graphs** (molecule): block-diagonal edges, then a
  per-graph mean readout and a classification head.

``ppr_propagate`` replaces multi-hop propagation with one PPR-weighted
aggregation over the PowerWalk index (the APPNP / PPRGo lineage).

Every aggregation is a weighted bag sum, one ``ops.embedding_bag`` launch:
:func:`segment_bags` turns an edge list into fixed-width bags by a stable
sort on the destination (each destination's edges in edge order, as the
reference's ``segment_sum`` adds them), so no ``[m, d]`` message tensor is
formed, and the gradient with respect to the gathered table is the
``embedding_bag_backward`` kernel, which sums each row's slots in order:
no float atomics, so a step gives the same bytes twice.  Degrees are
integer counts (exact in any order), summed by a scatter-add, which
unlike ``bincount`` reads nothing on the host to size its output.  On the
meta device (the dry-run) a bag layout has no data to read its width
from: :func:`host_twins` gives each destination array its host copy,
whose widest in-degree is the width the step would read.  The reference's unused
``_propagate`` and its config's ``dropout`` and ``param_dtype`` (the
parameters are f32) are not carried.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    n_layers: int
    d_feat: int
    d_hidden: int
    n_classes: int
    aggregator: str = "mean"        # mean | sym
    compute_dtype: Any = torch.float32
    readout: Optional[str] = None   # None | "mean" (graph-level)

    def dims(self):
        return ([self.d_feat] + [self.d_hidden] * (self.n_layers - 1)
                + [self.n_classes])

    def param_count(self) -> int:
        dims = self.dims()
        return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def init(cfg: GCNConfig, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """``layer_i``: ``{w [d_in, d_out], b}`` of ``layers.dense_init``, f32,
    drawn from ``seed`` on ``device``."""
    gen = seeded_generator(resolve_device(device), seed)
    dims = cfg.dims()
    return {f"layer_{i}": L.dense_init(gen, dims[i], dims[i + 1], bias=True)
            for i in range(len(dims) - 1)}


# the dry-run's host copies of meta destination arrays: id -> CPU tensor
_twins: Dict[int, torch.Tensor] = {}


@contextlib.contextmanager
def host_twins(pairs) -> Iterator[None]:
    """Inside, each meta destination array of ``pairs`` (``(meta, cpu)``)
    lays out its bags at the width of its host copy (the dry-run's)."""
    keys = []
    for meta, cpu in pairs:
        _twins[id(meta)] = cpu
        keys.append(id(meta))
    try:
        yield
    finally:
        for k in keys:
            _twins.pop(k, None)


def _bin_counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``int64[n]``: the occurrences of each value of ``idx`` (all in
    ``[0, n)``)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def edge_counts(index: torch.Tensor, mask: Optional[torch.Tensor],
                n: int) -> torch.Tensor:
    """``f32[n]``: the edges at each of ``index``'s ``n`` values whose
    ``mask`` (a 0/1 edge mask, ``None``: all) is non-zero; values outside
    ``[0, n)`` count nowhere, as ``segment_sum`` drops them."""
    idx = index.long()
    if mask is not None:
        idx = torch.where(mask != 0, idx, n)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    return _bin_counts(idx, n + 1)[:n].to(torch.float32)


def segment_bags(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 weight: Optional[torch.Tensor], n: int,
                 n_src: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge list as fixed-width bags: ``(ids int32[n, B], weights
    f32[n, B])`` with ``B`` the widest in-degree (at least 1), row ``r``
    holding the sources and weights (``None``: ones) of the edges into
    ``r`` in edge order (a stable sort on the destination), so
    ``embedding_bag(ids, weights, h)`` is ``segment_sum(h[src] * weight,
    dst, n)``.  A padding slot has weight 0 and the id of its own row
    (modulo ``n_src``, the table's rows, ``n`` by default): an id in range,
    so no NaN row enters the sum, and spread over the rows, so the backward
    finds no long run of padding on one row.  Destinations must lie in
    ``[0, n)``."""
    dev = edge_dst.device
    m = edge_dst.shape[0]
    n_src = n if n_src is None else n_src
    dst, order = torch.sort(edge_dst.to(torch.int32), stable=True)
    dst = dst.long()
    if dev.type == "meta":    # no data: the width of the host copy
        twin = _twins.get(id(edge_dst))
        if twin is None:
            raise ValueError("segment_bags on meta needs the destination "
                             "array's host copy (gcn.host_twins)")
        counts = _bin_counts(dst, n)
        width = max(int(torch.bincount(twin.long(), minlength=n).max()), 1) \
            if n else 1
    else:
        counts = torch.bincount(dst, minlength=n)
        if counts.numel() != n:
            raise ValueError(
                f"segment_bags: a destination lies outside [0, {n})")
        width = max(int(counts.max()), 1) if n else 1   # reads the host
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(m, device=dev) - starts[dst]
    ids = (torch.arange(n, device=dev) % max(n_src, 1)).to(
        torch.int32)[:, None].repeat(1, width)
    w = torch.zeros((n, width), dtype=torch.float32, device=dev)
    ids[dst, rank] = edge_src[order].to(torch.int32)
    w[dst, rank] = (1.0 if weight is None
                    else weight[order].to(torch.float32))
    return ids, w


def aggregate(ids: torch.Tensor, weights: torch.Tensor,
              h: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_i weights[r, i] * h[ids[r, i]]`` in ``h``'s dtype:
    one ``embedding_bag`` launch, whose gradient with respect to ``h`` is
    one ``embedding_bag_backward`` launch."""
    return ops.embedding_bag(ids, weights, h.float(), row_dtype=h.dtype,
                             out_dtype=h.dtype)


def sym_norm_coeffs(edge_src, edge_dst, n, edge_mask=None):
    """``1/sqrt(d~_src d~_dst)`` per edge plus ``1/d~_v`` self-loop weights,
    ``d~ = deg + 1`` (the ``A~ = A + I`` normalization); masked (padding)
    edges count toward no degree."""
    inv_sq_in = torch.rsqrt(edge_counts(edge_dst, edge_mask, n) + 1.0)
    inv_sq_out = torch.rsqrt(edge_counts(edge_src, edge_mask, n) + 1.0)
    w_edge = inv_sq_out[edge_src.long()] * inv_sq_in[edge_dst.long()]
    return w_edge, inv_sq_in * inv_sq_out


def forward_full(cfg: GCNConfig, params, features, edge_src, edge_dst,
                 edge_mask=None) -> torch.Tensor:
    """Full-graph forward, ``features [N, F] -> logits [N, C]``: the bags
    are laid out once and every layer aggregates through them."""
    n = features.shape[0]
    h = features.to(cfg.compute_dtype)
    if cfg.aggregator == "sym":
        w_edge, w_self = sym_norm_coeffs(edge_src, edge_dst, n, edge_mask)
    else:  # mean over in-neighbours (+ self)
        deg = edge_counts(edge_dst, edge_mask, n) + 1.0
        w_edge, w_self = 1.0 / deg[edge_dst.long()], 1.0 / deg
    if edge_mask is not None:
        w_edge = w_edge * edge_mask
    ids, w = segment_bags(edge_src, edge_dst, w_edge, n)
    for i in range(cfg.n_layers):
        agg = aggregate(ids, w, h) + h * w_self[:, None].to(h.dtype)
        h = L.dense_apply(params[f"layer_{i}"], agg,
                          compute_dtype=cfg.compute_dtype)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def loss_full(cfg: GCNConfig, params, batch) -> torch.Tensor:
    """batch: features, edge_src, edge_dst, [edge_mask], and labels [N]
    with label_mask [N], or (``readout == "mean"``) graph_ids [N] and
    graph_labels [G]."""
    logits = forward_full(cfg, params, batch["features"], batch["edge_src"],
                          batch["edge_dst"], batch.get("edge_mask"))
    if cfg.readout == "mean":
        # graph-level: the mean of each graph's logits, then classify
        gid = batch["graph_ids"]
        n_graphs = batch["graph_labels"].shape[0]
        nodes = torch.arange(logits.shape[0], device=logits.device)
        ids, w = segment_bags(nodes, gid, None, n_graphs,
                              n_src=logits.shape[0])
        cnt = edge_counts(gid, None, n_graphs).to(logits.dtype)
        pooled = aggregate(ids, w, logits) / torch.clamp(cnt, min=1.0)[:, None]
        return L.softmax_cross_entropy(pooled, batch["graph_labels"])
    return L.softmax_cross_entropy(logits, batch["labels"],
                                   batch.get("label_mask"))


def forward_sampled(cfg: GCNConfig, params, block_feats: Sequence,
                    blocks_edges: Sequence[dict]) -> torch.Tensor:
    """Minibatch forward over sampled blocks (innermost hop last):
    ``block_feats[-1]`` holds the outermost block's node features;
    ``blocks_edges[i]``: ``dict(edge_src, edge_dst, edge_mask, n_dst)``,
    consumed outermost first (layer ``i`` aggregates block ``-(i + 1)``)."""
    h = block_feats[-1].to(cfg.compute_dtype)
    for i in range(cfg.n_layers):
        be = blocks_edges[-(i + 1)]
        n_dst, mask = be["n_dst"], be["edge_mask"]
        deg = edge_counts(be["edge_dst"], mask, n_dst) + 1.0
        ids, w = segment_bags(be["edge_src"], be["edge_dst"], mask, n_dst,
                              n_src=h.shape[0])
        agg = (aggregate(ids, w, h) + h[:n_dst]) / deg[:, None].to(h.dtype)
        h = L.dense_apply(params[f"layer_{i}"], agg,
                          compute_dtype=cfg.compute_dtype)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def loss_sampled(cfg: GCNConfig, params, batch) -> torch.Tensor:
    """batch: block_feats (a list), block_edges (a list of dicts), the
    seeds' labels."""
    logits = forward_sampled(cfg, params, batch["block_feats"],
                             batch["block_edges"])
    return L.softmax_cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# PowerWalk integration: PPR-weighted propagation (APPNP / PPRGo style)
# ---------------------------------------------------------------------------

def ppr_propagate(h: torch.Tensor, ppr_vals: torch.Tensor,
                  ppr_idx: torch.Tensor) -> torch.Tensor:
    """``h' [B, d] = sum_l ppr_vals[b, l] * h[ppr_idx[b, l]]``: each seed's
    top-L PPR neighbourhood (from the PowerWalk index or
    ``sampler.ppr_importance_sample``) in place of ``n_layers`` of graph
    propagation; one ``embedding_bag`` launch."""
    return aggregate(ppr_idx.to(torch.int32), ppr_vals.to(torch.float32), h)


def loss_ppr(cfg: GCNConfig, params, batch) -> torch.Tensor:
    """PPRGo-style: the MLP on raw features, then the PPR aggregation of
    its logits.  batch: feats [n_unique, F] (features of every index
    neighbour), ppr_vals / ppr_idx [B, L] (positions into feats), labels
    [B]."""
    h = batch["feats"].to(cfg.compute_dtype)
    for i in range(cfg.n_layers):
        h = L.dense_apply(params[f"layer_{i}"], h,
                          compute_dtype=cfg.compute_dtype)
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    logits = ppr_propagate(h, batch["ppr_vals"], batch["ppr_idx"])
    return L.softmax_cross_entropy(logits, batch["labels"])
