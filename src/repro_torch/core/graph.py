"""Graph container: CSR + COO int32 tensors on one device.

Semantics follow the paper (Section 2.1), as in ``repro.core.graph``:
``A[i, j] = 1/|O(i)|``; a dangling vertex behaves as if it had one edge
back to the personalization source, and the operators expose the dangling
mass separately so each query can reclaim it.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class ColumnSortedRows(NamedTuple):
    """Each CSR row's columns sorted by (column, offset in the row)."""

    col_idx: torch.Tensor   # int32[m], row v at row_ptr[v]:row_ptr[v+1]
    repeats: torch.Tensor   # bool[n], True where a row holds a column twice


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph in CSR + COO form.

    Attributes:
      row_ptr: int32[n + 1] CSR row offsets (by source vertex).
      col_idx: int32[m] destination of each edge, CSR order.
      src:     int32[m] source of each edge (expanded row_ptr), CSR order.
      out_deg: int32[n] out-degree per vertex.
      n, m:    vertex / edge counts.
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    src: torch.Tensor
    out_deg: torch.Tensor
    n: int
    m: int
    # derived views built once per graph (``ell``); not part of equality
    _views: Dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @staticmethod
    def from_edges(src, dst, n: int | None = None, device="cuda") -> "Graph":
        """Build from (possibly unsorted) edge lists; dedups nothing.  The
        host-side construction is the reference's, so equal edge lists give
        equal CSR arrays in both packages."""
        dev = resolve_device(device)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be 1-D arrays of equal length")
        if n is None:
            n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        order = np.argsort(src, kind="stable")
        src = src[order]
        dst = dst[order]
        out_deg = np.bincount(src, minlength=n).astype(np.int32)
        row_ptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(out_deg, out=row_ptr[1:])
        return Graph(
            row_ptr=torch.from_numpy(row_ptr).to(dev),
            col_idx=torch.from_numpy(dst.astype(np.int32)).to(dev),
            src=torch.from_numpy(src.astype(np.int32)).to(dev),
            out_deg=torch.from_numpy(out_deg).to(dev),
            n=int(n),
            m=int(src.shape[0]),
        )

    @staticmethod
    def from_dense(adj, device="cuda") -> "Graph":
        src, dst = np.nonzero(np.asarray(adj))
        return Graph.from_edges(src, dst, n=adj.shape[0], device=device)

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def dangling_mask(self) -> torch.Tensor:
        """bool[n], True where the vertex has no out-edge."""
        return self.out_deg == 0

    @property
    def inv_out_deg(self) -> torch.Tensor:
        """f32[n] = 1/out_deg with 0 for dangling vertices."""
        deg = self.out_deg.to(torch.float32)
        return torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 0.0)

    @property
    def edge_weight(self) -> torch.Tensor:
        """f32[m] = 1/out_deg[src e], the CSR value array of ``A``."""
        return self.inv_out_deg[self.src.long()]

    def out_neighbors(self, v: int) -> np.ndarray:
        lo, hi = int(self.row_ptr[v]), int(self.row_ptr[v + 1])
        return self.col_idx[lo:hi].cpu().numpy()

    def ell(self, k: int = 16):
        """The row-chunked ELL pull view (``graphs.formats.to_ell_chunks``),
        built on first use and kept for the graph's lifetime: every dense
        push reads it, and at rmat(20) its build is a device sort of m
        edges."""
        from repro_torch.graphs.formats import to_ell_chunks

        view = self._views.get(("ell", k))
        if view is None:
            view = self._views[("ell", k)] = to_ell_chunks(self, k=k)
        return view

    def col_sorted(self) -> ColumnSortedRows:
        """The column-sorted CSR view, built on first use and kept for the
        graph's lifetime: the ``frontier_push`` kernel folds a one-slot
        chunk (a vertex's whole row) without sorting it.  One device
        sort of the ``m`` keys ``row * n + column``: ``from_edges`` sorts
        by source only, so a row's columns are in edge order until then."""
        view = self._views.get("col_sorted")
        if view is None:
            key = self.src.long() * max(self.n, 1) + self.col_idx.long()
            key = torch.sort(key).values  # equal keys hold equal columns
            repeats = torch.zeros(self.n, dtype=torch.bool,
                                  device=self.device)
            same = key[1:] == key[:-1]
            repeats[torch.div(key[1:][same], max(self.n, 1),
                              rounding_mode="floor")] = True
            view = self._views["col_sorted"] = ColumnSortedRows(
                col_idx=(key % max(self.n, 1)).to(torch.int32),
                repeats=repeats)
        return view

    def dense_transition(self, source: int | None = None) -> np.ndarray:
        """Dense float64 row-stochastic ``A`` with dangling rows sent to
        ``source`` (left all-zero when ``source`` is None).  Tiny graphs
        and oracles only."""
        a = np.zeros((self.n, self.n), dtype=np.float64)
        src = self.src.cpu().numpy()
        dst = self.col_idx.cpu().numpy()
        deg = self.out_deg.cpu().numpy().astype(np.float64)
        np.add.at(a, (src, dst), 1.0 / deg[src])
        if source is not None:
            dang = self.dangling_mask.cpu().numpy()
            a[dang, :] = 0.0
            a[dang, source] = 1.0
        return a

    def to(self, device) -> "Graph":
        dev = resolve_device(device)
        if dev.type == self.device.type and dev.index in (
            None, self.device.index
        ):
            return self
        return Graph(
            row_ptr=self.row_ptr.to(dev), col_idx=self.col_idx.to(dev),
            src=self.src.to(dev), out_deg=self.out_deg.to(dev),
            n=self.n, m=self.m,
        )


def graph_fingerprint(graph: Graph) -> int:
    """crc32 over the CSR topology (``row_ptr`` + ``col_idx`` as int64
    bytes) — equal to ``repro.core.graph.graph_fingerprint`` on the same
    graph."""
    crc = zlib.crc32(np.ascontiguousarray(
        graph.row_ptr.cpu().numpy().astype(np.int64)).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(
        graph.col_idx.cpu().numpy().astype(np.int64)).tobytes(), crc)
    return crc & 0xFFFFFFFF


def _edge_pairs(edges) -> np.ndarray:
    """Coerce an edge batch to an int64 ``[k, 2]`` array (empty ok)."""
    if edges is None:
        return np.zeros((0, 2), dtype=np.int64)
    arr = np.asarray(edges, dtype=np.int64)
    if arr.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"edge batch must have shape [k, 2], got {arr.shape}")
    return arr


def apply_edge_updates(graph: Graph, inserts=None, deletes=None
                       ) -> Tuple[Graph, np.ndarray]:
    """Apply a batch of edge inserts and deletes: ``(new_graph, touched)``,
    the new graph on the old one's device.

    ``inserts``/``deletes`` are ``[k, 2]`` arrays of ``(src, dst)`` pairs
    among the existing vertices (``n`` never changes).  Deleting an edge
    that is not present, or more copies than are present, raises; a
    duplicate insert is kept (CSR stores multiplicity).  ``touched`` is the
    sorted unique int64 set of sources whose out-edges changed, the seed of
    the invalidation set of ``core/updates.py``.

    Determinism contract, which incremental repair relies on: an untouched
    source keeps its exact CSR window, contents and order, because edges
    are only removed from or appended after those of touched sources and
    :meth:`Graph.from_edges` sorts by source with a stable sort.  The host
    code is ``repro.core.graph.apply_edge_updates``'s, so both packages
    give the same arrays.
    """
    ins = _edge_pairs(inserts)
    dele = _edge_pairs(deletes)
    for name, arr in (("inserts", ins), ("deletes", dele)):
        if arr.size and (arr.min() < 0 or arr.max() >= graph.n):
            raise ValueError(f"{name} contain vertex ids outside [0, {graph.n})")
    if not ins.size and not dele.size:
        return graph, np.zeros(0, dtype=np.int64)

    src = graph.src.cpu().numpy().astype(np.int64)
    dst = graph.col_idx.cpu().numpy().astype(np.int64)
    if dele.size:
        key = src * graph.n + dst
        order = np.argsort(key, kind="stable")
        skey = key[order]
        dkey, dcnt = np.unique(dele[:, 0] * graph.n + dele[:, 1],
                               return_counts=True)
        lo = np.searchsorted(skey, dkey, side="left")
        hi = np.searchsorted(skey, dkey, side="right")
        missing = dcnt > (hi - lo)
        if missing.any():
            bad = dkey[missing][0]
            raise ValueError(
                f"cannot delete edge ({bad // graph.n}, {bad % graph.n}): "
                "not present (or multiplicity exceeded)")
        remove = np.zeros(src.shape[0], dtype=bool)
        for pos, cnt in zip(lo, dcnt):
            remove[order[pos:pos + cnt]] = True
        keep = ~remove
        src, dst = src[keep], dst[keep]
    if ins.size:
        src = np.concatenate([src, ins[:, 0]])
        dst = np.concatenate([dst, ins[:, 1]])
    touched = np.unique(np.concatenate([ins[:, 0], dele[:, 0]]))
    return Graph.from_edges(src, dst, n=graph.n, device=graph.device), touched


def push_forward(graph: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """One substochastic push ``frontier @ A0`` (``f32[q, n]``): dangling
    mass is dropped here (see :func:`dangling_mass`).  Runs through the
    ``ell_spmm`` kernel wrapper over the graph's cached ELL view."""
    from repro_torch.kernels import ops

    return ops.ell_push(frontier, graph.ell())


def dangling_mass(graph: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """Total frontier mass sitting on dangling vertices, shape ``[...]``."""
    return torch.where(graph.dangling_mask, frontier, 0.0).sum(dim=-1)


def transition_with_dangling(graph: Graph, frontier: torch.Tensor,
                             sources: torch.Tensor) -> torch.Tensor:
    """``frontier @ A`` where dangling rows of ``A`` point at ``sources``
    (``int32[q]``, one personalization vertex per row)."""
    pushed = push_forward(graph, frontier)
    dm = dangling_mass(graph, frontier)
    rows = torch.arange(frontier.shape[0], device=frontier.device)
    return pushed.index_put_((rows, sources.long()), dm, accumulate=True)


def transition_with_dangling_seeds(graph: Graph, frontier: torch.Tensor,
                                   seeds: torch.Tensor,
                                   weights: torch.Tensor) -> torch.Tensor:
    """``frontier @ A`` where dangling rows of ``A`` point at each query's
    seed distribution (``seeds int32[q, S]``, ``weights f32[q, S]``, pad
    slots weight 0); duplicate seeds receive the sum of their shares."""
    pushed = push_forward(graph, frontier)
    dm = dangling_mass(graph, frontier)
    wsum = torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-30)
    share = dm[:, None] * (weights / wsum)
    rows = torch.arange(frontier.shape[0], device=frontier.device)[:, None]
    rows = rows.expand(seeds.shape)
    return pushed.index_put_((rows, seeds.long()), share, accumulate=True)


def reverse(graph: Graph) -> Graph:
    """Graph with every edge reversed, on the same device."""
    return Graph.from_edges(graph.col_idx.cpu().numpy(),
                            graph.src.cpu().numpy(), n=graph.n,
                            device=graph.device)
