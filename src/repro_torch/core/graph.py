"""Graph container: CSR + COO int32 tensors on one device.

Semantics follow the paper (Section 2.1), as in ``repro.core.graph``:
``A[i, j] = 1/|O(i)|``; a dangling vertex behaves as if it had one edge
back to the personalization source, and the operators expose the dangling
mass separately so each query can reclaim it.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device


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

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

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
