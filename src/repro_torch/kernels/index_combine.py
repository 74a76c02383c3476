"""The index combine ``s + f @ P_hat`` (paper Algorithm 4 line 10).

Dense (``index_combine``): ``out[q, :] = s[q, :] + sum_v f[q, v] *
scatter(vals[v, :] at idx[v, :])`` on ``[Q, n]`` state.
:func:`index_combine_plain` is the plain PyTorch version, chunked over
vertices as ``verd.combine_with_index`` is; :func:`index_combine_cuda`
launches ``csrc/index_combine_dense.cu``, a pull over the index's
transposed view (:func:`index_columns`) that skips the zeros of ``f`` and
sums every output entry in one fixed order, with no atomics, so two
launches give the same bits.

Sparse (``index_combine_sparse``): on sparse state, then top-k.

Gathers the ``K`` touched ``[L]`` index rows of each query, scales them by
the frontier mass, appends them after the ``s`` entries and
``compact_arrays``-es the row to ``k_out`` (``verd.combine_with_index_sparse``).
:func:`index_combine_sparse_plain` is the plain PyTorch version;
:func:`index_combine_sparse_cuda` launches ``csrc/index_combine.cu``.
The kernel skips zero-mass slots and zero index entries, which cannot
change the result for the nonnegative masses PPR works with.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import frontier as F
from repro_torch.kernels import build

# elements of one [Q, chunk, L] contribution block of the plain version
PLAIN_BLOCK_ELEMS = 1 << 25

_DENSE_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6)
# entries of an output column that one warp of the dense pull sums; each
# further run of as many is a task of its own (csrc/index_combine_dense.cu)
COLUMN_SEGMENT = 1024

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
)


def index_combine_plain(s, f, vals, idx, columns=None):
    """Dense combine ``f32[Q, n]`` from ``s f32[Q, n]``, ``f f32[Q, nv]``
    and index rows ``vals f32[nv, L]`` / ``idx int32[nv, L]``; columns
    outside ``[0, n)`` are dropped.  Scatter-adds in vertex chunks so the
    ``[Q, chunk, L]`` contributions stay bounded; ``columns`` (the
    kernel's view) is not read."""
    q, n = s.shape
    nv, l = vals.shape
    out = s.clone()
    step = max(1, PLAIN_BLOCK_ELEMS // max(q * l, 1))
    for v0 in range(0, nv, step):
        contrib = f[:, v0:v0 + step, None] * vals[None, v0:v0 + step]
        cols = idx[v0:v0 + step].reshape(1, -1).long().expand(q, -1)
        keep = (cols >= 0) & (cols < n)
        out.scatter_add_(1, torch.where(keep, cols, 0),
                         torch.where(keep, contrib.reshape(q, -1), 0.0))
    return out


class IndexColumns(NamedTuple):
    """The transposed view of index rows ``[0, nv)`` over output columns
    ``[0, n)``: column ``c``'s entries ``(v, vals[v, j])`` with
    ``idx[v, j] == c`` and ``vals[v, j] != 0``, in ascending ``(v, j)``,
    at ``col_ptr[c]:col_ptr[c + 1]``; and the split of the columns of
    more than ``seg`` entries into tasks."""

    col_ptr: torch.Tensor   # int32[n + 1]
    ent_v: torch.Tensor     # int32[nnz] the entry's index row
    ent_w: torch.Tensor     # f32[nnz]  its value
    tasks: torch.Tensor     # int32[T, 3] (column, first entry, end)
    heavy: torch.Tensor     # int32[H, 3] (column, first task, tasks)
    nv: int
    n: int
    seg: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.col_ptr, self.ent_v, self.ent_w, self.tasks, self.heavy))


def index_columns(vals, idx, n: int, seg: int = COLUMN_SEGMENT
                  ) -> IndexColumns:
    """Build the transposed view of ``vals``/``idx [nv, L]`` on their
    device: one sort of the kept entries' ``column * nv * L + entry``
    keys, so each column lists its entries in ascending ``(v, j)``.
    Entries of value 0 or with a column outside ``[0, n)`` are dropped, as
    the plain version's scatter adds nothing for them."""
    nv, l = vals.shape
    dev = vals.device
    total = nv * l
    if total and (n * total >= 2 ** 63 or total >= 2 ** 31):
        raise ValueError(f"index_columns: {nv} x {l} index too large")
    flat_v = vals.reshape(-1)
    flat_c = idx.reshape(-1)
    kept = ((flat_v != 0) & (flat_c >= 0) & (flat_c < n)).nonzero()
    key = flat_c[kept[:, 0]].long() * max(total, 1) + kept[:, 0]
    del kept
    key = torch.sort(key).values
    cols = torch.div(key, max(total, 1), rounding_mode="floor")
    counts = torch.bincount(cols, minlength=n)
    del cols
    key.remainder_(max(total, 1))                    # the entry, v * L + j
    ent_v = torch.div(key, max(l, 1), rounding_mode="floor").to(torch.int32)
    ent_w = flat_v[key]
    del key
    col_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=col_ptr[1:])
    # runs of seg entries after a column's first: one task each
    extra = torch.div(torch.clamp(counts - 1, min=0), seg,
                      rounding_mode="floor")
    heavy_col = (extra > 0).nonzero()[:, 0]
    n_tasks = extra[heavy_col]
    first = torch.cumsum(n_tasks, 0) - n_tasks
    task_col = torch.repeat_interleave(heavy_col, n_tasks)
    run = (torch.arange(task_col.numel(), device=dev)
           - torch.repeat_interleave(first, n_tasks) + 1)
    e0 = col_ptr[task_col] + run * seg
    e1 = torch.minimum(e0 + seg, col_ptr[task_col + 1])
    return IndexColumns(
        col_ptr=col_ptr.to(torch.int32), ent_v=ent_v, ent_w=ent_w,
        tasks=torch.stack([task_col, e0, e1], 1).to(torch.int32),
        heavy=torch.stack([heavy_col, first, n_tasks], 1).to(torch.int32),
        nv=nv, n=n, seg=seg)


def index_combine_cuda(s, f, vals, idx, columns=None):
    """Launch the dense combine on the current stream (no sync).
    ``columns`` is the index's :func:`index_columns` view (the index's
    cached ``PPRIndex.columns``); built here when not given."""
    dev = f.device
    for name, t, dt in (
        ("s", s, torch.float32), ("f", f, torch.float32),
        ("vals", vals, torch.float32), ("idx", idx, torch.int32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"index_combine: {name} must be a contiguous {dt} tensor on "
                f"{dev}, got {t.dtype} on {t.device}")
    q, n = s.shape
    nv, l = vals.shape
    if f.shape != (q, nv) or idx.shape != (nv, l):
        raise ValueError("index_combine: mismatched shapes")
    if max(q * n, q * nv, nv * l) >= 2 ** 31:
        raise ValueError(f"index_combine: shape {q} x {n} too large")
    if columns is None:
        columns = index_columns(vals, idx, n)
    if (columns.nv, columns.n) != (nv, n) or columns.col_ptr.device != dev:
        raise ValueError("index_combine: columns is not this index's view")
    lib = build.load("index_combine")
    q_tile = lib.index_combine_q_tile
    q_tile.argtypes, q_tile.restype = [], ctypes.c_int
    q_tiles = -(-q // q_tile())
    if q_tiles >= 65536:
        raise ValueError(f"index_combine: {q} query rows are too many")
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    # per q tile: the nonzeros of f, packed by vertex, and each vertex's
    # (start, count) in them
    pairs = torch.empty((q_tiles * nv * q_tile(), 2), dtype=torch.int32,
                        device=dev)
    meta = torch.empty((q_tiles * nv, 2), dtype=torch.int32, device=dev)
    n_pairs = torch.empty(q_tiles, dtype=torch.int32, device=dev)
    n_tasks, n_heavy = columns.tasks.shape[0], columns.heavy.shape[0]
    carry = torch.empty((max(n_tasks, 1), q), dtype=torch.float32,
                        device=dev)
    fn = lib.index_combine_dense_launch
    fn.argtypes = _DENSE_ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        s.data_ptr(), f.data_ptr(), columns.col_ptr.data_ptr(),
        columns.ent_v.data_ptr(), columns.ent_w.data_ptr(),
        columns.tasks.data_ptr(), n_tasks, columns.heavy.data_ptr(), n_heavy,
        q, n, nv, columns.seg, pairs.data_ptr(), meta.data_ptr(),
        n_pairs.data_ptr(), carry.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "index_combine")
    return out


def index_combine_sparse_plain(sv, si, fv, fi, vals, idx, *, k_out: int):
    from repro_torch.core import verd as verd_mod

    cv, ci = verd_mod.gather_combine_candidates(sv, si, fv, fi, vals, idx)
    return F.compact_arrays(cv, ci, k_out)


def index_combine_sparse_cuda(sv, si, fv, fi, vals, idx, *, k_out: int):
    """Launch the CUDA kernel on the current stream (no sync)."""
    dev = fv.device
    for name, t, dt in (
        ("sv", sv, torch.float32), ("si", si, torch.int32),
        ("fv", fv, torch.float32), ("fi", fi, torch.int32),
        ("vals", vals, torch.float32), ("idx", idx, torch.int32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"index_combine_sparse: {name} must be a contiguous {dt} "
                f"tensor on {dev}, got {t.dtype} on {t.device}"
            )
    q, k = fv.shape
    s_w = sv.shape[1]
    n, l = vals.shape
    if (fi.shape != (q, k) or sv.shape[0] != q or si.shape != (q, s_w)
            or idx.shape != (n, l)):
        raise ValueError("index_combine_sparse: mismatched shapes")
    if k_out < 1 or n < 1:
        raise ValueError("index_combine_sparse: needs k_out >= 1 and n >= 1")
    lib = build.load("index_combine_sparse")
    bound = s_w + k * l
    g_p = build.next_pow2(bound) if bound > lib.pw_smem_candidates() else 1
    if q * g_p >= 2 ** 31 or bound >= 2 ** 31:
        raise ValueError(f"index_combine_sparse: scratch {q} x {g_p} too large")
    g_cv = torch.empty((q, g_p), dtype=torch.float32, device=dev)
    g_ci = torch.empty((q, g_p), dtype=torch.int32, device=dev)
    g_keys = torch.empty((q, g_p), dtype=torch.int64, device=dev)
    out_v = torch.empty((q, k_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k_out), dtype=torch.int32, device=dev)
    fn = lib.index_combine_sparse_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        sv.data_ptr(), si.data_ptr(), q, s_w, fv.data_ptr(), fi.data_ptr(),
        k, vals.data_ptr(), idx.data_ptr(), n, l, k_out, g_cv.data_ptr(),
        g_ci.data_ptr(), g_keys.data_ptr(), g_p, out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "index_combine_sparse")
    return out_v, out_i
