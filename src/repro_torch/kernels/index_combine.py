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
:func:`combine_plan` picks its path: for a ``k_out`` the kernel's hash
path takes (up to 1,024) a row spread over ``parts`` blocks, each merging
the columns of one part of the hash range in a shared-memory table (no
sort, no scratch but the parts' lists; a column of -1, the tables' empty
mark, is skipped); wider ``k_out`` (an exact combine) sorts each row's
candidates in a global scratch.
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

_SPARSE_HEAD = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int]
_SORT_ARGTYPES = (_SPARSE_HEAD + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 3)
_HASH_ARGTYPES = (_SPARSE_HEAD + [ctypes.c_int] * 4 + [ctypes.c_uint]
                  + [ctypes.c_void_p] * 4)

# The sparse combine's hash path (csrc/index_combine.cu): the claims a
# block's table may have in flight past its d_max (one a thread; the launch
# refuses a d_max without this headroom), the bounds of a block's table
# (column and sum: 8 B a slot), the shared memory an H100 block may use,
# and the odd multiplier of the partition hash (passed to the kernel).
HASH_THREADS = 512
HASH_MIN_SLOTS = 2048
HASH_MAX_SLOTS = 8192
SMEM_PER_BLOCK = 232448
PART_MUL = 0x9E3779B1


def kernel_hash_smem(lib=None):
    """The kernel library's ``index_combine_hash_smem(t_log2, k, k_out)``:
    a hash block's dynamic shared memory, or -1 for a ``k_out`` the hash
    path does not take."""
    fn = (lib or build.load("index_combine_sparse")).index_combine_hash_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn


class CombinePlan(NamedTuple):
    """How :func:`index_combine_sparse_cuda` runs: ``path`` "hash" (a
    row over ``parts`` blocks, each with a ``2 ** t_log2``-slot table that
    splits its columns into passes beyond ``d_max`` of them, ``smem`` bytes
    of shared memory) or "sort" (one block per row)."""

    path: str
    parts: int = 1
    t_log2: int = 0
    d_max: int = 0
    smem: int = 0


def combine_plan(s_w: int, k: int, l: int, k_out: int, smem_bytes=None,
                 path: str | None = None) -> CombinePlan:
    """The path of a sparse combine of ``s_w`` entries of ``s`` and ``k``
    slots of ``l``-wide index rows to ``k_out`` (``path`` forces one);
    ``smem_bytes(t_log2, k, k_out)`` is the hash block's shared memory (-1:
    the hash path does not take ``k_out``), by default the kernel's own
    (:func:`kernel_hash_smem`).

    The hash path takes what fits a block.  Its table holds a power of two
    slots between ``HASH_MIN_SLOTS`` and ``HASH_MAX_SLOTS``, up to
    ``d_max`` = 3/4 of them less one round of claims in flight.  The launch
    spreads each row over ``parts`` = ``ceil((s_w + k * l) / d_max)``
    blocks; a row uses the first ``ceil((s_w + live * l) / d_max)`` of
    them, ``live`` its slots of positive mass, so a row whose columns hash
    evenly never overflows a table, whatever its candidates."""
    if path not in (None, "hash", "sort"):
        raise ValueError(f"index_combine_sparse: unknown path {path!r}")
    if path == "sort":
        return CombinePlan("sort")
    bound = max(s_w + k * l, 1)
    slots = build.next_pow2(-(-(bound + HASH_THREADS) * 4 // 3))
    slots = min(max(slots, HASH_MIN_SLOTS), HASH_MAX_SLOTS)
    t_log2 = slots.bit_length() - 1
    d_max = 3 * slots // 4 - HASH_THREADS
    smem = (smem_bytes or kernel_hash_smem())(t_log2, k, k_out)
    if 0 <= smem <= SMEM_PER_BLOCK:
        return CombinePlan("hash", parts=-(-bound // d_max), t_log2=t_log2,
                           d_max=d_max, smem=smem)
    if path == "hash":
        raise ValueError(f"index_combine_sparse: the hash path does not take "
                         f"k_out {k_out} over {k} slots")
    return CombinePlan("sort")


def row_parts(plan: CombinePlan, s_w: int, live: torch.Tensor,
              l: int) -> torch.Tensor:
    """The parts each row takes on the hash path: ``ceil((s_w + live *
    l) / d_max)``, at most ``plan.parts``, for ``live`` slots of positive
    mass a row."""
    need = torch.div(s_w + live.to(torch.int64) * l + plan.d_max - 1,
                     plan.d_max, rounding_mode="floor")
    return torch.clamp(need, 1, plan.parts)


def hash_part(cols: torch.Tensor, parts) -> torch.Tensor:
    """The part (block of a row) that owns each column on the hash path
    of a row over ``parts`` parts: ``(col * PART_MUL mod 2**32) * parts
    >> 32``."""
    h = (cols.to(torch.int64) & 0xFFFFFFFF) * PART_MUL & 0xFFFFFFFF
    return (h * parts) >> 32


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


def index_combine_sparse_cuda(sv, si, fv, fi, vals, idx, *, k_out: int,
                              path: str | None = None):
    """Launch the CUDA kernel on the current stream (no sync), on the path
    :func:`combine_plan` picks (``path`` forces one)."""
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
    plan = combine_plan(s_w, k, l, k_out, kernel_hash_smem(lib), path)
    return launch_sparse(lib, plan, sv, si, fv, fi, vals, idx, k_out)


def launch_sparse(lib, plan: CombinePlan, sv, si, fv, fi, vals, idx,
                  k_out: int):
    """Launch ``plan`` from the kernel library ``lib`` on checked inputs
    (:func:`index_combine_sparse_cuda`; a build of the same source with
    other flags, such as ``tools/combine_phases.py``'s phase timers)."""
    dev = fv.device
    q, k = fv.shape
    s_w = sv.shape[1]
    n, l = vals.shape
    out_v = torch.empty((q, k_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k_out), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = (sv.data_ptr(), si.data_ptr(), q, s_w, fv.data_ptr(),
            fi.data_ptr(), k, vals.data_ptr(), idx.data_ptr(), n, l, k_out)
    if plan.path == "hash":
        if q * plan.parts * k_out >= 2 ** 31 or s_w + k * l >= 2 ** 31:
            raise ValueError(f"index_combine_sparse: {q} rows x "
                             f"{plan.parts} parts too many")
        part_keys = torch.empty((q, plan.parts, k_out), dtype=torch.int64,
                                device=dev)
        fn = lib.index_combine_hash_launch
        fn.argtypes = _HASH_ARGTYPES
        fn.restype = ctypes.c_int
        # index rows by bulk copies: 16-byte rows, 16-byte aligned
        bulk = int(l % 4 == 0 and vals.data_ptr() % 16 == 0
                   and idx.data_ptr() % 16 == 0)
        status = fn(*head, plan.parts, plan.t_log2, plan.d_max, bulk,
                    PART_MUL, part_keys.data_ptr(), out_v.data_ptr(),
                    out_i.data_ptr(), stream)
        build.check_launch(status, "index_combine_sparse")
        return out_v, out_i
    bound = s_w + k * l
    g_p = build.next_pow2(bound) if bound > lib.pw_smem_candidates() else 1
    if q * g_p >= 2 ** 31 or bound >= 2 ** 31:
        raise ValueError(f"index_combine_sparse: scratch {q} x {g_p} too large")
    g_cv = torch.empty((q, g_p), dtype=torch.float32, device=dev)
    g_ci = torch.empty((q, g_p), dtype=torch.int32, device=dev)
    g_keys = torch.empty((q, g_p), dtype=torch.int64, device=dev)
    fn = lib.index_combine_sort_launch
    fn.argtypes = _SORT_ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(*head, g_cv.data_ptr(), g_ci.data_ptr(), g_keys.data_ptr(),
                g_p, out_v.data_ptr(), out_i.data_ptr(), stream)
    build.check_launch(status, "index_combine_sparse")
    return out_v, out_i


# ---------------------------------------------------------------------------
# Contract-auditor entry point (repro_torch.analysis): the sparse combine's
# two [n, L] index arrays reach the kernel as the index's own global
# memory, only gathered from (hbm-residency).
# ---------------------------------------------------------------------------

from repro_torch.analysis.registry import register_entry_point as _register_ep


def _combine_dynamic_smem(lib, args, kwargs):
    """A hash block's planned bytes at the launch's shapes (the sort path
    takes none), from the library's own planner."""
    sv, _, fv, _, vals, _ = args
    plan = combine_plan(sv.shape[1], fv.shape[1], vals.shape[1],
                        kwargs["k_out"], kernel_hash_smem(lib))
    return ({"index_combine_hash_kernel": plan.smem}
            if plan.path == "hash" else {})


def _contract_spec_index_combine(device):
    import functools

    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, l, q, k, s_w, k_out = 600, 16, 16, 8, 8, 16

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    vals = t(rng.random((n, l)), torch.float32)
    idx = t(rng.integers(0, n, (n, l)), torch.int32)
    sv = t(rng.random((q, s_w)), torch.float32)
    si = t(rng.integers(0, n, (q, s_w)), torch.int32)
    fv = t(rng.random((q, k)), torch.float32)
    fi = t(rng.integers(0, n, (q, k)), torch.int32)
    return dict(
        kernel="index_combine_sparse",
        fn=functools.partial(ops.index_combine_sparse, k_out=k_out),
        args=(sv, si, fv, fi, vals, idx),
        operands={"vals": 4, "idx": 5},
        hbm_shapes=[(n, l)],
        dynamic_smem=_combine_dynamic_smem,
    )


_register_ep("index-combine-sparse", "hbm-residency",
             "src/repro_torch/kernels/index_combine.py",
             _contract_spec_index_combine)
