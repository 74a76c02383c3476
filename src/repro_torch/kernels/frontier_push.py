"""``frontier_push``: the sparse VERD gather-push, folded chunk by chunk.

Semantics (both versions): the running state starts as ``(run_v, run_i)``;
for each chunk of ``slots`` frontier slots, the chunk's push candidates
(``verd.gather_push_edges``: weight ``(1-c) * fv / deg`` on the first
``min(deg, degree_cap)`` out-edges of each slot) are concatenated with the
running state -- running first when ``run_first``, else after -- and
``compact_arrays``-ed to ``k_out``.  One chunk of all ``K`` slots with the
raw dangling candidates after it is the one-shot push; the streamed fold
of ``verd.sparse_push_compact`` is the same loop with its chunk plan.

:func:`frontier_push_plain` is the plain PyTorch version;
:func:`frontier_push_cuda` launches ``csrc/frontier_push.cu`` (one block
per query row, looping over the chunks; one-slot folds go sort-free over
the graph's column-sorted view when the caller passes it).
``hub_split_degree`` changes only the TPU's gather geometry, not the
candidate multiset, so the kernel ignores it.

``sharded_frontier_push`` is one shard's half-iteration of the
distributed sparse exchange: the same gather-push through the shard's CSR
slab (``deg`` from the slab's ``row_ptr``), one exact merge, then per-owner
top-``wire_k`` buckets (``frontier.bucket_by_owner``).  It has no chunk
plan: the merge is exact and each owner's top-k follows it, so the answer
does not depend on how the edges are split.
:func:`sharded_frontier_push_plain` is the plain version;
:func:`sharded_frontier_push_cuda` launches
``csrc/sharded_frontier_push.cu``: one block per narrow row, and the
rows too wide for one block's shared memory spread over the whole grid
(``csrc/wide_row.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frontier as F
from repro_torch.kernels import build

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
)
_SHARDED_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
)
_SHARDED_SIZE_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
)
_SHARDED_WIDE_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_float] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int]
    + [ctypes.c_void_p] * 7
)
# candidates per block of the plain sharded push (its window form gathers
# K * s * h lanes per row: 7.2M at the main path's second iteration)
PLAIN_BLOCK_ELEMS = 1 << 25


def frontier_push_plain(
    fv, fi, run_v, run_i, row_ptr, out_deg, col_idx, *,
    c: float, degree_cap: int, hub_split_degree: int, slots: int,
    k_out: int, run_first: bool, sorted_view=None,
):
    """The folds in plain PyTorch; ``sorted_view`` (the kernel's shortcut)
    is not read."""
    from repro_torch.core import verd as verd_mod

    k = fv.shape[1]
    rv, ri = run_v, run_i
    for j in range(0, k, slots):
        cfv = fv[:, j:j + slots]
        cfi = fi[:, j:j + slots].long()
        pv, nb = verd_mod.gather_push_edges(
            cfv, cfi, row_ptr[cfi], out_deg[cfi], col_idx, c=c,
            degree_cap=degree_cap, hub_split_degree=hub_split_degree,
        )
        if run_first:
            cv, ci = torch.cat([rv, pv], dim=1), torch.cat([ri, nb], dim=1)
        else:
            cv, ci = torch.cat([pv, rv], dim=1), torch.cat([nb, ri], dim=1)
        rv, ri = F.compact_arrays(cv, ci, k_out)
    return rv, ri


def frontier_push_cuda(
    fv, fi, run_v, run_i, row_ptr, out_deg, col_idx, *,
    c: float, degree_cap: int, hub_split_degree: int, slots: int,
    k_out: int, run_first: bool, sorted_view=None,
):
    """Launch the CUDA kernel on the current stream (no sync).
    ``sorted_view`` is the graph's ``Graph.col_sorted()`` view, with which
    one-slot folds of rows that repeat no column go sort-free; without it
    every fold takes the general path."""
    del hub_split_degree  # geometry only; the kernel gathers real edges
    dev = fv.device
    for name, t, dt in (
        ("fv", fv, torch.float32), ("fi", fi, torch.int32),
        ("run_v", run_v, torch.float32), ("run_i", run_i, torch.int32),
        ("row_ptr", row_ptr, torch.int32), ("out_deg", out_deg, torch.int32),
        ("col_idx", col_idx, torch.int32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"frontier_push: {name} must be a contiguous {dt} tensor on "
                f"{dev}, got {t.dtype} on {t.device}"
            )
    q, k = fv.shape
    r0 = run_v.shape[1]
    if fi.shape != (q, k) or run_i.shape != (q, r0) or run_v.shape[0] != q:
        raise ValueError("frontier_push: mismatched frontier/running shapes")
    if k < 1 or slots < 1 or k % slots or k_out < 1:
        raise ValueError(
            f"frontier_push: needs k >= 1 divisible by slots >= 1 and "
            f"k_out >= 1, got k={k} slots={slots} k_out={k_out}"
        )
    m = col_idx.shape[0]
    if m == 0:
        raise ValueError("frontier_push: the kernel needs a graph with edges")
    sorted_col = row_repeats = 0
    if sorted_view is not None:
        if (sorted_view.col_idx.shape != col_idx.shape
                or sorted_view.repeats.shape != out_deg.shape
                or sorted_view.col_idx.device != dev
                or sorted_view.repeats.dtype != torch.bool):
            raise ValueError("frontier_push: sorted_view is not this graph's")
        sorted_col = sorted_view.col_idx.data_ptr()
        row_repeats = sorted_view.repeats.data_ptr()
    cap = min(degree_cap, m)
    lib = build.load("frontier_push")
    bound = max(r0, k_out) + slots * cap
    g_p = build.next_pow2(bound) if bound > lib.pw_smem_candidates() else 1
    if q * g_p >= 2 ** 31 or bound >= 2 ** 31:
        raise ValueError(f"frontier_push: scratch of {q} x {g_p} too large")
    run_bv = torch.empty((q, k_out), dtype=torch.float32, device=dev)
    run_bi = torch.empty((q, k_out), dtype=torch.int32, device=dev)
    g_cv = torch.empty((q, g_p), dtype=torch.float32, device=dev)
    g_ci = torch.empty((q, g_p), dtype=torch.int32, device=dev)
    g_keys = torch.empty((q, g_p), dtype=torch.int64, device=dev)
    out_v = torch.empty((q, k_out), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k_out), dtype=torch.int32, device=dev)
    fn = lib.frontier_push_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        fv.data_ptr(), fi.data_ptr(), q, k, run_v.data_ptr(),
        run_i.data_ptr(), r0, row_ptr.data_ptr(), out_deg.data_ptr(),
        col_idx.data_ptr(), sorted_col, row_repeats, float(1.0 - c), cap,
        slots, k_out, int(bool(run_first)), run_bv.data_ptr(), run_bi.data_ptr(),
        g_cv.data_ptr(), g_ci.data_ptr(), g_keys.data_ptr(), g_p,
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "frontier_push")
    return out_v, out_i


def _check_sharded_args(fv, fi, row_ptr, n_shard):
    q, k = fv.shape
    if fi.shape != (q, k):
        raise ValueError("sharded_frontier_push: fv and fi shapes differ")
    if row_ptr.shape != (n_shard + 1,):
        raise ValueError(
            f"sharded_frontier_push: row_ptr must hold n_shard + 1 = "
            f"{n_shard + 1} offsets, got {tuple(row_ptr.shape)}")


def sharded_frontier_push_plain(
    fv, fi, row_ptr, col_idx, *, c: float, degree_cap: int, ep: int,
    n_shard: int, wire_k: int, hub_split_degree: int = 0,
):
    """``verd.gather_push_edges`` then ``frontier.bucket_by_owner``, in
    blocks of rows; returns ``(f32[Q, ep, wire_k], int32[Q, ep, wire_k])``
    with owner-local indices."""
    from repro_torch.core import verd as verd_mod

    _check_sharded_args(fv, fi, row_ptr, n_shard)
    q, k = fv.shape
    m = col_idx.shape[0]
    h, s = verd_mod.resolve_hub_splits(min(degree_cap, max(m, 1)),
                                       hub_split_degree)
    deg = row_ptr[1:] - row_ptr[:-1]
    rows = max(1, PLAIN_BLOCK_ELEMS // max(k * s * h, 1))
    out_v = [torch.zeros((0, ep, wire_k), dtype=torch.float32,
                         device=fv.device)]
    out_i = [torch.zeros((0, ep, wire_k), dtype=torch.int32,
                         device=fv.device)]
    for r0 in range(0, q, rows):
        bfv = fv[r0:r0 + rows]
        bfi = fi[r0:r0 + rows].long()
        pv, nb = verd_mod.gather_push_edges(
            bfv, bfi, row_ptr[bfi], deg[bfi], col_idx, c=c,
            degree_cap=degree_cap, hub_split_degree=hub_split_degree)
        bv, bi = F.bucket_by_owner(pv, nb, ep, n_shard, wire_k)
        out_v.append(bv)
        out_i.append(bi)
    return torch.cat(out_v, dim=0), torch.cat(out_i, dim=0)


def sharded_frontier_push_cuda(
    fv, fi, row_ptr, col_idx, *, c: float, degree_cap: int, ep: int,
    n_shard: int, wire_k: int, hub_split_degree: int = 0,
):
    """Launch the CUDA kernels on the current stream: one counts each
    row's real edges, writes its per-slot edge offsets and claims a wide
    row's scratch; one pushes the narrow rows, one block each; the wide
    rows' kernels (gather and tile sorts, merge passes, group sums,
    per-owner selects) spread each wide row over many blocks.  Sizing the
    scratch and the wide grids reads three numbers back to the host, in
    one copy: the total of the wide rows' scratch regions, the longest,
    and the count of wide rows."""
    del hub_split_degree  # geometry only; the kernel gathers real edges
    dev = fv.device
    for name, t, dt in (
        ("fv", fv, torch.float32), ("fi", fi, torch.int32),
        ("row_ptr", row_ptr, torch.int32), ("col_idx", col_idx, torch.int32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"sharded_frontier_push: {name} must be a contiguous {dt} "
                f"tensor on {dev}, got {t.dtype} on {t.device}")
    _check_sharded_args(fv, fi, row_ptr, n_shard)
    q, k = fv.shape
    m = col_idx.shape[0]
    if m == 0 or ep < 1 or n_shard < 1 or wire_k < 1:
        raise ValueError(
            f"sharded_frontier_push: needs a non-empty slab, ep, n_shard and "
            f"wire_k >= 1, got m={m} ep={ep} n_shard={n_shard} "
            f"wire_k={wire_k}")
    local_bits = max(1, (n_shard - 1).bit_length())
    if ep.bit_length() + 31 + local_bits > 64:
        raise ValueError(
            f"sharded_frontier_push: ep={ep} x n_shard={n_shard} does not "
            "fit the kernel's 64-bit (owner, value, column) key")
    cap = min(degree_cap, m)
    if k * cap >= 2 ** 31:
        raise ValueError(
            f"sharded_frontier_push: a row of up to {k} x {cap} candidates "
            "does not fit the kernel's 32-bit positions")
    lib = build.load("sharded_frontier_push")
    stream = torch.cuda.current_stream(dev).cuda_stream
    count = torch.empty(q, dtype=torch.int32, device=dev)
    offsets = torch.empty(q, dtype=torch.int64, device=dev)
    slot_off = torch.empty((q, k + 1), dtype=torch.int32, device=dev)
    totals = torch.empty(3, dtype=torch.int64, device=dev)
    wide_rows = torch.empty(q, dtype=torch.int32, device=dev)
    out_v = torch.empty((q, ep, wire_k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, ep, wire_k), dtype=torch.int32, device=dev)
    size_fn = lib.sharded_frontier_push_size_launch
    size_fn.argtypes = _SHARDED_SIZE_ARGTYPES
    size_fn.restype = ctypes.c_int
    status = size_fn(fv.data_ptr(), fi.data_ptr(), q, k, row_ptr.data_ptr(),
                     cap, count.data_ptr(), offsets.data_ptr(),
                     slot_off.data_ptr(), totals.data_ptr(),
                     wide_rows.data_ptr(), stream)
    build.check_launch(status, "sharded_frontier_push")
    # the one host read; the narrow rows' push goes after it, so that it
    # runs while the host goes on
    total, longest, n_wide = totals.tolist()
    fn = lib.sharded_frontier_push_launch
    fn.argtypes = _SHARDED_ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        fv.data_ptr(), fi.data_ptr(), q, k, row_ptr.data_ptr(),
        col_idx.data_ptr(), float(1.0 - c), cap, ep, n_shard, local_bits,
        wire_k, count.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), stream,
    )
    build.check_launch(status, "sharded_frontier_push")
    if total == 0:
        return out_v, out_i
    tile_keys = lib.sharded_frontier_push_tile_keys
    tile_keys.argtypes, tile_keys.restype = [], ctypes.c_int
    tile_row = torch.empty(total // tile_keys(), dtype=torch.int32,
                           device=dev)
    g_cv = torch.empty(total, dtype=torch.float32, device=dev)
    keys_a = torch.empty(total, dtype=torch.int64, device=dev)
    keys_b = torch.empty(total, dtype=torch.int64, device=dev)
    wide_fn = lib.sharded_frontier_push_wide_launch
    wide_fn.argtypes = _SHARDED_WIDE_ARGTYPES
    wide_fn.restype = ctypes.c_int
    status = wide_fn(
        fv.data_ptr(), fi.data_ptr(), k, row_ptr.data_ptr(),
        col_idx.data_ptr(), float(1.0 - c), ep, n_shard, wire_k,
        count.data_ptr(), offsets.data_ptr(), slot_off.data_ptr(),
        wide_rows.data_ptr(), total, longest, n_wide, tile_row.data_ptr(),
        g_cv.data_ptr(), keys_a.data_ptr(), keys_b.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(), stream,
    )
    build.check_launch(status, "sharded_frontier_push")
    return out_v, out_i


# ---------------------------------------------------------------------------
# Contract-auditor entry points (repro_torch.analysis): register both push
# kernels under the hbm-residency rule.  The builders are lazy — they
# construct tiny synthetic fixtures only when `python -m
# repro_torch.analysis` runs the rule — and draw the reference's fixtures.
# ---------------------------------------------------------------------------

from repro_torch.analysis.registry import register_entry_point as _register_ep


def _contract_spec_frontier_push(device):
    import functools

    import numpy as np

    from repro_torch.core import verd as verd_mod
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    n, q, k, k_out = 2048, 16, 8, 16
    g = synthetic.erdos_renyi(n, 6.0, seed=7, device=device)
    cap = verd_mod.resolve_degree_cap(g)
    dev = g.device
    srcs = torch.as_tensor(rng.integers(0, n, q), dtype=torch.int32,
                           device=dev)
    fv = torch.as_tensor(rng.random((q, k)), dtype=torch.float32, device=dev)
    fi = torch.as_tensor(rng.integers(0, n, (q, k)), dtype=torch.int32,
                         device=dev)
    # the one-shot push: one chunk of every slot, the dangling mass after it
    run_v = torch.zeros((q, 1), dtype=torch.float32, device=dev)
    return dict(
        kernel="frontier_push",
        fn=functools.partial(
            ops.frontier_push, c=0.15, degree_cap=cap, hub_split_degree=0,
            slots=k, k_out=k_out, run_first=False),
        args=(fv, fi, run_v, srcs[:, None], g.row_ptr, g.out_deg, g.col_idx),
        operands={"col_idx": 6},
        hbm_shapes=[(g.m,)],
        dynamic_smem=lambda lib, args, kwargs: {"frontier_push_kernel": 0},
    )


def _sharded_dynamic_smem(lib, args, kwargs):
    """The wide path's planned bytes at the launch's (k, wire_k), from the
    library's own planner."""
    import ctypes

    fn = lib.sharded_frontier_push_wide_smem
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    sizes = (ctypes.c_int * 3)()
    fn(args[0].shape[1], kwargs["wire_k"], ctypes.addressof(sizes))
    return dict(zip(("sharded_wide_gather_kernel", "merge_pass_kernel",
                     "sharded_wide_select_kernel"), sizes))


def _contract_spec_sharded_push(device):
    import functools

    import numpy as np

    from repro_torch.core import verd as verd_mod
    from repro_torch.core.distributed_engine import (DistConfig,
                                                     build_sharded_graph)
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    n, q, k, wire_k = 2048, 16, 8, 8
    g = synthetic.erdos_renyi(n, 6.0, seed=7, device=device)
    cap = verd_mod.resolve_degree_cap(g)
    cfg = DistConfig(n=n, ep=2, degree_cap=cap)
    slabs = build_sharded_graph(g, cfg, device=g.device)
    ns = cfg.n_shard
    fv = torch.as_tensor(rng.random((q, k)), dtype=torch.float32,
                         device=g.device)
    fi = torch.as_tensor(np.clip(rng.integers(0, n, (q, k)), 0, ns - 1),
                         dtype=torch.int32, device=g.device)
    return dict(
        kernel="sharded_frontier_push",
        fn=functools.partial(
            ops.sharded_frontier_push, c=0.15, degree_cap=cap, ep=2,
            n_shard=ns, wire_k=wire_k),
        args=(fv, fi, slabs.row_ptr[0], slabs.col_idx[0]),
        operands={"col_idx": 3},
        hbm_shapes=[(slabs.col_idx.shape[1],)],
        dynamic_smem=_sharded_dynamic_smem,
    )


_register_ep("frontier-push", "hbm-residency",
             "src/repro_torch/kernels/frontier_push.py",
             _contract_spec_frontier_push)
_register_ep("sharded-frontier-push", "hbm-residency",
             "src/repro_torch/kernels/frontier_push.py",
             _contract_spec_sharded_push)
