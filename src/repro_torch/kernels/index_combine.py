"""The index combine ``s + f @ P_hat`` (paper Algorithm 4 line 10).

Dense (``index_combine``): ``out[q, :] = s[q, :] + sum_v f[q, v] *
scatter(vals[v, :] at idx[v, :])`` on ``[Q, n]`` state.
:func:`index_combine_plain` is the plain PyTorch version, chunked over
vertices as ``verd.combine_with_index`` is; :func:`index_combine_cuda`
launches ``csrc/index_combine_dense.cu``, which skips the zeros of ``f``.

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

import torch

from repro_torch.core import frontier as F
from repro_torch.kernels import build

# elements of one [Q, chunk, L] contribution block of the plain version
PLAIN_BLOCK_ELEMS = 1 << 25

_DENSE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
)


def index_combine_plain(s, f, vals, idx):
    """Dense combine ``f32[Q, n]`` from ``s f32[Q, n]``, ``f f32[Q, nv]``
    and index rows ``vals f32[nv, L]`` / ``idx int32[nv, L]``; columns
    outside ``[0, n)`` are dropped.  Scatter-adds in vertex chunks so the
    ``[Q, chunk, L]`` contributions stay bounded."""
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


def index_combine_cuda(s, f, vals, idx):
    """Launch the dense combine on the current stream (no sync)."""
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
    if q >= 65536 or max(q * n, q * nv, nv * l) >= 2 ** 31:
        raise ValueError(f"index_combine: shape {q} x {n} too large")
    if s.data_ptr() % 16:   # the copy reads s in 16 B words
        s = s.clone()
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    lib = build.load("index_combine")
    fn = lib.index_combine_dense_launch
    fn.argtypes = _DENSE_ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        s.data_ptr(), f.data_ptr(), vals.data_ptr(), idx.data_ptr(), q, n,
        nv, l, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
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
