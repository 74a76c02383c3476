"""``index_combine_sparse``: ``s + f @ P_hat`` on sparse state, top-k.

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

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
)


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
    lib = build.load("index_combine")
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
