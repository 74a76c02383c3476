"""``ell_spmm``: the dense frontier push ``f @ A0`` over the chunked ELL view.

``partial[q, r] = sum_k w[r, k] * f[q, nbr[r, k]]`` is the TPU kernel's
function; the port folds each vertex's rows (``row2vertex`` runs, bounds in
``vertex_rows``) inside the kernel, so the kernel and its plain version
both return the folded ``f32[Q, n_out]``.  With one row per vertex
(``vertex_rows = arange(rows + 1)``) the fold is the identity and the
result is the reference's raw partials.

:func:`ell_spmm_plain` is the plain PyTorch version (the CPU path and the
oracle on the card); :func:`ell_spmm_cuda` launches ``csrc/ell_spmm.cu``,
which gathers only the columns of ``f`` that hold a non-zero.
Callers go through :func:`repro_torch.kernels.ops.ell_push`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# elements of one gathered [Q, rows, K] block of the plain version (128 MiB
# of f32): at rmat(20) the whole gather would be 16 GB
PLAIN_BLOCK_ELEMS = 1 << 25

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2)


def ell_spmm_partial_plain(f, nbr, w):
    """Raw partials ``f32[Q, rows]``: ``sum_k w[r, k] * f[q, nbr[r, k]]``
    (the reference kernel's output), gathered in row blocks."""
    q = f.shape[0]
    rows, k = nbr.shape
    out = torch.empty((q, rows), dtype=torch.float32, device=f.device)
    step = max(1, PLAIN_BLOCK_ELEMS // max(q * k, 1))
    for r0 in range(0, rows, step):
        nb = nbr[r0:r0 + step]
        g = f[:, nb.reshape(-1).long()].reshape(q, nb.shape[0], k)
        out[:, r0:r0 + nb.shape[0]] = (g * w[r0:r0 + step][None]).sum(dim=-1)
    return out


def ell_spmm_plain(f, nbr, w, row2vertex, vertex_rows, rows_used: int):
    """Folded push ``f32[Q, n_out]`` (``n_out = len(vertex_rows) - 1``):
    the partials of the first ``rows_used`` rows summed into their
    vertices."""
    n_out = vertex_rows.shape[0] - 1
    partial = ell_spmm_partial_plain(f, nbr[:rows_used], w[:rows_used])
    out = torch.zeros((f.shape[0], n_out), dtype=torch.float32,
                      device=f.device)
    return out.index_add_(1, row2vertex[:rows_used].long(), partial)


def ell_spmm_cuda(f, nbr, w, row2vertex, vertex_rows, rows_used: int):
    """Launch the CUDA kernels on the current stream (no sync)."""
    dev = f.device
    for name, t, dt in (
        ("f", f, torch.float32), ("nbr", nbr, torch.int32),
        ("w", w, torch.float32), ("row2vertex", row2vertex, torch.int32),
        ("vertex_rows", vertex_rows, torch.int32),
    ):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"ell_spmm: {name} must be a contiguous {dt} tensor on {dev}, "
                f"got {t.dtype} on {t.device}")
    q, n_in = f.shape
    rows, k = nbr.shape
    n_out = vertex_rows.shape[0] - 1
    if (w.shape != (rows, k) or row2vertex.shape != (rows,)
            or not 0 <= rows_used <= rows or n_out < 0):
        raise ValueError("ell_spmm: mismatched shapes")
    if max(q * n_in, q * n_out, rows * k) >= 2 ** 31:
        raise ValueError("ell_spmm: a tensor exceeds 2**31 elements")
    if rows_used and k < 1:
        raise ValueError("ell_spmm: the ELL view needs k >= 1")
    lib = build.load("ell_spmm")
    rows_per_block = lib.ell_spmm_rows_per_block
    rows_per_block.argtypes, rows_per_block.restype = [], ctypes.c_int
    n_blocks = max(1, -(-rows_used // rows_per_block()))
    out = torch.empty((q, n_out), dtype=torch.float32, device=dev)
    # the live columns, transposed: allocated for all n_in, so the count
    # of live columns stays on the device
    slot = torch.empty(n_in, dtype=torch.int32, device=dev)
    ftc = torch.empty((n_in, q), dtype=torch.float32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    carry = torch.empty((2, n_blocks, q), dtype=torch.float32, device=dev)
    fn = lib.ell_spmm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        f.data_ptr(), nbr.data_ptr(), w.data_ptr(), row2vertex.data_ptr(),
        vertex_rows.data_ptr(), q, n_in, n_out, rows_used, k,
        slot.data_ptr(), ftc.data_ptr(), n_live.data_ptr(), carry.data_ptr(),
        n_blocks, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "ell_spmm")
    return out
