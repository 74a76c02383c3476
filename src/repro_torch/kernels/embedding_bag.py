"""``embedding_bag``: the bag-sum lookup of the recsys embedding tables.

``out[r, :] = sum_i mask[r, i] * round(table[ids[r, i], :])`` with
``round`` a cast of each gathered row to ``row_dtype`` (the compute dtype
the reference casts its whole table to before ``jnp.take``; here only the
gathered rows are rounded, so the table is never copied), the products and
their sum in f32 in bag order, and the result cast to ``out_dtype``.  An id
in ``[-V, 0)`` counts from the end of the table; any other id outside
``[0, V)`` gives a NaN row, as ``jnp.take`` does.

:func:`embedding_bag_plain` is the plain PyTorch version (the CPU path and
the oracle on the card); :func:`embedding_bag_cuda` launches
``csrc/embedding_bag.cu``.  Callers go through
:func:`repro_torch.kernels.ops.embedding_bag`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

ROW_DTYPES = (torch.float32, torch.bfloat16)
OUT_DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (``[*ids.shape, D]``) with ``jnp.take``'s semantics:
    negative ids count from the end, ids outside ``[-V, V)`` give NaN rows."""
    v = table.shape[0]
    i = ids.long()
    i = torch.where(i < 0, i + v, i)
    ok = (i >= 0) & (i < v)
    rows = table[torch.where(ok, i, 0)]
    return torch.where(ok[..., None], rows, float("nan"))


def embedding_bag_plain(ids, mask, table, *, row_dtype=torch.float32,
                        out_dtype=torch.float32):
    """The bag sum of ``ids int[R, bag]`` (``bag >= 1``) weighted by ``mask
    f32[R, bag]`` over ``table [V, D]``: ``[R, D]`` of ``out_dtype``, summed
    in bag order as the kernel sums."""
    rows = gather_rows(table, ids).to(row_dtype).to(torch.float32)
    mask = mask.to(torch.float32)
    out = rows[:, 0] * mask[:, :1]
    for i in range(1, ids.shape[1]):
        out = out + rows[:, i] * mask[:, i:i + 1]
    return out.to(out_dtype)


def embedding_bag_cuda(ids, mask, table, *, row_dtype=torch.float32,
                       out_dtype=torch.float32):
    """Launch the CUDA kernel on the current stream (no sync)."""
    dev = ids.device
    for name, t, dt in (("ids", ids, torch.int32),
                        ("mask", mask, torch.float32),
                        ("table", table, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"embedding_bag: {name} must be a contiguous {dt} tensor on "
                f"{dev}, got {t.dtype} on {t.device}")
    if row_dtype not in ROW_DTYPES or out_dtype not in OUT_DTYPES:
        raise ValueError(f"embedding_bag: row dtype {row_dtype} / out dtype "
                         f"{out_dtype} not in {ROW_DTYPES} / {OUT_DTYPES}")
    if ids.dim() != 2 or mask.shape != ids.shape or table.dim() != 2:
        raise ValueError("embedding_bag: ids and mask must be [R, bag] and "
                         "table [V, D]")
    rows, bag = ids.shape
    vocab, d = table.shape
    if bag == 0 or vocab == 0:
        raise ValueError(f"embedding_bag: needs bag >= 1 and a table of at "
                         f"least one row, got bag {bag}, {vocab} rows")
    out = torch.empty((rows, d), dtype=out_dtype, device=dev)
    vec2 = d % 2 == 0 and table.data_ptr() % 8 == 0
    lib = build.load("embedding_bag")
    fn = lib.embedding_bag_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        ids.data_ptr(), mask.data_ptr(), table.data_ptr(), rows, bag, vocab,
        d, int(row_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(vec2), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "embedding_bag")
    return out
