"""``embedding_bag``: the bag-sum lookup of the recsys embedding tables.

``out[r, :] = sum_i mask[r, i] * round(table[ids[r, i], :])`` (a null
``mask`` weighs every slot one) with ``round`` a cast of each gathered row
to ``row_dtype`` (the compute dtype the reference casts its whole table to
before ``jnp.take``; here only the gathered rows are rounded, so the table
is never copied), the products and their sum in f32 in bag order, and the
result cast to ``out_dtype``.  An id in ``[-V, 0)`` counts from the end of
the table; any other id outside ``[0, V)`` gives a NaN row, as
``jnp.take`` does.

:func:`embedding_bag_plain` is the plain PyTorch version (the CPU path and
the oracle on the card); :func:`embedding_bag_cuda` launches
``csrc/embedding_bag.cu`` on the grid :func:`launch_plan` sizes.  Callers
go through :func:`repro_torch.kernels.ops.embedding_bag`.

The gradient with respect to the table (``ops.embedding_bag`` is a
``torch.autograd.Function`` when the table needs one) is
:func:`embedding_bag_backward_plain` and :func:`embedding_bag_backward_cuda`
(``csrc/embedding_bag_backward.cu``): the reference's autodiff of
``jnp.take`` of the cast table, a scatter-add of each slot's row gradient
``round(g[r] * mask[r, i])`` (``round`` to ``row_dtype``) into a zero table
of ``row_dtype``, one add at a time in slot order (row-major over ``[R,
bag]``), each sum rounded to ``row_dtype`` (XLA's scatter on the CPU adds
bf16 updates into a bf16 table), widened to f32.  Ids in ``[-V, 0)`` count
from the end; others outside ``[0, V)`` give no gradient (``jnp.take``'s
fill mode drops them); rows no slot hits are zero.  Both sort the slots by
id, stably, and sum each run of equal ids in slot order, so there are no
atomics and two launches give the same bytes; the kernel writes every row
of the gradient itself, the zeros included (:class:`BackwardPlan`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

ROW_DTYPES = (torch.float32, torch.bfloat16)
OUT_DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong]
             + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
WARPS = 8            # warps a block (``kWarps``)
MAX_CHUNK = 32       # rows a chunk: one id a lane (``kMaxChunk``)
PACKED_LANES = (4, 8, 16)   # D / 4 lanes of float4 a row (D = 16, 32, 64)

_blocks_per_sm = {}  # (device, one-slot, mask, vec, lanes, dtypes) -> blocks
BACKWARD_WARPS = 8   # warps a block of the backward (``kWarps``)
BACKWARD_TILE_BYTES = 32768      # output bytes a tile at most
BACKWARD_MIN_TILE_BYTES = 4096   # ... and at least, where rows allow
BACKWARD_MAX_TILE_ROWS = 1024    # rows a tile (``kMaxTileRows``)
BACKWARD_MAX_SLOTS = 2**31 - 64  # 32-bit positions (``kBatch`` past the last)
_backward_blocks_per_sm = {}     # (device, bf16 grad, vec, passes) -> blocks


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel covers ``rows`` output rows of ``d`` columns: ``vec``
    values a load, ``lanes_per_row`` lanes a row (each lane at columns
    ``(lane % lanes_per_row) * vec`` plus multiples of ``lanes_per_row *
    vec``), warps of 32 lanes over chunks of ``chunk`` rows with a grid
    stride of ``blocks * WARPS`` chunks."""
    vec: int
    lanes_per_row: int
    chunk: int
    blocks: int

    @property
    def rows_per_instruction(self) -> int:
        return 32 // self.lanes_per_row


def lanes_per_row(d: int, vec: int) -> int:
    """``d / 4`` lanes of float4 where that divides a warp evenly (several
    rows a warp instruction), else a whole warp across one row."""
    return d // 4 if vec == 4 and d // 4 in PACKED_LANES else 32


def launch_plan(rows: int, d: int, vec: int, sms: int,
                blocks_per_sm: int) -> LaunchPlan:
    """The persistent grid (``sms * blocks_per_sm`` blocks at most) and the
    chunk: 32 rows, halved (down to one row a lane) while the halved
    chunks would still all be in flight at once, so a small launch spreads
    over every SM and no warp waits for a second chunk."""
    lanes = lanes_per_row(d, vec)
    resident = sms * blocks_per_sm
    chunk = MAX_CHUNK
    while chunk > 32 // lanes and -(-rows // (chunk // 2)) <= resident * WARPS:
        chunk //= 2
    n_chunks = -(-rows // chunk)
    return LaunchPlan(vec, lanes, chunk,
                      max(1, min(resident, -(-n_chunks // WARPS))))


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
    f32[R, bag]`` (``None``: weight one) over ``table [V, D]``: ``[R, D]``
    of ``out_dtype``, summed in bag order as the kernel sums; one slot
    position gathered at a time, so it holds ``[R, D]``, never ``[R, bag,
    D]``."""
    out = None
    for i in range(ids.shape[1]):
        row = gather_rows(table, ids[:, i]).to(row_dtype).to(torch.float32)
        if mask is not None:
            row = row * mask[:, i].to(torch.float32)[:, None]
        out = row if out is None else out + row
    return out.to(out_dtype)


def _occupancy(lib, dev, *variant) -> int:
    """Resident blocks an SM holds for ``variant`` (one-slot bags, a mask,
    vec, lanes a row, bf16 rows, bf16 out), asked of the card once."""
    key = (dev.index, *variant)
    if key not in _blocks_per_sm:
        fn = lib.embedding_bag_occupancy
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        build.check_launch(fn(*variant, ctypes.addressof(n)),
                           "embedding_bag occupancy")
        _blocks_per_sm[key] = max(1, n.value)
    return _blocks_per_sm[key]


def embedding_bag_cuda(ids, mask, table, *, row_dtype=torch.float32,
                       out_dtype=torch.float32):
    """Launch the CUDA kernel on the current stream (no sync); ``mask``
    may be ``None`` (weight one, and no mask read)."""
    dev = ids.device
    checks = [("ids", ids, torch.int32), ("table", table, torch.float32)]
    if mask is not None:
        checks.append(("mask", mask, torch.float32))
    for name, t, dt in checks:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"embedding_bag: {name} must be a contiguous {dt} tensor on "
                f"{dev}, got {t.dtype} on {t.device}")
    if row_dtype not in ROW_DTYPES or out_dtype not in OUT_DTYPES:
        raise ValueError(f"embedding_bag: row dtype {row_dtype} / out dtype "
                         f"{out_dtype} not in {ROW_DTYPES} / {OUT_DTYPES}")
    if (ids.dim() != 2 or table.dim() != 2
            or (mask is not None and mask.shape != ids.shape)):
        raise ValueError("embedding_bag: ids and mask must be [R, bag] and "
                         "table [V, D]")
    rows, bag = ids.shape
    vocab, d = table.shape
    if bag == 0 or vocab == 0:
        raise ValueError(f"embedding_bag: needs bag >= 1 and a table of at "
                         f"least one row, got bag {bag}, {vocab} rows")
    out = torch.empty((rows, d), dtype=out_dtype, device=dev)
    vec = next(v for v in (4, 2, 1)
               if d % v == 0 and table.data_ptr() % (4 * v) == 0)
    round_bf16 = int(row_dtype == torch.bfloat16)
    out_bf16 = int(out_dtype == torch.bfloat16)
    lib = build.load("embedding_bag")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(rows, d, vec, sms, _occupancy(
        lib, dev, int(bag == 1), int(mask is not None), vec,
        lanes_per_row(d, vec), round_bf16, out_bf16))
    fn = lib.embedding_bag_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    status = fn(
        ids.data_ptr(), None if mask is None else mask.data_ptr(),
        table.data_ptr(), rows, bag, vocab, d, round_bf16, out_bf16,
        plan.vec, plan.lanes_per_row, plan.chunk, plan.blocks,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "embedding_bag")
    return out


# -- the gradient with respect to the table -----------------------------------

def sort_slots(ids: torch.Tensor, vocab: int):
    """``(sorted keys int32[S], slot order int64[S])`` of the ``S = R * bag``
    slots, sorted by row id, stably (slot order within a run of equal ids);
    negative ids count from the end, ids outside ``[-V, V)`` take the key
    ``vocab`` and sort last."""
    i = ids.reshape(-1).long()
    i = torch.where(i < 0, i + vocab, i)
    key = torch.where((i >= 0) & (i < vocab), i, vocab).to(torch.int32)
    return torch.sort(key, stable=True)


def embedding_bag_backward_plain(ids, mask, grad_out, vocab: int, *,
                                 row_dtype=torch.float32):
    """``grad_table f32[vocab, D]`` of ``ids int[R, bag]``, ``mask f32[R,
    bag]`` (``None``: weight one) and ``grad_out [R, D]``: each run of
    equal ids summed in slot order, each sum rounded to ``row_dtype`` (one
    vectorized add per position within a run, so a run of ``n`` slots
    costs ``n`` passes)."""
    rows, bag = ids.shape
    d = grad_out.shape[1]
    dev = grad_out.device
    out = torch.zeros((vocab, d), dtype=torch.float32, device=dev)
    if ids.numel() == 0 or vocab == 0:
        return out
    key, order = sort_slots(ids, vocab)
    g = grad_out.to(torch.float32)
    n = key.numel()
    pos = torch.arange(n, device=dev)
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = key[1:] != key[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    live = key < vocab
    by_rank = torch.sort(torch.where(live, rank, n), stable=True)
    counts = torch.bincount(rank[live], minlength=1).tolist()
    at = 0
    for c in counts:                       # position c within each run
        sel = by_rank.indices[at:at + c]
        at += c
        slot = order[sel]
        x = g[slot // bag]
        if mask is not None:
            x = x * mask.reshape(-1)[slot].to(torch.float32)[:, None]
        x = x.to(row_dtype).to(torch.float32)
        dst = key[sel].long()
        out[dst] = (out[dst] + x).to(row_dtype).to(torch.float32)
    return out


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How ``csrc/embedding_bag_backward.cu`` covers a ``[vocab, d]``
    gradient: ``vec`` gradient elements a load, ``lanes_per_row`` lanes a
    run's row (lane ``l`` of a group at vectors ``l + j * lanes_per_row``,
    ``j < passes``, in column blocks of ``passes * lanes_per_row``
    vectors), tiles of ``rows_per_tile`` contiguous rows (``tiles`` of
    them), one warp a tile with a grid stride over ``blocks *
    BACKWARD_WARPS`` warps."""
    vec: int
    lanes_per_row: int
    passes: int
    rows_per_tile: int
    tiles: int
    blocks: int


def backward_layout(d: int, elem_bytes: int, ptr: int):
    """``(vec, lanes_per_row, passes)`` for rows of ``d`` gradient elements
    of ``elem_bytes`` at address ``ptr``: the widest load of at most 16
    bytes that divides the row and the pointer's alignment; then the fewest
    lanes (a power of two) that cover the row's vectors in one load each,
    or a whole warp in up to 4 loads a lane (column blocks past that).
    Measured at SASRec's and MIND's train shapes, fewer lanes with more
    loads each (2 or 4) were no faster overall (``PERF.md``)."""
    vec = next(v for v in (8, 4, 2, 1)
               if v * elem_bytes <= 16 and d % v == 0
               and ptr % (v * elem_bytes) == 0)
    nv = d // vec
    lanes = build.next_pow2(nv) if nv <= 32 else 32
    return vec, lanes, 1 if nv <= 32 else 4


def backward_plan(vocab: int, d: int, layout, sms: int,
                  blocks_per_sm: int) -> BackwardPlan:
    """Tiles of ``BACKWARD_TILE_BYTES`` of f32 output (at most
    ``BACKWARD_MAX_TILE_ROWS`` rows), halved down to
    ``BACKWARD_MIN_TILE_BYTES`` while there would be fewer than two tiles a
    resident warp, so the last tiles of a launch are short; the persistent
    grid is the card's resident blocks, or fewer where the tiles are
    fewer."""
    vec, lanes, passes = layout
    resident = sms * blocks_per_sm
    rows = max(1, min(BACKWARD_MAX_TILE_ROWS, BACKWARD_TILE_BYTES // (4 * d)))
    while (rows > 1 and -(-vocab // rows) < 2 * resident * BACKWARD_WARPS
           and (rows // 2) * 4 * d >= BACKWARD_MIN_TILE_BYTES):
        rows //= 2
    tiles = -(-vocab // rows)
    return BackwardPlan(vec, lanes, passes, rows, tiles,
                        max(1, min(resident, -(-tiles // BACKWARD_WARPS))))


def _backward_occupancy(lib, dev, *variant) -> int:
    """Resident blocks an SM holds for ``variant`` (bf16 gradient, vec,
    passes), asked of the card once."""
    key = (dev.index, *variant)
    if key not in _backward_blocks_per_sm:
        fn = lib.embedding_bag_backward_occupancy
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        n = ctypes.c_int(0)
        build.check_launch(fn(*variant, ctypes.addressof(n)),
                           "embedding_bag_backward occupancy")
        _backward_blocks_per_sm[key] = max(1, n.value)
    return _backward_blocks_per_sm[key]


def cuda_backward_plan(grad_out, vocab: int) -> BackwardPlan:
    """The plan :func:`embedding_bag_backward_cuda` launches with for the
    CUDA gradient ``grad_out [R, D]`` and a ``vocab``-row table."""
    dev = grad_out.device
    d = grad_out.shape[1]
    lib = build.load("embedding_bag_backward")
    layout = backward_layout(d, grad_out.element_size(), grad_out.data_ptr())
    per_sm = _backward_occupancy(
        lib, dev, int(grad_out.dtype == torch.bfloat16), layout[0], layout[2])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return backward_plan(vocab, d, layout, sms, per_sm)


def embedding_bag_backward_cuda(ids, mask, grad_out, vocab: int, *,
                                row_dtype=torch.float32, out=None):
    """Launch ``csrc/embedding_bag_backward.cu`` on the current stream (no
    sync): the stable sort of the slots (``torch.sort``), then the kernel,
    which writes every element of the ``[vocab, D]`` f32 gradient once (its
    pre-pass first finds each tile's first sorted position).  ``out`` (for
    tests) is the gradient to write, a contiguous 16-byte aligned f32
    ``[vocab, D]`` tensor; by default it is allocated and not filled."""
    dev = grad_out.device
    if ids.device != dev or (mask is not None and (
            mask.device != dev or mask.dtype != torch.float32
            or not mask.is_contiguous() or mask.shape != ids.shape)):
        raise ValueError(
            "embedding_bag_backward: ids and mask (f32, contiguous, of ids' "
            f"shape) must be on {dev}")
    if (grad_out.dtype not in OUT_DTYPES or row_dtype not in ROW_DTYPES
            or not grad_out.is_contiguous() or grad_out.dim() != 2
            or ids.dim() != 2 or grad_out.shape[0] != ids.shape[0]):
        raise ValueError(
            f"embedding_bag_backward: grad_out [R, D] contiguous of "
            f"{OUT_DTYPES} for ids [R, bag], row dtype in {ROW_DTYPES}; got "
            f"{grad_out.dtype} {list(grad_out.shape)}, ids "
            f"{list(ids.shape)}, {row_dtype}")
    rows, bag = ids.shape
    d = grad_out.shape[1]
    slots = rows * bag
    if out is not None and (
            out.device != dev or out.dtype != torch.float32
            or not out.is_contiguous() or tuple(out.shape) != (vocab, d)
            or out.data_ptr() % 16 != 0):
        raise ValueError(
            f"embedding_bag_backward: out must be a contiguous, 16-byte "
            f"aligned f32 [{vocab}, {d}] tensor on {dev}")
    if (slots >= BACKWARD_MAX_SLOTS
            or vocab > 2**31 - 1 - BACKWARD_MAX_TILE_ROWS):
        raise ValueError(
            f"embedding_bag_backward: {slots} slots and {vocab} rows; the "
            f"kernel's positions and rows are 32-bit (fewer than "
            f"{BACKWARD_MAX_SLOTS} slots)")
    if slots == 0 or vocab == 0 or d == 0:
        if out is None:
            return torch.zeros((vocab, d), dtype=torch.float32, device=dev)
        return out.zero_()
    key, order = sort_slots(ids, vocab)
    lib = build.load("embedding_bag_backward")
    plan = cuda_backward_plan(grad_out, vocab)
    starts = torch.empty(plan.tiles + 1, dtype=torch.int32, device=dev)
    if out is None:
        out = torch.empty((vocab, d), dtype=torch.float32, device=dev)
    fn = lib.embedding_bag_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    status = fn(
        key.data_ptr(), order.data_ptr(),
        None if mask is None else mask.data_ptr(), grad_out.data_ptr(),
        slots, bag, vocab, d, int(row_dtype == torch.bfloat16),
        int(grad_out.dtype == torch.bfloat16),
        plan.vec, plan.lanes_per_row, plan.passes, plan.rows_per_tile,
        plan.blocks, starts.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(status, "embedding_bag_backward")
    return out
