"""Kernel wrappers: pick the CUDA kernel or its plain version by device.

A CUDA tensor goes to the hand-written kernel (or the wrapper raises); a
CPU tensor goes to the plain PyTorch version.  There is no fallback from
one to the other.  A meta tensor under an active
``roofline.cost.CostCounter`` (the dry-run) computes nothing on any path:
the wrapper returns empty meta outputs of its plain version's shapes and
dtypes and charges the counter the reference's rule for a custom call,
its operands and outputs once and no FLOPs.  That charge is no bound of
the kernel (it counts the whole CSR or table a gather reads in part), and
it counts no launch.  A meta tensor with no counter is refused.  Each wrapper adds one to its launch count where it
launches its kernel and nowhere else (:func:`launch_counts`, the
counterpart of ``repro.kernels.ops.kernel_invocations``), so a run can
show that its main path went through the kernels.

``capture_first_launches`` keeps a reference to the arguments of each
kernel's first launch (per variant: ``frontier_push`` records its one-shot
and its streamed fold apart; ``ell_spmm`` records its first launch since
the last reset and the one after it, which in a dense batch are the push
of the one-hot sources and the push of a frontier spread over thousands
of vertices; ``sharded_frontier_push`` records its first launch and its
launch number ``ep``, which in a tile step are shard 0's pushes of the
one-hot sources and of the second iteration's frontier), so a check can
replay exactly the inputs the main path gave it.  With ``last=True`` it
keeps each variant's last launch instead (``ell_spmm``'s "later" is then
the last push of a run: a late power iteration's dense frontier).

A CUDA graph launches its kernels with no wrapper call.  Its capture runs
inside :func:`recording_launches`, which collects the graph's launches per
kernel instead of counting them (and records no arguments: a capture's
tensors live in the graph's pool, which every replay overwrites); each
replay adds them with :func:`add_replayed_launches` (``core/capture.py``),
so the counts include replayed launches.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Iterator, Mapping, Optional

import torch

from repro_torch.kernels import ell_spmm as _ell
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import frontier_push as _push
from repro_torch.kernels import index_combine as _comb
from repro_torch.kernels import walk_step as _walk
from repro_torch.roofline import cost as _cost

KERNELS = ("walk_step", "frontier_push", "index_combine_sparse", "ell_spmm",
           "index_combine", "sharded_frontier_push", "embedding_bag",
           "embedding_bag_backward")

_launches: collections.Counter = collections.Counter()
_captured: Optional[Dict[str, tuple]] = None
_capture_last = False
_recording: Optional[collections.Counter] = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: int(_launches[name]) for name in KERNELS}


def reset_launch_counts() -> None:
    _launches.clear()


def capture_first_launches(enabled: bool = True, *,
                           last: bool = False) -> None:
    """Start (or stop) recording each kernel variant's first launch
    arguments (its last with ``last``)."""
    global _captured, _capture_last
    _captured = {} if enabled else None
    _capture_last = last


def captured_launches() -> Dict[str, tuple]:
    """``"name/variant" -> (args, kwargs)`` of each kernel variant's first
    (or last) recorded launch."""
    return dict(_captured or {})


@contextlib.contextmanager
def recording_launches() -> Iterator[collections.Counter]:
    """Around a graph capture: the wrappers' launches go to the yielded
    counter instead of the counts, and record no arguments."""
    global _recording
    prev, _recording = _recording, collections.Counter()
    try:
        yield _recording
    finally:
        _recording = prev


def add_replayed_launches(counts: Mapping[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``counts``."""
    _launches.update(counts)


def _launched(name: str, args: tuple, kwargs: dict,
              variant: Optional[str] = "main") -> None:
    if _recording is not None:
        _recording[name] += 1
        return
    _launches[name] += 1
    tag = f"{name}/{variant}"
    if _captured is not None and variant and (
            _capture_last or tag not in _captured):
        _captured[tag] = (args, kwargs)


def _route(name: str, tensor: torch.Tensor) -> str:
    """``"cuda"`` for the kernel, ``"cpu"`` for the plain version,
    ``"meta"`` for a dry-run's charge (under an active cost counter only);
    raises on any other device."""
    if tensor.is_cuda:
        return "cuda"
    if tensor.device.type == "cpu":
        return "cpu"
    if tensor.device.type == "meta" and _cost.active() is not None:
        return "meta"
    raise ValueError(f"{name}: unsupported device {tensor.device}")


def _charged(inputs, *outputs):
    """The meta branch: empty meta outputs ``(shape, dtype)``, the
    operands and outputs charged once to the active counter."""
    out = tuple(torch.empty(shape, dtype=dt, device="meta")
                for shape, dt in outputs)
    _cost.charge_custom(inputs, out)
    return out if len(out) > 1 else out[0]


def walk_step(cursors, sources, u, row_ptr, out_deg, col_idx):
    """One bulk walk advance (``walks.advance_cursors``); any cursor shape,
    ``sources`` of that shape or one per row (a trailing 1 allowed)."""
    sources = sources.to(torch.int32)
    if sources.shape != cursors.shape:
        sources = sources.reshape(cursors.shape[:-1])
    if col_idx.shape[0] == 0:  # edgeless graph: every walk jumps home
        return _walk.walk_sources(cursors, sources).clone()
    route = _route("walk_step", cursors)
    if route == "cpu":
        return _walk.walk_step_plain(
            cursors, sources, u, row_ptr, out_deg, col_idx)
    if route == "meta":
        return _charged((cursors, sources, u, row_ptr, out_deg, col_idx),
                        (cursors.shape, torch.int32))
    args = (cursors.contiguous(), sources.contiguous(), u.contiguous(),
            row_ptr, out_deg, col_idx)
    out = _walk.walk_step_cuda(*args)
    _launched("walk_step", args, {})
    return out


def frontier_push(
    fv, fi, run_v, run_i, row_ptr, out_deg, col_idx, *,
    c: float, degree_cap: int, hub_split_degree: int, slots: int,
    k_out: int, run_first: bool, sorted_view=None,
):
    """Chunked gather-push folds (see ``kernels/frontier_push.py``);
    ``sorted_view`` (``Graph.col_sorted()``) lets the kernel fold one-slot
    chunks without sorting them."""
    kwargs = dict(c=c, degree_cap=degree_cap,
                  hub_split_degree=hub_split_degree, slots=slots,
                  k_out=k_out, run_first=run_first, sorted_view=sorted_view)
    route = _route("frontier_push", fv)
    if route == "cpu":
        return _push.frontier_push_plain(
            fv, fi, run_v, run_i, row_ptr, out_deg, col_idx, **kwargs)
    if route == "meta":
        q = fv.shape[0]
        return _charged((fv, fi, run_v, run_i, row_ptr, out_deg, col_idx),
                        ((q, k_out), torch.float32), ((q, k_out), torch.int32))
    args = (fv.contiguous(), fi.contiguous(), run_v.contiguous(),
            run_i.contiguous(), row_ptr, out_deg, col_idx)
    out = _push.frontier_push_cuda(*args, **kwargs)
    _launched("frontier_push", args, kwargs,
              "streamed" if run_first else "one-shot")
    return out


def index_combine_sparse(sv, si, fv, fi, vals, idx, *, k_out: int):
    """Sparse ``s + f @ P_hat`` compacted to ``k_out`` (arrays form)."""
    route = _route("index_combine_sparse", fv)
    if route == "cpu":
        return _comb.index_combine_sparse_plain(
            sv, si, fv, fi, vals, idx, k_out=k_out)
    if route == "meta":
        q = fv.shape[0]
        return _charged((sv, si, fv, fi, vals, idx),
                        ((q, k_out), torch.float32), ((q, k_out), torch.int32))
    args = (sv.contiguous(), si.contiguous(), fv.contiguous(),
            fi.contiguous(), vals, idx)
    out = _comb.index_combine_sparse_cuda(*args, k_out=k_out)
    _launched("index_combine_sparse", args, dict(k_out=k_out))
    return out


def ell_push(frontier, ell):
    """``frontier @ A0`` through the chunked ELL view (``f32[Q, n] ->
    f32[Q, n]``), each vertex's rows folded; any ``Q``."""
    args = (frontier.to(torch.float32).contiguous(), ell.nbr, ell.weight,
            ell.row2vertex, ell.vertex_rows)
    kwargs = dict(rows_used=ell.rows_used)
    route = _route("ell_spmm", frontier)
    if route == "cpu":
        return _ell.ell_spmm_plain(*args, **kwargs)
    if route == "meta":
        return _charged(args, ((frontier.shape[0],
                                ell.vertex_rows.shape[0] - 1), torch.float32))
    variant = "first" if _launches["ell_spmm"] == 0 else "later"
    out = _ell.ell_spmm_cuda(*args, **kwargs)
    _launched("ell_spmm", args, kwargs, variant)
    return out


def index_combine(s, f, vals, idx, columns=None):
    """Dense ``s + f @ P_hat``: ``s f32[Q, n]``, ``f f32[Q, nv]`` and an
    index of at least ``nv`` rows (rows past ``nv`` are never touched);
    ``columns`` is the kernel's transposed view of the first ``nv`` rows
    (``PPRIndex.columns``), which the plain version does not read."""
    nv = f.shape[1]
    if vals.shape[0] < nv:
        raise ValueError(f"index_combine: index has {vals.shape[0]} rows "
                         f"< {nv} frontier columns")
    args = (s.contiguous(), f.contiguous(), vals[:nv], idx[:nv])
    route = _route("index_combine", f)
    if route == "cpu":
        return _comb.index_combine_plain(*args)
    if route == "meta":
        return _charged(args, (s.shape, torch.float32))
    kwargs = dict(columns=columns)
    out = _comb.index_combine_cuda(*args, **kwargs)
    _launched("index_combine", args, kwargs)
    return out


def sharded_frontier_push(
    fv, fi, row_ptr, col_idx, *, c: float, degree_cap: int, ep: int,
    n_shard: int, wire_k: int, hub_split_degree: int = 0,
):
    """One shard's local push + per-owner exchange buckets (see
    ``kernels/frontier_push.py``): ``(f32[Q, ep, wire_k], int32[Q, ep,
    wire_k])`` with owner-local indices."""
    kwargs = dict(c=c, degree_cap=degree_cap, ep=ep, n_shard=n_shard,
                  wire_k=wire_k, hub_split_degree=hub_split_degree)
    route = _route("sharded_frontier_push", fv)
    if route == "cpu":
        return _push.sharded_frontier_push_plain(
            fv, fi, row_ptr, col_idx, **kwargs)
    if route == "meta":   # static outputs: no host read of the totals
        shape = (fv.shape[0], ep, wire_k)
        return _charged((fv, fi, row_ptr, col_idx),
                        (shape, torch.float32), (shape, torch.int32))
    args = (fv.contiguous(), fi.contiguous(), row_ptr.contiguous(),
            col_idx.contiguous())
    n = _launches["sharded_frontier_push"]
    out = _push.sharded_frontier_push_cuda(*args, **kwargs)
    _launched("sharded_frontier_push", args, kwargs,
              {0: "first", ep: "second"}.get(n))
    return out


def _embedding_bag_forward(ids, mask, table, row_dtype, out_dtype):
    kwargs = dict(row_dtype=row_dtype, out_dtype=out_dtype)
    route = _route("embedding_bag", ids)
    if route == "cpu":
        return _bag.embedding_bag_plain(ids, mask, table, **kwargs)
    if route == "meta":
        return _charged((ids, mask, table),
                        ((ids.shape[0], table.shape[1]), out_dtype))
    args = (ids.to(torch.int32).contiguous(),
            None if mask is None else mask.to(torch.float32).contiguous(),
            table.contiguous())
    out = _bag.embedding_bag_cuda(*args, **kwargs)
    _launched("embedding_bag", args, kwargs)
    return out


def embedding_bag_backward(ids, mask, grad_out, vocab: int, *,
                           row_dtype=torch.float32):
    """The gradient ``f32[vocab, D]`` of :func:`embedding_bag` with respect
    to its table, for ``grad_out [R, D]`` (see ``kernels/embedding_bag.py``:
    each run of equal ids summed in slot order, no atomics)."""
    kwargs = dict(vocab=int(vocab), row_dtype=row_dtype)
    route = _route("embedding_bag_backward", grad_out)
    if route == "cpu":
        return _bag.embedding_bag_backward_plain(ids, mask, grad_out,
                                                 **kwargs)
    if route == "meta":   # never reaches the plain version's host read
        return _charged((ids, mask, grad_out),
                        ((int(vocab), grad_out.shape[1]), torch.float32))
    args = (ids.contiguous(),
            None if mask is None else mask.to(torch.float32).contiguous(),
            grad_out.contiguous())
    out = _bag.embedding_bag_backward_cuda(*args, **kwargs)
    _launched("embedding_bag_backward", args, kwargs)
    return out


class _EmbeddingBag(torch.autograd.Function):
    """:func:`embedding_bag` with the table's gradient: the forward kernel
    (or plain version) forward, :func:`embedding_bag_backward` backward.
    ``ids`` and ``mask`` are data and get no gradient."""

    @staticmethod
    def forward(ctx, table, ids, mask, row_dtype, out_dtype):
        ctx.save_for_backward(ids, mask)
        ctx.vocab = table.shape[0]
        ctx.row_dtype = row_dtype
        return _embedding_bag_forward(ids, mask, table, row_dtype, out_dtype)

    @staticmethod
    def backward(ctx, grad_out):
        ids, mask = ctx.saved_tensors
        grad = embedding_bag_backward(ids, mask, grad_out, ctx.vocab,
                                      row_dtype=ctx.row_dtype)
        return grad, None, None, None, None


def embedding_bag(ids, mask, table, *, row_dtype=torch.float32,
                  out_dtype=torch.float32):
    """Bag sum ``out[r] = sum_i mask[r, i] * table[ids[r, i]]`` of ``ids
    int[R, bag]``, ``mask f32[R, bag]`` (``None``: every weight one) over
    ``table f32[V, D]``, each gathered row rounded to ``row_dtype`` and the
    f32 sum cast to ``out_dtype`` (see ``kernels/embedding_bag.py``); needs
    no tile alignment.  Where grad mode is on and ``table`` needs a
    gradient, the call goes through a ``torch.autograd.Function`` whose
    backward is :func:`embedding_bag_backward`."""
    if ids.shape[1] == 0:  # empty bags sum to zero
        return torch.zeros((ids.shape[0], table.shape[1]), dtype=out_dtype,
                           device=table.device)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingBag.apply(table, ids, mask, row_dtype, out_dtype)
    return _embedding_bag_forward(ids, mask, table, row_dtype, out_dtype)
