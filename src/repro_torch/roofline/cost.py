"""Cost of one step counted op by op: the port's ``hlo_parse.analyze``.

The reference reads a compiled XLA program.  The port has none, so it runs
the step once on the ``meta`` device under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every aten op the step dispatches (the
backward's too) and charges it by the reference's traffic rules:

* FLOPs: a matmul-family op (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and
  what ``einsum``/``linear`` decompose to) is ``2 * out elements *
  contracted size``, as ``_dot_flops`` counts a ``dot``; kept apart by
  whether its operands are bf16/f16 (the tensor cores) or not, because the
  card has two peaks.  Elementwise arithmetic and reductions are one flop
  an output element; anything else none.
* HBM bytes: views, metadata and ``empty``-family ops are free; a gather
  (``index_select``, ``gather``, ``embedding``, advanced indexing) is two
  times its output bytes; a scatter (``index_put_``, ``index_add_``,
  ``scatter_add_``, ...) two times its update bytes; every other op reads
  its operands and writes its outputs once.  Only tensors on the device
  are charged: host tensors (the walk step's key words) move no HBM.
* Collectives: :func:`charge_collective`, called by the mesh's
  collectives, adds their bytes to their kind and again to the HBM bytes,
  as ``analyze`` does; the mesh's own tensor ops are :func:`uncharged`.
* A kernel wrapper's meta branch charges its operands and outputs once and
  no FLOPs (:func:`charge_custom`), the reference's rule for a custom call.

Python loops run on meta, so a loop body is charged as often as it runs:
no trip count is parsed.  Peak memory comes from the live bytes of the
storages the step creates, each counted once and freed when its last
reference goes (a ``weakref.finalize`` on the storage).  Storages
registered with :meth:`CostCounter.arguments` are the step's arguments; an
output whose storage is an argument's is aliased (a train step's
parameters and moments, a decode cache: updated in place).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "vdot"}
# the reference's _ARITH_OPS in aten's spellings, and the fused
# elementwise ops XLA would spell as a few of them
_ARITH = {
    "add", "sub", "rsub", "mul", "div", "pow", "exp", "exp2", "log", "log2",
    "tanh", "rsqrt", "sqrt", "maximum", "minimum", "eq", "ne", "lt", "le",
    "gt", "ge", "where", "neg", "abs", "floor", "ceil", "sign", "cos", "sin",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not", "expm1",
    "log1p", "sigmoid", "silu", "relu", "gelu", "reciprocal", "clamp",
    "clamp_min", "clamp_max", "square", "fmod", "remainder", "addcmul",
    "addcdiv", "lerp", "masked_fill", "silu_backward", "sigmoid_backward",
    "threshold_backward", "tanh_backward", "gelu_backward", "trunc",
    "round", "isnan", "isinf", "nan_to_num", "floor_divide",
}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "any", "all", "logsumexp", "var", "std", "norm", "linalg_vector_norm",
    "cumsum", "cumprod", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data",
}
_FREE = {
    "empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like",
    "detach", "alias", "lift_fresh", "_unsafe_view", "view", "_reshape_alias",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "set_", "resize_", "_local_scalar_dense",
    "_has_compatible_shallow_copy_type", "unsqueeze_", "squeeze_", "t_",
    "transpose_", "as_strided_", "record_stream",
}
_GATHER = {"index_select", "gather", "embedding", "index", "take"}
# scatter op -> (positional index, keyword) of its update operand
_SCATTER = {
    "index_put": (2, "values"), "_index_put_impl": (2, "values"),
    "index_add": (3, "source"), "index_copy": (3, "source"),
    "scatter_add": (3, "src"), "scatter": (3, "src"),
    "scatter_reduce": (3, "src"), "masked_scatter": (2, "source"),
    "embedding_dense_backward": (0, "grad_output"),
}
# in-place ops that overwrite ``self`` without reading it
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
              "bernoulli_", "exponential_"}

_STACK: List["CostCounter"] = []


def active() -> Optional["CostCounter"]:
    """The innermost active :class:`CostCounter`, or ``None``."""
    return _STACK[-1] if _STACK else None


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on_device(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type != "cpu"


def _device_tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if _on_device(t)]


def _step_tensors(tree) -> List[torch.Tensor]:
    """The device tensors of a step's arguments or outputs: dicts, lists,
    tuples (NamedTuples too) and dataclasses (``ShardedGraph``) walked."""
    if isinstance(tree, torch.Tensor):
        return [tree] if _on_device(tree) else []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _step_tensors(x)]
    return []


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        key = id(t)
        if key not in seen:
            seen.add(key)
            total += tensor_bytes(t)
    return total


@dataclasses.dataclass
class Cost:
    """Totals of one traced step (see :meth:`per_device`)."""

    flops_tensor_core: float
    flops_other: float
    hbm_bytes: float
    collective_breakdown: Dict[str, float]
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    n_ops: int
    replicated_bytes: int = 0   # the arguments every shard holds whole
    dot_flops: float = 0.0      # the matmul family's part of the FLOPs

    @property
    def flops(self) -> float:
        return self.flops_tensor_core + self.flops_other

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collective_breakdown.values()))

    def memory(self) -> Dict[str, int]:
        """The reference's ``memory_analysis`` keys."""
        return dict(argument_bytes=self.argument_bytes,
                    output_bytes=self.output_bytes,
                    temp_bytes=self.temp_bytes,
                    alias_bytes=self.alias_bytes)

    def per_device(self, n: int) -> "Cost":
        """The per-device cost of a step whose ``n`` shards are stacked on
        one device and run the same shapes (``distributed/mesh.py``):
        every figure divided by ``n``, but the replicated arguments, which
        each device holds whole."""
        if n == 1:
            return self
        d = lambda x: x / n  # noqa: E731
        i = lambda x: -(-x // n)  # noqa: E731  (bytes round up)
        rep = self.replicated_bytes
        return Cost(
            d(self.flops_tensor_core), d(self.flops_other),
            d(self.hbm_bytes),
            {k: d(v) for k, v in self.collective_breakdown.items()},
            rep + i(self.argument_bytes - rep), i(self.output_bytes),
            i(self.temp_bytes), i(self.alias_bytes), self.n_ops, rep,
            d(self.dot_flops))


class CostCounter(TorchDispatchMode):
    """Charges every aten op dispatched inside it (see the module's rules)
    and tracks the live bytes of the storages the ops create."""

    def __init__(self):
        super().__init__()
        self.flops_tc = 0.0
        self.flops_other = 0.0
        self.flops_dot = 0.0
        self.hbm = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.n_ops = 0
        self._quiet = 0
        self._args: Dict[int, int] = {}
        self._replicated = 0
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._peak = 0
        self._keep: List[Any] = []

    # -- the mode ---------------------------------------------------------

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        if not self._quiet:
            self._charge(func, args, kwargs, out)
        if not func.is_view:
            self._track(out, args, kwargs)
        return out

    def _charge(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        base = name.rstrip("_")
        if func.is_view or name in _FREE or base in _FREE:
            return
        outs = _device_tensors(out)
        ins = _device_tensors((args, kwargs))
        if not outs and not ins:
            return                       # host work: no HBM, no FLOPs
        out_b = _unique_bytes(outs)
        if base in _MATMUL:
            a = args[1] if base in ("addmm", "baddbmm", "addbmm",
                                    "addmv") else args[0]
            k = a.numel() if base in ("dot", "vdot") else a.shape[-1]
            flops = 2.0 * sum(t.numel() for t in outs) * k
            self.flops_dot += flops
            if a.dtype in (torch.bfloat16, torch.float16):
                self.flops_tc += flops
            else:
                self.flops_other += flops
        elif base in _ARITH or base in _REDUCE:
            self.flops_other += float(sum(t.numel() for t in outs))
        if base in _GATHER:
            self.hbm += 2.0 * out_b
            return
        if base in _SCATTER:
            pos, key = _SCATTER[base]
            upd = kwargs.get(key, args[pos] if len(args) > pos else None)
            if isinstance(upd, torch.Tensor):
                self.hbm += 2.0 * tensor_bytes(upd)
            else:                        # a scalar spread over the index
                self.hbm += 2.0 * args[2].numel() * outs[0].element_size()
            return
        if name in _OVERWRITE and args and isinstance(args[0], torch.Tensor):
            ins = [t for t in ins if t is not args[0]]
        self.hbm += float(out_b + _unique_bytes(ins))

    def _track(self, out, args, kwargs):
        """Registers the storages ``out`` holds that no operand holds: the
        op's new allocations (an in-place op's output is its operand's)."""
        old = None
        for t in tree_leaves(out):
            if not _on_device(t):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._args:
                continue
            if old is None:
                old = {x.untyped_storage()._cdata
                       for x in _device_tensors((args, kwargs))}
            if key in old:
                continue
            nb = st.nbytes()
            self._live[key] = nb
            self._live_bytes += nb
            self._peak = max(self._peak, self._live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self._live_bytes -= self._live.pop(key, 0)

    # -- charges from outside the dispatcher ------------------------------

    def charge_custom(self, inputs, outputs) -> None:
        """A hand-written kernel's call (its wrapper's meta branch): its
        operands and outputs once, no FLOPs."""
        if not self._quiet:
            self.hbm += float(_unique_bytes(_device_tensors(inputs))
                              + _unique_bytes(_device_tensors(outputs)))

    def charge_collective(self, kind: str, nbytes: float) -> None:
        if kind not in self.coll:
            raise ValueError(f"unknown collective {kind!r}")
        self.coll[kind] += float(nbytes)
        self.hbm += float(nbytes)

    # -- memory -----------------------------------------------------------

    def arguments(self, tree, *, replicated: bool = False) -> int:
        """Registers the storages of ``tree``'s tensors as the step's
        arguments (each once; ``replicated``: held whole by every shard of
        a stacked step); returns their bytes."""
        total = 0
        for t in _step_tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._args:
                self._args[key] = st.nbytes()
                total += st.nbytes()
                self._keep.append(st)     # an argument outlives the step
        if replicated:
            self._replicated += total
        return total

    def result(self, outputs) -> Cost:
        """The step's :class:`Cost`, with ``outputs`` (its return value)
        read for the output and alias bytes."""
        new, alias, seen = 0, 0, set()
        for t in _step_tensors(outputs):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen:
                continue
            seen.add(key)
            if key in self._args:
                alias += st.nbytes()
            else:
                new += st.nbytes()
        return Cost(
            flops_tensor_core=self.flops_tc, flops_other=self.flops_other,
            hbm_bytes=self.hbm, collective_breakdown=dict(self.coll),
            argument_bytes=sum(self._args.values()),
            output_bytes=new + alias, temp_bytes=max(self._peak - new, 0),
            alias_bytes=alias, n_ops=self.n_ops,
            replicated_bytes=self._replicated, dot_flops=self.flops_dot)


@contextlib.contextmanager
def uncharged() -> Iterator[None]:
    """Ops inside charge nothing to the active counter (their storages are
    still tracked): a collective's stacked tensor op, charged instead by
    :func:`charge_collective`."""
    c = active()
    if c is None:
        yield
        return
    c._quiet += 1
    try:
        yield
    finally:
        c._quiet -= 1


def charge_collective(kind: str, nbytes: float) -> None:
    """Adds ``nbytes`` of collective ``kind`` to the active counter, if
    any (and to its HBM bytes)."""
    c = active()
    if c is not None:
        c.charge_collective(kind, nbytes)


def charge_custom(inputs, outputs) -> None:
    c = active()
    if c is not None:
        c.charge_custom(inputs, outputs)
