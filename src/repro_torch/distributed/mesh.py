"""``(data, model)`` meshes: shards stacked on one device, or one a rank.

:class:`ShardMesh` is the port's counterpart of
``repro.launch.mesh.make_debug_mesh`` together with
``repro.compat.shard_map``: a per-shard array is one tensor with a leading
stacked shard axis, the engine runs each shard's body in a loop over that
axis, and each collective it uses is one tensor op on the axis.
:class:`RankMesh` is the same mesh over a ``torch.distributed`` process
group, one shard a process, ranks in row-major ``(data, model)`` order as
``jax.make_mesh`` lays out devices.  Both name the shards a process holds
(``local_data``, ``local_model``: every shard on a ``ShardMesh``, one of
each on a rank), and each collective takes the local stack of the shards
it joins (a leading axis, of length 1 on a rank), names the mesh axes it
joins, as the reference's ``jax.lax.psum(x, "model")`` does, and returns
what the stacked mesh returns for those shards.

Under a ``roofline.cost.CostCounter`` each collective charges its wire
bytes under the reference's kind (``all-to-all``, ``all-reduce``,
``all-gather``), summed over the ``S`` stacked shards it joins, in place of
its tensor op: each shard receives its output block of an ``all_to_all``
and the whole output of a ``psum`` or a tiled ``all_gather``.  Every shard
of a stacked mesh runs the same shapes, so a per-device figure of a
stacked step is its total divided by the shards the step stacks: the mesh
size where every ``(data, model)`` shard runs (the walk counts), the
``model`` size where the data replicas repeat one tile (the VERD tile,
whose sources every replica shares, as the reference's replicated ``P()``
input).

A ``data x model`` layout of per-shard blocks is ``[data, model, ...]``
(``distributed.sharding.shard`` makes it); the per-axis collectives
(``psum_axis``, ``pmean_axis``, ``all_gather_axis``) join the shards along
one mesh axis of it, each group of the other axis apart, as the
reference's collectives named by one axis inside a ``shard_map`` do, and
charge what every one of the ``data * model`` shards receives.

Both meshes also carry what the expert-parallel MoE needs to train
(``models/transformer.py``'s ``_moe_ffn_shardmap``): ``split_axis`` (a
shard's block of a tensor the group holds whole), ``concat_axis`` (the
group's blocks joined into the whole every shard then uses), ``from_first``
(the group's first shard's block) and ``pvary`` (a tensor the group holds
whole, used by each shard in a computation of its own).  On a stacked mesh
each is a view or the identity and autograd sums what the stacked uses
give; on a :class:`RankMesh` each collective is a
``torch.autograd.Function`` whose backward is what the stacked autograd
computes for the rank's shard (see :class:`RankMesh`).

The dense layers' tensor parallelism (``models/transformer.py``'s 2-D
layout) takes three more, each over a list with one entry a local shard
of the group: ``fan_out`` (a value the group holds alike, once for each
local shard, whose cotangents are summed in shard order), ``fan_in`` (the
shards' partial values summed in shard order, the sum every shard goes on
with alike) and ``pmax`` (the elementwise largest, a constant to
autograd).  On a stacked mesh ``fan_out`` is one ``expand`` (its backward
a sum over the stacked axis) and ``fan_in`` a sum over a stack: the same
tensor op on the same shape as a rank's sum of the gathered blocks, so
both meshes give the same bits.

:class:`MetaRankMesh` is one rank of a :class:`RankMesh` alone on
``meta``: the dry-run's stand-in, whose collectives give their results'
shapes and charge their bytes, so a rank's step is traced with the
blocks it holds.

Two collectives move data that is not one block a shard: ``broadcast``
sends one shard's tensor to its group (the rank service's leader to its
followers), ``gather_blocks`` collects blocks of different lengths (each
model shard's rows of a PPR index) on one shard or on all of them.  On a
stacked mesh both are the identity: one process already holds every
shard's tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.roofline import cost


AXES = ("data", "model")
Axes = Union[str, Sequence[str]]


def mesh_axes(axes: Axes) -> Tuple[str, ...]:
    """``axes`` (a name or names) in mesh order: ``("data", "model")``."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if not names or set(names) - set(AXES):
        raise ValueError(f"mesh axes are {AXES}, got {axes!r}")
    return tuple(a for a in AXES if a in names)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``data x model`` shards on ``device`` (default ``"cuda"``; ``"meta"``
    for a dry-run, which computes nothing)."""

    data: int = 1
    model: int = 1
    device: Any = "cuda"

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got data={self.data} "
                f"model={self.model}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def local_data(self) -> range:
        """The data shards this process holds: every one."""
        return range(self.data)

    @property
    def local_model(self) -> range:
        """The model shards this process holds: every one."""
        return range(self.model)

    def _stack(self, x: torch.Tensor, axes: Optional[Axes]) -> None:
        if axes is None:    # the leading axis as given
            return
        want = math.prod(self.shape[a] for a in mesh_axes(axes))
        if x.shape[0] != want:
            raise ValueError(f"a collective over {axes!r} of a {self.data} x "
                             f"{self.model} mesh joins {want} shards, got a "
                             f"stack of {x.shape[0]}")

    def all_to_all(self, x: torch.Tensor,
                   axes: Optional[Axes] = None) -> torch.Tensor:
        """``all_to_all(split_axis=1, concat_axis=1, tiled=False)`` of
        per-shard ``[Q, S, ...]`` blocks stacked as ``[S, Q, S, ...]``:
        shard ``r`` receives from shard ``s`` the block ``s`` addressed to
        ``r``, i.e. ``out[r, :, s] = x[s, :, r]``."""
        self._stack(x, axes)
        with cost.uncharged():
            out = x.transpose(0, 2).contiguous()
        cost.charge_collective("all-to-all", cost.tensor_bytes(out))
        return out

    def psum(self, x: torch.Tensor,
             axes: Optional[Axes] = None) -> torch.Tensor:
        """Sum of the stacked per-shard values ``[S, ...]``."""
        self._stack(x, axes)
        with cost.uncharged():
            out = x.sum(dim=0)
        cost.charge_collective("all-reduce",
                               x.shape[0] * cost.tensor_bytes(out))
        return out

    def all_gather(self, x: torch.Tensor,
                   axes: Optional[Axes] = None) -> torch.Tensor:
        """``all_gather(axis=1, tiled=True)`` of per-shard ``[Q, k]``
        stacked as ``[S, Q, k]``: ``[Q, S * k]`` in shard order."""
        self._stack(x, axes)
        with cost.uncharged():
            out = x.transpose(0, 1).reshape(x.shape[1], -1)
        cost.charge_collective("all-gather",
                               x.shape[0] * cost.tensor_bytes(out))
        return out

    _AXIS = {"data": 0, "model": 1}

    def _axis(self, x: torch.Tensor, axis: str) -> int:
        if tuple(x.shape[:2]) != (self.data, self.model):
            raise ValueError(f"expected [data, model, ...] blocks of a "
                             f"{self.data} x {self.model} mesh, got "
                             f"{tuple(x.shape)}")
        return self._AXIS[axis]

    def psum_axis(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``psum`` over ``axis`` of ``[data, model, ...]`` blocks: every
        shard of a group holds the group's sum (the sum in shard order)."""
        ax = self._axis(x, axis)
        with cost.uncharged():
            out = x.sum(dim=ax, keepdim=True).expand_as(x)
        cost.charge_collective("all-reduce", cost.tensor_bytes(x))
        return out

    def pmean_axis(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``pmean`` over ``axis``: ``psum_axis`` over the axis's size."""
        return self.psum_axis(x, axis) / self.shape[axis]

    def all_gather_axis(self, x: torch.Tensor, axis: str,
                        dim: int) -> torch.Tensor:
        """``all_gather(axis_name=axis, axis=dim, tiled=True)`` of
        ``[data, model, *block]`` blocks: every shard of a group holds the
        group's blocks concatenated along block dimension ``dim`` in shard
        order (one copy a group, shared by its shards' views)."""
        ax = self._axis(x, axis)
        with cost.uncharged():
            whole = torch.cat(x.unbind(ax), dim=1 + dim).unsqueeze(ax)
            out = whole.expand(self.data, self.model, *whole.shape[2:])
        cost.charge_collective("all-gather", cost.tensor_bytes(out))
        return out

    def split_axis(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The ``axis`` group's blocks of ``x`` (the whole, its
        dimension ``dim`` a multiple of the group's size) along ``dim``,
        stacked on a new leading axis in shard order: a view."""
        return x.unflatten(dim, (self.shape[axis], -1)).movedim(dim, 0)

    def concat_axis(self, x: torch.Tensor, axis: str,
                    dim: int = 0) -> torch.Tensor:
        """The group's blocks ``[size, *block]`` joined along block
        dimension ``dim`` in shard order: the inverse of ``split_axis``."""
        return x.movedim(0, dim).flatten(dim, dim + 1)

    def from_first(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The first shard's block of the group's stack ``[size, ...]``."""
        return x[0]

    def pvary(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` as it is: each stacked use of it is one shard's, and
        autograd sums their cotangents."""
        return x

    def fan_out(self, x: torch.Tensor, axis: str) -> list:
        """``x``, which the ``axis`` group holds alike, once for each of
        its shards, each used in a computation of its own: views of one
        ``expand`` over a new leading axis, whose backward sums the
        shards' cotangents over that axis (in shard order)."""
        return list(x.unsqueeze(0).expand(
            self.shape[axis], *x.shape).unbind(0))

    def fan_in(self, parts: Sequence[torch.Tensor],
               axis: str) -> torch.Tensor:
        """The ``axis`` group's partial values, one a shard in shard
        order, summed over their stack; every shard goes on with the sum
        alike, so each part's cotangent is the sum's."""
        x = torch.stack(list(parts))
        self._stack(x, axis)
        with cost.uncharged():
            out = x.sum(dim=0)
        cost.charge_collective("all-reduce",
                               x.shape[0] * cost.tensor_bytes(out))
        return out

    def pmax(self, parts: Sequence[torch.Tensor],
             axis: str) -> torch.Tensor:
        """The elementwise largest of the group's values, a constant to
        autograd (the shift of a ``logsumexp``)."""
        x = torch.stack([p.detach() for p in parts])
        self._stack(x, axis)
        with cost.uncharged():
            out = x.amax(dim=0)
        cost.charge_collective("all-reduce",
                               x.shape[0] * cost.tensor_bytes(out))
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0,
                  axes: Axes = "model") -> torch.Tensor:
        """Shard ``src``'s tensor on every shard of the group: ``x``, which
        this process holds for all of them."""
        return x

    def gather_blocks(self, x: torch.Tensor, axes: Axes = "model",
                      dst: Optional[int] = 0) -> Sequence[torch.Tensor]:
        """``RankMesh.gather_blocks``'s call shape: ``[x]``, the one block
        of the one process that holds every shard."""
        return [x]


def fail_together(mesh, err: Optional[BaseException], what: str,
                  axes: Axes = "model") -> None:
    """A vote of the group's shards on a step each ran on its own: raise
    ``err`` where it was raised, ``RuntimeError`` on the shards that
    succeeded if any failed, or return, so no shard goes on to a
    collective its failed peers never reach."""
    flags = mesh.gather_blocks(torch.tensor(
        [int(err is not None)], dtype=torch.int64, device=mesh.device),
        axes, dst=None)
    bad = [i for i, f in enumerate(flags) if int(f[0])]
    if err is not None:
        raise err
    if bad:
        raise RuntimeError(f"{what} failed on shard(s) {bad} of the group "
                           f"over {'+'.join(mesh_axes(axes))}")


# dtypes a broadcast header can name, by their index here
_DTYPES = (torch.float32, torch.int32, torch.int64, torch.bool,
           torch.float64, torch.bfloat16, torch.float16, torch.uint8,
           torch.int16, torch.int8)
_MAX_DIMS = 6


def _group(members: Tuple[int, ...], timeout: Optional[datetime.timedelta]):
    """The process group of ``members`` (global ranks, ascending): the
    default group when they are all of it (even one rank: its collectives
    still go through the backend), none for one rank of several (its
    collectives are the identity), else a new group made by the members
    alone (``use_local_synchronization``)."""
    if len(members) == dist.get_world_size():
        return dist.group.WORLD
    if len(members) == 1:
        return None
    return dist.new_group(list(members), timeout=timeout,
                          use_local_synchronization=True)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, one row a leading index: the wire format of every
    rank collective, so any dtype (bool, bf16) crosses any backend."""
    t = t.contiguous()
    return t.reshape(t.shape[0], math.prod(t.shape[1:])).view(torch.uint8)


def _block_of(x: torch.Tensor, dim: int, size: int,
              index: int) -> torch.Tensor:
    """Block ``index`` of ``size`` equal blocks of ``x`` along ``dim``."""
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


class _PsumAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axis):
        return mesh._gather(mesh._block(x), axis).sum(dim=0)[None, None]

    @staticmethod
    def backward(ctx, g):
        return None, g, None


class _AllGatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        parts = mesh._gather(mesh._block(x), axis)      # [S, *block]
        return torch.cat(parts.unbind(0), dim=dim)[None, None]

    @staticmethod
    def backward(ctx, g):
        mine = _reduce_scatter(ctx.mesh, g[0, 0], ctx.axis, ctx.dim)
        return None, mine[None, None], None, None


def _reduce_scatter(mesh, whole: torch.Tensor, axis: str, dim: int, *,
                    by_slice: bool = True) -> torch.Tensor:
    """This shard's block along ``dim`` of the group's ``whole`` tensors
    summed (in shard order): each shard's block sent to its owner
    (``all_to_all``).  Where ``whole`` is a stack of blocks (three or more
    axes) and ``dim`` is not its leading axis, one leading index at a time,
    so the send buffer is one slice's (an expert's, of a layer's gathered
    stack) and not a copy of the whole; a matrix goes in one exchange."""
    if by_slice and dim > 0 and whole.dim() > 2 and whole.shape[0] > 1:
        return torch.stack([_reduce_scatter(mesh, w, axis, dim - 1,
                                            by_slice=False)
                            for w in whole.unbind(0)])
    size = mesh.shape[axis]
    # [1, 1, S, *block]: the block each shard of the group owns
    sent = whole.unflatten(dim, (size, -1)).movedim(dim, 0)
    got = mesh.all_to_all(sent[None, None].contiguous(), axis)
    return got[0, 0].sum(dim=0)


class _SplitAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block_of(x, dim, mesh.shape[axis],
                         mesh._index(axis))[None].contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        parts = mesh._gather(g.contiguous(), axis)       # [S, *block]
        return None, torch.cat(parts.unbind(0), dim=dim), None, None


class _ConcatAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        parts = mesh._gather(x.contiguous(), axis)       # [S, *block]
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        mine = _block_of(g, dim, mesh.shape[axis], mesh._index(axis))
        return None, mine[None].contiguous(), None, None


class _FromFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axis):
        ctx.first = mesh._index(axis) == 0
        return x[0].clone()

    @staticmethod
    def backward(ctx, g):
        return None, (g if ctx.first else torch.zeros_like(g))[None], None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.mesh._sum(g.contiguous(), ctx.axis), None


class _FanIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x, axis):
        return mesh._gather(x[None], axis).sum(dim=0)

    @staticmethod
    def backward(ctx, g):
        return None, g, None


class RankMesh:
    """``data x model`` shards, one a rank of a ``torch.distributed``
    process group (the port's ``shard_map`` over real devices).

    ``ranks`` are the mesh's global ranks in row-major ``(data, model)``
    order, ascending (default: the whole default group); every one of them
    constructs the mesh, which joins the process groups of its own data
    row, model column and the whole mesh.  ``make_rank_mesh`` in
    ``launch/mesh.py`` joins the default group and makes the mesh.

    Each collective takes the local stack of the shards it joins (a
    leading axis of length 1), and returns what :class:`ShardMesh` returns
    for this shard.  A reduction gathers the group's blocks in shard order
    and reduces them on ``device`` with the tensor op the stacked mesh
    applies, never the backend's own all-reduce, whose order is its own:
    so the same inputs on the same device type give the stacked mesh's
    bits.  Every collective moves bytes (``uint8`` views), so any dtype
    crosses.  Over ``gloo`` a CUDA tensor's collective is staged through
    host memory (a copy to the CPU, the collective, a copy back): that is
    how ranks that share one card run, and gloo's CUDA support varies by
    collective.  ``meta`` is refused (the dry-run keeps ``ShardMesh``).

    The per-axis collectives and ``split_axis``, ``concat_axis``,
    ``from_first`` and ``pvary`` are differentiable.  Each backward is what
    the stacked mesh's autograd gives this shard where every shard goes on
    with a replicated result identically (the dense layers of a model that
    every rank runs whole), so that cotangent counts once, and where each
    shard uses a gathered or replicated input in a computation of its own,
    so the group's cotangents are summed:

    * ``psum_axis``: the sum is replicated, so each block's cotangent is
      the one cotangent, handed on as it is (a psum of it would count it
      once a shard); ``pmean_axis`` divides it by the group's size;
    * ``all_gather_axis``: the group's cotangents summed, this shard's
      block of the sum (a reduce-scatter, through ``all_to_all``);
    * ``split_axis``: the blocks' cotangents gathered into the whole's;
      ``concat_axis``: this shard's block of the whole's cotangent;
      ``from_first``: the cotangent on the group's first shard, zeros on
      the others;
    * ``pvary`` and ``fan_out``: the group's cotangents summed (the
      transpose of ``jax.lax.pvary``);
    * ``fan_in``: the sum is replicated, so each part's cotangent is the
      one cotangent, as ``psum_axis``'s; ``pmax`` has none.

    Every sum in a backward is a forward reduction's: the blocks gathered
    as bytes and summed in shard order.
    """

    def __init__(self, data: int, model: int, device: Any = "cuda", *,
                 ranks: Optional[Sequence[int]] = None,
                 timeout_s: Optional[float] = None):
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={data} "
                             f"model={model}")
        if torch.device(device).type == "meta":
            raise ValueError("a RankMesh computes on its rank's device; the "
                             "meta dry-run runs on a ShardMesh")
        dev = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("RankMesh needs a joined process group "
                               "(repro_torch.launch.mesh.make_rank_mesh)")
        ranks = tuple(range(dist.get_world_size()) if ranks is None
                      else (int(r) for r in ranks))
        if len(ranks) != data * model:
            raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                             f"ranks, the group has {len(ranks)}")
        if list(ranks) != sorted(set(ranks)):
            raise ValueError(f"mesh ranks must be distinct and ascending "
                             f"(row-major (data, model) order): {ranks}")
        me = dist.get_rank()
        if me not in ranks:
            raise ValueError(f"rank {me} is not one of the mesh's {ranks}")
        self.data, self.model, self.device, self.ranks = (
            data, model, dev, ranks)
        self.backend = dist.get_backend()
        self._stage = self.backend == "gloo" and dev.type == "cuda"
        d0, m0 = divmod(ranks.index(me), model)
        self.local_data = range(d0, d0 + 1)
        self.local_model = range(m0, m0 + 1)
        timeout = (None if timeout_s is None
                   else datetime.timedelta(seconds=timeout_s))
        self._groups = {}
        self._members = {}
        for axes in (("model",), ("data",), AXES):
            members = tuple(
                ranks[d * model + m]
                for d in (range(data) if "data" in axes else (d0,))
                for m in (range(model) if "model" in axes else (m0,)))
            self._groups[axes] = (len(members), _group(members, timeout))
            self._members[axes] = members

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return (f"RankMesh(data={self.data}, model={self.model}, "
                f"device={self.device}, shard=({self.local_data[0]}, "
                f"{self.local_model[0]}), backend={self.backend})")

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._stage else t

    def _gather(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """The group's blocks ``[S, *x.shape[1:]]`` in shard order, from
        this rank's stack of one."""
        if x.shape[0] != 1:
            raise ValueError(f"a rank holds one shard of the collective: "
                             f"expected a stack of 1, got {tuple(x.shape)}")
        size, group = self._groups[mesh_axes(axes)]
        if group is None:
            return x
        send = self._host(_as_bytes(x))
        parts = [torch.empty_like(send) for _ in range(size)]
        self._all_gather(parts, send, group)
        out = torch.cat(parts).to(self.device)
        return out.view(x.dtype).reshape(size, *x.shape[1:])

    def _all_gather(self, parts, send, group) -> None:
        dist.all_gather(parts, send, group=group)

    def _all_to_all(self, recv, send, group) -> None:
        dist.all_to_all_single(recv, send, group=group)

    def all_to_all(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``ShardMesh.all_to_all`` for this shard: ``x`` is ``[1, Q, S,
        ...]`` (the blocks it sends, by destination), the result ``[1, Q,
        S, ...]`` (the blocks addressed to it, by source)."""
        size, group = self._groups[mesh_axes(axes)]
        if x.shape[0] != 1 or x.shape[2] != size:
            raise ValueError(f"expected [1, Q, {size}, ...] blocks, got "
                             f"{tuple(x.shape)}")
        if group is None:
            return x.contiguous()
        blocks = x[0].transpose(0, 1).contiguous()      # [S (to), Q, ...]
        send = self._host(_as_bytes(blocks))
        recv = torch.empty_like(send)
        self._all_to_all(recv, send, group)
        recv = recv.to(self.device).view(x.dtype).reshape(blocks.shape)
        return recv.transpose(0, 1).unsqueeze(0).contiguous()

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """The group's sum, in shard order on this rank's device."""
        return self._gather(x, axes).sum(dim=0)

    def all_gather(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``[1, Q, k]`` -> ``[Q, S * k]`` in shard order."""
        parts = self._gather(x, axes)
        return parts.transpose(0, 1).reshape(x.shape[1], -1)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[:2]) != (1, 1):
            raise ValueError(f"expected a rank's [1, 1, ...] block, got "
                             f"{tuple(x.shape)}")
        return x[0]

    def psum_axis(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``ShardMesh.psum_axis`` for this shard's ``[1, 1, ...]``."""
        return _PsumAxis.apply(self, x, axis)

    def pmean_axis(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return self.psum_axis(x, axis) / self.shape[axis]

    def all_gather_axis(self, x: torch.Tensor, axis: str,
                        dim: int) -> torch.Tensor:
        """``ShardMesh.all_gather_axis`` for this shard's ``[1, 1,
        *block]``: the group's blocks along block dimension ``dim``."""
        return _AllGatherAxis.apply(self, x, axis, dim)

    def split_axis(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """This shard's block of ``x`` along ``dim`` as a stack of one
        ``[1, *block]`` (``ShardMesh.split_axis`` for this shard)."""
        return _SplitAxis.apply(self, x, axis, dim)

    def concat_axis(self, x: torch.Tensor, axis: str,
                    dim: int = 0) -> torch.Tensor:
        """The group's blocks joined along ``dim`` from this shard's stack
        of one ``[1, *block]``."""
        return _ConcatAxis.apply(self, x, axis, dim)

    def from_first(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """This shard's block of its stack of one, taken for the group's
        first shard's: the caller's blocks are the same on every shard of
        the group (computed from the same inputs)."""
        return _FromFirst.apply(self, x, axis)

    def pvary(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` as it is; its backward sums the group's cotangents."""
        return _Pvary.apply(self, x, axis)

    def fan_out(self, x: torch.Tensor, axis: str) -> list:
        """``ShardMesh.fan_out`` for this shard: ``[x]``, whose backward
        sums the group's cotangents in shard order."""
        return [_Pvary.apply(self, x, axis)]

    def fan_in(self, parts: Sequence[torch.Tensor],
               axis: str) -> torch.Tensor:
        """``ShardMesh.fan_in`` for this shard's one part: the group's
        parts gathered and summed in shard order."""
        (x,) = parts
        return _FanIn.apply(self, x, axis)

    def pmax(self, parts: Sequence[torch.Tensor],
             axis: str) -> torch.Tensor:
        """``ShardMesh.pmax`` for this shard's one part."""
        (x,) = parts
        return self._gather(x.detach()[None], axis).amax(dim=0)

    def _sum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """The group's ``x`` (any shape) summed in shard order."""
        return self._gather(x[None], axes).sum(dim=0)

    def _index(self, axis: str) -> int:
        return (self.local_data if axis == "data" else self.local_model)[0]

    def broadcast(self, x: Optional[torch.Tensor], src: int = 0,
                  axes: Axes = "model") -> torch.Tensor:
        """Shard ``src`` of the group (its place in shard order) sends
        ``x`` to every shard of it; the others pass ``None`` and receive
        it.  Any dtype of ``_DTYPES`` and up to six dimensions: a header
        of the dtype and the shape goes first, then the bytes (none for
        an empty tensor)."""
        axes = mesh_axes(axes)
        size, group = self._groups[axes]
        members = self._members[axes]
        if not 0 <= src < size:
            raise ValueError(f"src {src} is not a shard of the {size} over "
                             f"{axes}")
        sender = members[src] == dist.get_rank()
        if sender and x is None:
            raise ValueError("the broadcast's source shard must pass a "
                             "tensor")
        if group is None:
            return x
        head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
        if sender:
            if x.dim() > _MAX_DIMS or x.dtype not in _DTYPES:
                raise ValueError(f"cannot broadcast a {x.dtype} tensor of "
                                 f"{x.dim()} dimensions")
            head[0], head[1] = _DTYPES.index(x.dtype), x.dim()
            head[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
        wire = self._host(head.to(self.device))
        dist.broadcast(wire, src=members[src], group=group)
        head = wire.cpu()
        dtype = _DTYPES[int(head[0])]
        shape = [int(d) for d in head[2:2 + int(head[1])]]
        if sender:
            send = x.contiguous().reshape(-1).view(torch.uint8)
        else:
            send = torch.empty(math.prod(shape) * dtype.itemsize,
                               dtype=torch.uint8, device=self.device)
        if send.numel():
            send = self._host(send)
            dist.broadcast(send, src=members[src], group=group)
        if sender:
            return x
        return send.to(self.device).view(dtype).reshape(shape)

    def gather_blocks(self, x: torch.Tensor, axes: Axes = "model",
                      dst: Optional[int] = 0
                      ) -> Optional[Sequence[torch.Tensor]]:
        """Each shard's ``[rows, ...]`` block (rows may differ between
        shards; the trailing shape and the dtype may not), on shard
        ``dst`` of the group in shard order, ``None`` on the others; on
        every shard with ``dst=None``.  The lengths are gathered first,
        then the blocks padded to the longest, as bytes."""
        axes = mesh_axes(axes)
        size, group = self._groups[axes]
        members = self._members[axes]
        if group is None:
            return [x]
        lengths = self._gather(torch.tensor(
            [[x.shape[0]]], dtype=torch.int64, device=self.device),
            axes).reshape(-1).tolist()
        rows = max(lengths)
        send = _as_bytes(x)
        width = send.shape[1]
        if rows and width:
            if send.shape[0] < rows:
                send = torch.cat([send, send.new_zeros(
                    rows - send.shape[0], width)])
            send = self._host(send)
            me = members.index(dist.get_rank())
            if dst is None:
                parts = [torch.empty_like(send) for _ in range(size)]
                dist.all_gather(parts, send, group=group)
            else:
                parts = ([torch.empty_like(send) for _ in range(size)]
                         if me == dst else None)
                dist.gather(send, parts, dst=members[dst], group=group)
                if parts is None:
                    return None
        elif dst is not None and members[dst] != dist.get_rank():
            return None
        else:
            parts = [send.new_zeros(rows, width) for _ in range(size)]
        return [p[:n].to(self.device).view(x.dtype).reshape(n, *x.shape[1:])
                for p, n in zip(parts, lengths)]


class MetaRankMesh(RankMesh):
    """Shard ``shard`` of a ``data x model`` :class:`RankMesh`, alone on
    ``meta`` and in no process group: the dry-run's stand-in for one rank
    (``launch/dryrun.py``'s ``trace_rank_cell``).  It holds what that rank
    holds and runs a rank's collectives with their buffers (so a
    ``roofline.cost.CostCounter`` tracks them), but sends nothing: each
    exchange charges its bytes to the active counter under the
    reference's kind, and every peer's block is taken as this one's."""

    def __init__(self, data: int, model: int,
                 shard: Tuple[int, int] = (0, 0)):
        if data < 1 or model < 1:
            raise ValueError(f"mesh axes must be >= 1, got data={data} "
                             f"model={model}")
        d0, m0 = shard
        if not (0 <= d0 < data and 0 <= m0 < model):
            raise ValueError(f"shard {shard} is not one of a {data} x "
                             f"{model} mesh")
        self.data, self.model = data, model
        self.device = torch.device("meta")
        self.ranks = tuple(range(data * model))
        self.backend = "meta"
        self._stage = False
        self.local_data = range(d0, d0 + 1)
        self.local_model = range(m0, m0 + 1)
        self._groups, self._members = {}, {}
        for axes in (("model",), ("data",), AXES):
            size = math.prod(self.shape[a] for a in axes)
            self._groups[axes] = (size, "meta" if size > 1 else None)
            self._members[axes] = tuple(range(size))

    def __repr__(self) -> str:
        return (f"MetaRankMesh(data={self.data}, model={self.model}, "
                f"shard=({self.local_data[0]}, {self.local_model[0]}))")

    def _all_gather(self, parts, send, group) -> None:
        cost.charge_collective("all-gather",
                               len(parts) * cost.tensor_bytes(send))

    def _all_to_all(self, recv, send, group) -> None:
        cost.charge_collective("all-to-all", cost.tensor_bytes(recv))

    def gather_blocks(self, x: torch.Tensor, axes: Axes = "model",
                      dst: Optional[int] = 0):
        size = self._groups[mesh_axes(axes)][0]
        cost.charge_collective("all-gather", size * cost.tensor_bytes(x))
        return [x] * size
