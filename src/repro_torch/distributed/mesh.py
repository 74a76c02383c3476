"""A ``(data, model)`` mesh whose shards are stacked on one device.

The port's counterpart of ``repro.launch.mesh.make_debug_mesh`` together
with ``repro.compat.shard_map``: a per-shard array is one tensor with a
leading stacked shard axis, the engine runs each shard's body in a loop
over that axis, and each collective it uses is one tensor op on the axis.
The collectives are methods, so that a mesh over ``torch.distributed``
process groups (one shard per rank) can take this one's place.

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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.roofline import cost


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

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``all_to_all(split_axis=1, concat_axis=1, tiled=False)`` of
        per-shard ``[Q, S, ...]`` blocks stacked as ``[S, Q, S, ...]``:
        shard ``r`` receives from shard ``s`` the block ``s`` addressed to
        ``r``, i.e. ``out[r, :, s] = x[s, :, r]``."""
        with cost.uncharged():
            out = x.transpose(0, 2).contiguous()
        cost.charge_collective("all-to-all", cost.tensor_bytes(out))
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the stacked per-shard values ``[S, ...]``."""
        with cost.uncharged():
            out = x.sum(dim=0)
        cost.charge_collective("all-reduce",
                               x.shape[0] * cost.tensor_bytes(out))
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather(axis=1, tiled=True)`` of per-shard ``[Q, k]``
        stacked as ``[S, Q, k]``: ``[Q, S * k]`` in shard order."""
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
