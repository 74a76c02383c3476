"""Production mesh construction: the counterpart of ``repro.launch.mesh``.

The reference builds ``jax.make_mesh`` meshes of 256 (one pod, ``16 x
16``) or 512 (two pods, ``2 x 16 x 16``) devices.  The port's mesh is a
:class:`~repro_torch.distributed.mesh.ShardMesh`, whose shards are stacked
on one device; for the dry-run that device is ``meta``, which allocates
nothing, so a production mesh costs no memory.  The reference's ``pod``
axis is pure data parallelism (DCN between pods), so the two-pod mesh
folds it into ``data``: ``ShardMesh(data=32, model=16)``.  Axis roles as
in the reference: ``model`` holds the vertex intervals (TP/EP), ``data``
the replicas.

:func:`make_rank_mesh` is the mesh over real devices: it joins a
``torch.distributed`` process group, one process a shard, and returns a
:class:`~repro_torch.distributed.mesh.RankMesh`.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import RankMesh, ShardMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> ShardMesh:
    """``16 x 16`` (``data x model``), or ``32 x 16`` with ``multi_pod``
    (the reference's ``pod x data`` folded into ``data``)."""
    return ShardMesh(data=32 if multi_pod else 16, model=16, device=device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device="cuda") -> ShardMesh:
    """A small mesh for sharding tests (stacked: needs no more devices)."""
    return ShardMesh(data=n_data, model=n_model, device=device)


def describe(mesh: ShardMesh) -> dict:
    """The reference's keys: ``shape``, ``n_devices``, ``axis_names``."""
    return dict(shape=dict(mesh.shape), n_devices=int(mesh.size),
                axis_names=list(mesh.shape))


def _env_int(name: str, given: Optional[int], default: Optional[int] = None
             ) -> int:
    if given is not None:
        return int(given)
    if name in os.environ:
        return int(os.environ[name])
    if default is None:
        raise ValueError(f"{name} is not set: start the ranks with torchrun, "
                         f"or pass rank= and world_size= with an init_method")
    return default


def check_one_device_a_rank(store, rank: int, world_size: int,
                            device: torch.device) -> None:
    """Every NCCL rank on a device of its own: each rank writes its host
    and device index to the rendezvous ``store`` and reads every other's;
    two ranks on one device raise (NCCL refuses them) before any process
    group is joined."""
    mine = f"{socket.gethostname()}/{device.index}"
    store.set(f"rank_mesh/device/{rank}", mine)
    for other in range(world_size):
        if other == rank:
            continue
        theirs = store.get(f"rank_mesh/device/{other}").decode()
        if theirs == mine:
            raise ValueError(
                f"ranks {min(rank, other)} and {max(rank, other)} are both on "
                f"{device} of {socket.gethostname()}: NCCL runs one rank a "
                "device; pass backend='gloo' to share a card")


def make_rank_mesh(n_data: int, n_model: int, *,
                   backend: Optional[str] = None, device=None,
                   timeout_s: float = 300.0,
                   init_method: Optional[str] = None,
                   rank: Optional[int] = None,
                   world_size: Optional[int] = None) -> RankMesh:
    """Join a process group of ``n_data * n_model`` ranks, one shard each,
    and return this rank's :class:`RankMesh` (ranks row-major over ``(data,
    model)``, as ``jax.make_mesh`` lays out devices): the counterpart of
    ``repro.launch.mesh.make_debug_mesh`` over real devices.

    The group comes from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``:
    ``env://``) or from ``init_method`` (``file://`` or ``tcp://``) with
    ``rank`` and ``world_size``.  The device is ``cuda:{LOCAL_RANK}``
    unless ``device`` names one; it is made current, since the kernels
    launch on the current device's streams.  ``backend`` defaults to
    ``nccl`` on a CUDA device and ``gloo`` on the CPU; ``gloo`` on a CUDA
    device only when asked (several ranks on one card).  ``timeout_s``
    bounds every collective, so a dead rank fails its peers.

    Raises, never falling back: ``n_data * n_model`` not the world size,
    a ``meta`` device, NCCL on a build without it or on a device that is
    not CUDA, and two NCCL ranks on one device (before the group is
    joined).  On a CUDA device local rank 0 builds the kernels before a
    barrier, so the ranks of a host do not each run nvcc.
    """
    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    local_rank = _env_int("LOCAL_RANK", None, default=rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", None, default=world_size)
    if n_data < 1 or n_model < 1 or n_data * n_model != world_size:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the world has "
                         f"{world_size}")
    named = device is not None
    dev = torch.device(device if named else "cuda")
    if dev.type == "meta":
        raise ValueError("a rank mesh computes: meta is the dry-run's "
                         "ShardMesh device")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available in this torch build; "
                               "pass backend='gloo' to run over gloo")
        if not named and local_world > torch.cuda.device_count():
            raise ValueError(
                f"{local_world} NCCL ranks on this host, "
                f"{torch.cuda.device_count()} CUDA devices: NCCL runs one "
                "rank a device; pass backend='gloo' to share a card")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(
        init_method or "env://", rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    if backend == "nccl":
        check_one_device_a_rank(store, rank, world_size, dev)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=timeout, device_id=dev if backend == "nccl" else None)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        if local_rank == 0:
            build.build()
        dist.barrier()
    return RankMesh(n_data, n_model, dev, timeout_s=timeout_s)
