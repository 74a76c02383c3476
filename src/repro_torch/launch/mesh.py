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
"""

from __future__ import annotations

from repro_torch.distributed.mesh import ShardMesh


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
