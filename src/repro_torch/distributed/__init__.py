"""Meshes of the distributed engine: :class:`~repro_torch.distributed.mesh
.ShardMesh` (every shard stacked on one device) and :class:`~repro_torch
.distributed.mesh.RankMesh` (one shard a ``torch.distributed`` rank)."""

from repro_torch.distributed.mesh import RankMesh, ShardMesh  # noqa: F401
