"""Sharding for the distributed engine: :class:`~repro_torch.distributed.mesh.ShardMesh`."""

from repro_torch.distributed.mesh import ShardMesh  # noqa: F401
