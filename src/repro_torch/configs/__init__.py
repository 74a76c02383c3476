"""Architecture registry of the port: ``get_arch("<id>") -> ArchSpec``.

It holds only what is ported: ``dlrm-rm2`` (serving).  The reference's
other architectures come with the rest of the model zoo, a later slice of
the port (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import dlrm_rm2
from repro_torch.configs.base import ArchSpec

REGISTRY: Dict[str, ArchSpec] = {m.SPEC.id: m.SPEC for m in (dlrm_rm2,)}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"arch {arch_id!r} is not ported; the port's registry holds "
            f"{sorted(REGISTRY)}, the rest of the model zoo is a later slice")
    return REGISTRY[arch_id]
