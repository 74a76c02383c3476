"""Architecture registry of the port: ``get_arch("<id>") -> ArchSpec``.

It holds what is ported: ``smollm-135m`` (training, prefill and KV-cache
decode), ``gcn-cora`` (its four shapes, all train shapes) and the four
recsys architectures (training and serving).  The reference's other four
LMs wait for a multi-GPU mesh: their f32 parameters outgrow one card.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (dcn_v2, dlrm_rm2, gcn_cora, mind, sasrec,
                                 smollm_135m)
from repro_torch.configs.base import ArchSpec

# the reference's registry order, so ``all_cells`` lists its cells in order
_MODULES = (smollm_135m, gcn_cora, dcn_v2, dlrm_rm2, sasrec, mind)

REGISTRY: Dict[str, ArchSpec] = {m.SPEC.id: m.SPEC for m in _MODULES}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"arch {arch_id!r} is not ported; the port's registry holds "
            f"{sorted(REGISTRY)}; the other LMs come with a multi-GPU mesh, a "
            "later slice")
    return REGISTRY[arch_id]


def all_arch_ids() -> List[str]:
    return list(REGISTRY)


def all_cells() -> List[tuple]:
    """Every (arch_id, shape_name) cell of the ported architectures."""
    return [(spec.id, shape.name) for spec in REGISTRY.values()
            for shape in spec.shapes]
