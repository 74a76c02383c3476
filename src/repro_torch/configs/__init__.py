"""Architecture registry of the port: ``get_arch("<id>") -> ArchSpec``.

It holds the reference's ten architectures: the five LMs (``smollm-135m``
whole; ``qwen1.5-32b``, ``command-r-plus-104b`` and the two MoE LMs
``dbrx-132b`` and ``grok-1-314b``, whose f32 parameters outgrow one card
at full depth, so a card runs them at full width with the depth cut),
``gcn-cora`` (its four shapes, all train shapes) and the four recsys
architectures (training and serving).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (command_r_plus_104b, dbrx_132b, dcn_v2,
                                 dlrm_rm2, gcn_cora, grok_1_314b, mind,
                                 qwen1_5_32b, sasrec, smollm_135m)
from repro_torch.configs.base import ArchSpec

# the reference's registry order, so ``all_cells`` lists its cells in order
_MODULES = (dbrx_132b, grok_1_314b, qwen1_5_32b, command_r_plus_104b,
            smollm_135m, gcn_cora, dcn_v2, dlrm_rm2, sasrec, mind)

REGISTRY: Dict[str, ArchSpec] = {m.SPEC.id: m.SPEC for m in _MODULES}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_arch_ids() -> List[str]:
    return list(REGISTRY)


def all_cells() -> List[tuple]:
    """Every (arch_id, shape_name) cell of the assignment (40 total)."""
    return [(spec.id, shape.name) for spec in REGISTRY.values()
            for shape in spec.shapes]
