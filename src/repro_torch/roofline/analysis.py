"""Three-term roofline from a step's traced cost (``roofline/cost.py``).

    compute    = tensor-core FLOPs / bf16 peak + other FLOPs / f32 peak
    memory     = HBM bytes / HBM bandwidth
    collective = collective bytes / link bandwidth

every figure per device.  The counterpart of ``repro.roofline.analysis``:
the same terms, record fields and fit check, read from the meta-device
trace in place of a compiled XLA program, against an H100 in place of a
TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.roofline.cost import Cost


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One card.  The defaults are NVIDIA's datasheet figures for the
    NVIDIA H100 80GB HBM3 (SXM5) at a 700 W power limit; a card set below
    700 W runs slower under load than they say."""

    name: str = "NVIDIA H100 80GB HBM3"
    power_limit_w: float = 700.0
    peak_flops_tensor: float = 989.4e12   # dense bf16 on the tensor cores
    peak_flops_other: float = 66.9e12     # f32 outside the tensor cores
    hbm_bw: float = 3.35e12               # B/s, HBM3
    link_bw: float = 450e9                # B/s per direction, NVLink 4
    hbm_bytes: float = 80e9               # capacity, for fit checks

    @classmethod
    def from_device(cls, index: int = 0) -> "Hardware":
        """The datasheet's rates with this card's name and memory
        (``torch.cuda.get_device_properties``)."""
        import torch

        props = torch.cuda.get_device_properties(index)
        return dataclasses.replace(cls(), name=props.name,
                                   hbm_bytes=float(props.total_memory))

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


HW = Hardware()


@dataclasses.dataclass
class RooflineTerms:
    flops: float                   # per-device FLOPs
    hbm_bytes: float               # per-device HBM bytes accessed
    collective_bytes: float        # per-device bytes on the wire
    collective_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0
    per_device_mem: Optional[dict] = None
    flops_tensor_core: float = 0.0  # the part of ``flops`` on tensor cores

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_counts(
    cost: Cost,
    *,
    hw: Hardware = HW,
    model_flops_total: float = 0.0,
    n_devices: int = 1,
) -> RooflineTerms:
    """The three terms from a per-device :class:`Cost`.
    ``model_flops_total`` is the *global* useful-model FLOPs of the step
    (``6 N D`` and the like), divided by ``n_devices`` for the per-device
    ratio, as the reference does."""
    compute_s = (cost.flops_tensor_core / hw.peak_flops_tensor
                 + cost.flops_other / hw.peak_flops_other)
    memory_s = cost.hbm_bytes / hw.hbm_bw
    collective_s = cost.collective_bytes / hw.link_bw
    terms = dict(compute=compute_s, memory=memory_s, collective=collective_s)
    dominant = max(terms, key=terms.get)
    model_flops_dev = model_flops_total / max(n_devices, 1)
    return RooflineTerms(
        flops=cost.flops,
        hbm_bytes=cost.hbm_bytes,
        collective_bytes=cost.collective_bytes,
        collective_breakdown={**cost.collective_breakdown,
                              "counts": dict(n_ops=cost.n_ops)},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops_dev,
        useful_flops_ratio=(model_flops_dev / cost.flops) if cost.flops
        else 0.0,
        per_device_mem=cost.memory(),
        flops_tensor_core=cost.flops_tensor_core,
    )


def fit_check(terms: RooflineTerms, hw: Hardware = HW) -> Tuple[bool, float]:
    """Does (args + outputs + temps) fit per-card memory?"""
    m = terms.per_device_mem or {}
    used = sum(
        v for k, v in m.items()
        if k in ("argument_bytes", "output_bytes", "temp_bytes")
        and isinstance(v, (int, float))
    )
    # aliased (updated in place) buffers are counted in both args and outputs
    alias = m.get("alias_bytes") or 0
    used -= alias
    return used <= hw.hbm_bytes, used
