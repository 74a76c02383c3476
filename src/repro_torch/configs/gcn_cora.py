"""gcn-cora [gnn]: 2 layers, d_hidden=16, mean/sym-norm aggregation.

[arXiv:1609.02907; paper].  Feature and class widths vary per shape (cora
1,433/7, reddit-like minibatch 602/41, ogbn-products 100/47, molecule
32/2), so ``launch/steps.py`` assembles the concrete ``GCNConfig`` per
(arch, shape) from this template.  PowerWalk integration: the
PPR-propagation mode and the PPR sampler (``models/gcn.py``,
``graphs/sampler.py``).
"""

import dataclasses

import torch

from repro_torch.configs.base import GNN_SHAPES, ArchSpec


@dataclasses.dataclass(frozen=True)
class GCNTemplate:
    n_layers: int = 2
    d_hidden: int = 16
    aggregator: str = "mean"
    norm: str = "sym"
    compute_dtype: object = torch.float32


ID = "gcn-cora"


def full() -> GCNTemplate:
    return GCNTemplate()


def reduced() -> GCNTemplate:
    return GCNTemplate(n_layers=2, d_hidden=8)


SPEC = ArchSpec(
    id=ID, family="gnn", model_kind="gcn",
    config=full(), reduced=reduced(), shapes=GNN_SHAPES,
    notes="segment_sum message passing; minibatch_lg uses the fanout sampler",
    source="arXiv:1609.02907",
)
