"""dcn-v2 [recsys]: 13 dense + 26 sparse fields, embed 16, 3 cross layers,
MLP 1024-1024-512. [arXiv:2008.13535; paper].

Per-field vocab is not pinned by the paper's setting; Criteo-scale 10^6
rows a field (26M embedding rows in all, one fused table).
"""

import torch

from repro_torch.configs.base import REC_SHAPES, ArchSpec
from repro_torch.models.recsys.dcn import DCNConfig

ID = "dcn-v2"


def full() -> DCNConfig:
    return DCNConfig(
        n_dense=13, n_sparse=26, embed_dim=16, n_cross_layers=3,
        mlp=(1024, 1024, 512), vocab_per_field=1_000_000,
        compute_dtype=torch.bfloat16,
    )


def reduced() -> DCNConfig:
    return DCNConfig(
        n_dense=13, n_sparse=26, embed_dim=8, n_cross_layers=2,
        mlp=(32, 16), vocab_per_field=100, compute_dtype=torch.float32,
    )


SPEC = ArchSpec(
    id=ID, family="recsys", model_kind="dcn",
    config=full(), reduced=reduced(), shapes=REC_SHAPES,
    notes="cross interaction; PowerWalk PPR used as candidate generator",
    source="arXiv:2008.13535",
)
