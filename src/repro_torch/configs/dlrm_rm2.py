"""dlrm-rm2 [recsys]: embed 64, bot 13-512-256-64, top 512-512-256-1, dot
interaction. [arXiv:1906.00091; paper].  Criteo-scale 10^6 rows/field.
"""

import torch

from repro_torch.configs.base import REC_SHAPES, ArchSpec
from repro_torch.models.recsys.dlrm import DLRMConfig

ID = "dlrm-rm2"


def full() -> DLRMConfig:
    return DLRMConfig(
        n_dense=13, n_sparse=26, embed_dim=64,
        bot_mlp=(13, 512, 256, 64), top_mlp=(512, 512, 256, 1),
        vocab_per_field=1_000_000, compute_dtype=torch.bfloat16,
    )


def reduced() -> DLRMConfig:
    return DLRMConfig(
        n_dense=13, n_sparse=26, embed_dim=16,
        bot_mlp=(13, 32, 16), top_mlp=(32, 16, 1),
        vocab_per_field=100, compute_dtype=torch.float32,
    )


SPEC = ArchSpec(
    id=ID, family="recsys", model_kind="dlrm",
    config=full(), reduced=reduced(), shapes=REC_SHAPES,
    notes="dot interaction; one fused embedding table",
    source="arXiv:1906.00091",
)
