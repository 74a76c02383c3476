"""sasrec [recsys]: embed 50, 2 blocks, 1 head, seq 50, self-attn-seq
interaction. [arXiv:1808.09781; paper].  Item catalog 10^6.
"""

import torch

from repro_torch.configs.base import REC_SHAPES, ArchSpec
from repro_torch.models.recsys.sasrec import SASRecConfig

ID = "sasrec"


def full() -> SASRecConfig:
    return SASRecConfig(
        n_items=1_000_000, embed_dim=50, n_blocks=2, n_heads=1, seq_len=50,
        d_ff=200, compute_dtype=torch.bfloat16,
    )


def reduced() -> SASRecConfig:
    return SASRecConfig(
        n_items=500, embed_dim=16, n_blocks=2, n_heads=1, seq_len=12,
        d_ff=32, compute_dtype=torch.float32,
    )


SPEC = ArchSpec(
    id=ID, family="recsys", model_kind="sasrec",
    config=full(), reduced=reduced(), shapes=REC_SHAPES,
    notes="sequential self-attention; retrieval = user-emb dot item table",
    source="arXiv:1808.09781",
)
