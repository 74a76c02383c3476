"""mind [recsys]: embed 64, 4 interests, 3 capsule routing iters,
multi-interest retrieval. [arXiv:1904.08030; unverified].  Catalog 10^6.
"""

import torch

from repro_torch.configs.base import REC_SHAPES, ArchSpec
from repro_torch.models.recsys.mind import MINDConfig

ID = "mind"


def full() -> MINDConfig:
    return MINDConfig(
        n_items=1_000_000, embed_dim=64, n_interests=4, capsule_iters=3,
        hist_len=50, compute_dtype=torch.bfloat16,
    )


def reduced() -> MINDConfig:
    return MINDConfig(
        n_items=500, embed_dim=16, n_interests=2, capsule_iters=2,
        hist_len=10, compute_dtype=torch.float32,
    )


SPEC = ArchSpec(
    id=ID, family="recsys", model_kind="mind",
    config=full(), reduced=reduced(), shapes=REC_SHAPES,
    notes="capsule routing; retrieval scores = max over interests",
    source="arXiv:1904.08030",
)
