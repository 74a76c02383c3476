"""dbrx-132b [moe]: 40L d6144 48H(kv8) ff10752 vocab100352, 16 experts top-4.

[hf:databricks/dbrx-base; unverified].  16 experts land exactly on the
16-way model axis (EP=16, ep_split=1).
"""

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import MoEConfig, TransformerConfig

ID = "dbrx-132b"


def full() -> TransformerConfig:
    return TransformerConfig(
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
        vocab=100352, qkv_bias=False,
        moe=MoEConfig(n_experts=16, top_k=4, ep_split=1),
        compute_dtype=torch.bfloat16, loss_chunk=512, attn_chunk=1024,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab=256, qkv_bias=False,
        moe=MoEConfig(n_experts=4, top_k=2, ep_split=1),
        compute_dtype=torch.float32, attn_chunk=16, remat=False,
    )


SPEC = ArchSpec(
    id=ID, family="lm", model_kind="transformer",
    config=full(), reduced=reduced(), shapes=LM_SHAPES,
    notes="fine-grained MoE, 16e top-4; EP=16 on the model axis",
    source="hf:databricks/dbrx-base",
)
