"""grok-1-314b [moe]: 64L d6144 48H(kv8) ff32768 vocab131072, 8 experts top-2.

[hf:xai-org/grok-1; unverified].  8 experts < 16-way model axis ->
ep_split=2: each expert splits into two ff-half virtual experts (TP inside
the expert), giving 16 virtual experts that shard cleanly.
"""

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import MoEConfig, TransformerConfig

ID = "grok-1-314b"


def full() -> TransformerConfig:
    return TransformerConfig(
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
        vocab=131072, qkv_bias=False,
        moe=MoEConfig(n_experts=8, top_k=2, ep_split=2),
        compute_dtype=torch.bfloat16, loss_chunk=512, attn_chunk=1024,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab=256, moe=MoEConfig(n_experts=2, top_k=2, ep_split=2),
        compute_dtype=torch.float32, attn_chunk=16, remat=False,
    )


SPEC = ArchSpec(
    id=ID, family="lm", model_kind="transformer",
    config=full(), reduced=reduced(), shapes=LM_SHAPES,
    notes="8 experts top-2; ep_split=2 -> 16 virtual experts",
    source="hf:xai-org/grok-1",
)
