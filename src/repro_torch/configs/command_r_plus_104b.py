"""command-r-plus-104b [dense]: 64L d12288 96H(kv8) ff33792 vocab256000.

[hf:CohereForAI/c4ai-command-r-v01; unverified].  GQA, no bias.  The 256k
vocab makes the loss the peak-memory hazard -> loss_chunk=512.
"""

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

ID = "command-r-plus-104b"


def full() -> TransformerConfig:
    return TransformerConfig(
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
        vocab=256000, qkv_bias=False,
        compute_dtype=torch.bfloat16, loss_chunk=512, attn_chunk=1024,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
        vocab=512, compute_dtype=torch.float32, attn_chunk=16, remat=False,
    )


SPEC = ArchSpec(
    id=ID, family="lm", model_kind="transformer",
    config=full(), reduced=reduced(), shapes=LM_SHAPES,
    notes="GQA kv=8, no-bias; 256k vocab -> chunked loss",
    source="hf:CohereForAI/c4ai-command-r-v01",
)
