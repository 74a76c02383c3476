"""qwen1.5-32b [dense]: 64L d5120 40H(kv40, MHA) ff27392 vocab152064, QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf].  40 heads don't divide the 16-way model axis;
attention shards with GSPMD padding (40 -> 48 virtual head slots), while the
ff dim (27392 = 16*1712) and vocab (152064 = 16*9504) shard exactly.
"""

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

ID = "qwen1.5-32b"


def full() -> TransformerConfig:
    return TransformerConfig(
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
        vocab=152064, qkv_bias=True,
        compute_dtype=torch.bfloat16, loss_chunk=512, attn_chunk=1024,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab=256, qkv_bias=True,
        compute_dtype=torch.float32, attn_chunk=16, remat=False,
    )


SPEC = ArchSpec(
    id=ID, family="lm", model_kind="transformer",
    config=full(), reduced=reduced(), shapes=LM_SHAPES,
    notes="dense MHA with QKV bias; uneven head sharding (40/16) via padding",
    source="hf:Qwen/Qwen1.5-0.5B",
)
