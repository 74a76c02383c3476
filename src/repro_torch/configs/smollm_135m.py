"""smollm-135m [dense]: 30L d576 9H(kv3) ff1536 vocab49152 (llama-arch small).

[hf:HuggingFaceTB/SmolLM-135M; hf].  162.8M parameters (embedding and
``lm_head`` untied), 651 MB in f32: the one LM of the zoo a single card
holds whole at its published width.
"""

import torch

from repro_torch.configs.base import LM_SHAPES, ArchSpec
from repro_torch.models.transformer import TransformerConfig

ID = "smollm-135m"


def full() -> TransformerConfig:
    return TransformerConfig(
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
        vocab=49152, qkv_bias=False,
        compute_dtype=torch.bfloat16, loss_chunk=0, attn_chunk=2048,
    )


def reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=4, d_model=96, n_heads=3, n_kv_heads=3, d_ff=256,
        vocab=512, compute_dtype=torch.float32, attn_chunk=16, remat=False,
    )


SPEC = ArchSpec(
    id=ID, family="lm", model_kind="transformer",
    config=full(), reduced=reduced(), shapes=LM_SHAPES,
    notes="llama-arch small; the ~100M end-to-end training target",
    source="hf:HuggingFaceTB/SmolLM-135M",
)
