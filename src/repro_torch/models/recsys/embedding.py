"""The sparse-embedding substrate of the recsys models.

All categorical fields share one fused table ``[n_fields * vocab_per_field,
dim]`` with per-field row offsets.  :func:`lookup`, :func:`bag_lookup` and
:func:`item_lookup` go through :func:`repro_torch.kernels.ops.
embedding_bag`: the hand-written CUDA kernel on the card, its plain
version on the CPU.  The kernel rounds each gathered row to the compute
dtype, so a table (6.66 GB in f32 at DLRM RM2's full width) is never cast
whole, where the reference casts it before its ``jnp.take``; the values
are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    n_fields: int
    vocab_per_field: int
    dim: int
    combiner: str = "sum"      # sum | mean (for multi-hot bags)

    @property
    def total_rows(self) -> int:
        return self.n_fields * self.vocab_per_field

    def param_count(self) -> int:
        return self.total_rows * self.dim


def init(cfg: EmbeddingConfig,
         gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The fused f32 table, ``N(0, 1/dim)``, on the generator's device."""
    table = torch.randn((cfg.total_rows, cfg.dim), generator=gen,
                        dtype=torch.float32, device=gen.device)
    return {"table": table.mul_(cfg.dim ** -0.5)}  # in place: 6.66 GB


def field_offsets(cfg: EmbeddingConfig, device=None) -> torch.Tensor:
    return torch.arange(cfg.n_fields, dtype=torch.int32,
                        device=device) * cfg.vocab_per_field


def lookup(cfg: EmbeddingConfig, params, ids: torch.Tensor,
           compute_dtype=torch.float32) -> torch.Tensor:
    """One-hot fields: ``ids int32[B, n_fields] -> [B, n_fields, dim]`` of
    ``compute_dtype``: one ``embedding_bag`` launch over ``B * n_fields``
    bags of one, with no mask (each weight one)."""
    flat = ids.to(torch.int32) + field_offsets(cfg, ids.device)[None, :]
    return L.embedding_apply(params, flat, compute_dtype=compute_dtype)


def bag_lookup(cfg: EmbeddingConfig, params, ids: torch.Tensor,
               mask: torch.Tensor,
               compute_dtype=torch.float32) -> torch.Tensor:
    """Multi-hot: ``ids int32[B, n_fields, bag]``, ``mask`` of that shape ->
    ``[B, n_fields, dim]`` (sum or mean combiner).  As in the reference, the
    rows in ``compute_dtype`` times the f32 mask promote: the output is f32
    for a bf16 or f32 compute dtype."""
    b, nf, bag = ids.shape
    flat = (ids.to(torch.int32)
            + field_offsets(cfg, ids.device)[None, :, None]).reshape(-1, bag)
    out_dtype = torch.promote_types(compute_dtype, mask.dtype)
    out = ops.embedding_bag(flat, mask.reshape(-1, bag), params["table"],
                            row_dtype=compute_dtype, out_dtype=out_dtype)
    out = out.reshape(b, nf, cfg.dim)
    if cfg.combiner == "mean":
        out = out / torch.clamp(mask.sum(dim=2), min=1.0)[..., None]
    return out


def item_lookup(table: torch.Tensor, ids: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Plain row gather (sequence models, candidate scoring): one
    ``embedding_bag`` launch over bags of one with no mask; ids outside
    ``[-V, V)`` give NaN rows, as ``jnp.take`` does."""
    return L.embedding_apply({"table": table}, ids,
                             compute_dtype=compute_dtype)
