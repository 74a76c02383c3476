"""DLRM RM2 (arXiv:1906.00091): bottom MLP + dot interaction + top MLP.

``forward`` and ``retrieval_scores`` serve; ``loss_fn`` trains (binary
cross-entropy of the forward; the table's gradient comes from
``embedding_bag``'s backward kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Sequence[int] = (13, 512, 256, 64)
    top_mlp: Sequence[int] = (512, 512, 256, 1)
    vocab_per_field: int = 1_000_000
    compute_dtype: Any = torch.float32

    @property
    def n_vectors(self) -> int:
        return self.n_sparse + 1  # embeddings + bottom-MLP output

    @property
    def n_interactions(self) -> int:
        return self.n_vectors * (self.n_vectors - 1) // 2

    @property
    def top_in(self) -> int:
        return self.n_interactions + self.embed_dim

    @property
    def embedding(self) -> E.EmbeddingConfig:
        return E.EmbeddingConfig(
            self.n_sparse, self.vocab_per_field, self.embed_dim)

    def param_count(self) -> int:
        bot = sum(a * b + b
                  for a, b in zip(self.bot_mlp[:-1], self.bot_mlp[1:]))
        dims = [self.top_in] + list(self.top_mlp)
        top = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return self.embedding.param_count() + bot + top


def init(cfg: DLRMConfig, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """Random f32 parameters from ``seed``, made on ``device`` (the table
    is ``n_sparse * vocab_per_field`` rows: 6.66 GB at full width)."""
    gen = seeded_generator(resolve_device(device), seed)
    return {
        "embedding": E.init(cfg.embedding, gen),
        "bot": L.mlp_init(gen, list(cfg.bot_mlp)),
        "top": L.mlp_init(gen, [cfg.top_in] + list(cfg.top_mlp)),
    }


def _interact(vectors: torch.Tensor) -> torch.Tensor:
    """Pairwise dots, lower triangle in row-major order (as
    ``jnp.tril_indices(v, k=-1)``): ``[B, V, d] -> [B, V(V-1)/2]``."""
    v = vectors.shape[1]
    gram = torch.bmm(vectors, vectors.transpose(1, 2))
    ii, jj = torch.tril_indices(v, v, offset=-1, device=vectors.device)
    return gram[:, ii, jj]


def forward(cfg: DLRMConfig, params, batch) -> torch.Tensor:
    """Logits ``[B]`` of ``dense f32[B, n_dense]``, ``sparse_ids
    int32[B, n_sparse]``."""
    dt = cfg.compute_dtype
    d0 = L.mlp_apply(params["bot"], batch["dense"], compute_dtype=dt,
                     final_act=torch.relu)
    emb = E.lookup(cfg.embedding, params["embedding"], batch["sparse_ids"], dt)
    vectors = torch.cat([d0[:, None, :], emb], dim=1)    # [B, 27, 64]
    inter = _interact(vectors)
    top_in = torch.cat([inter, d0], dim=-1)
    return L.mlp_apply(params["top"], top_in, compute_dtype=dt)[:, 0]


def loss_fn(cfg: DLRMConfig, params, batch) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``label f32[B]``."""
    return L.binary_cross_entropy(forward(cfg, params, batch), batch["label"])


def retrieval_scores(cfg: DLRMConfig, params, batch) -> torch.Tensor:
    """One user against ``n_candidates`` (the candidate id goes to sparse
    field 0)."""
    n_cand = batch["candidates"].shape[0]
    ids = batch["sparse_ids"].reshape(1, cfg.n_sparse).expand(
        n_cand, cfg.n_sparse).clone()
    ids[:, 0] = batch["candidates"]
    dense = batch["dense"].reshape(1, cfg.n_dense).expand(n_cand, cfg.n_dense)
    return forward(cfg, params, dict(dense=dense, sparse_ids=ids))
