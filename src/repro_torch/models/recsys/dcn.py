"""DCN-v2 (arXiv:2008.13535): explicit cross network + deep tower.

``forward`` and ``retrieval_scores`` serve; ``loss_fn`` trains (binary
cross-entropy of the forward).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross_layers: int = 3
    mlp: Sequence[int] = (1024, 1024, 512)
    vocab_per_field: int = 1_000_000
    compute_dtype: Any = torch.float32

    @property
    def x0_dim(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    @property
    def embedding(self) -> E.EmbeddingConfig:
        return E.EmbeddingConfig(
            self.n_sparse, self.vocab_per_field, self.embed_dim)

    def param_count(self) -> int:
        d = self.x0_dim
        cross = self.n_cross_layers * (d * d + d)
        dims = [d] + list(self.mlp)
        deep = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        head = (d + self.mlp[-1]) + 1
        return self.embedding.param_count() + cross + deep + head


def init(cfg: DCNConfig, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """Random f32 parameters from ``seed``, made on ``device`` (the table
    is ``n_sparse * vocab_per_field`` rows: 1.66 GB at full width)."""
    gen = seeded_generator(resolve_device(device), seed)
    d = cfg.x0_dim
    p: Dict[str, Any] = {
        "embedding": E.init(cfg.embedding, gen),
        "deep": L.mlp_init(gen, [d] + list(cfg.mlp)),
        "head": L.dense_init(gen, d + cfg.mlp[-1], 1, bias=True),
    }
    for i in range(cfg.n_cross_layers):
        p[f"cross_{i}"] = L.dense_init(gen, d, d, bias=True)
    return p


def forward(cfg: DCNConfig, params, batch) -> torch.Tensor:
    """Logits ``[B]`` of ``dense f32[B, n_dense]``, ``sparse_ids
    int32[B, n_sparse]``."""
    dt = cfg.compute_dtype
    emb = E.lookup(cfg.embedding, params["embedding"], batch["sparse_ids"], dt)
    x0 = torch.cat([batch["dense"].to(dt), emb.reshape(emb.shape[0], -1)],
                   dim=-1)
    # cross tower: x_{l+1} = x0 * (W x_l + b) + x_l
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * L.dense_apply(params[f"cross_{i}"], x, compute_dtype=dt) + x
    deep = L.mlp_apply(params["deep"], x0, compute_dtype=dt)
    feats = torch.cat([x, deep], dim=-1)
    return L.dense_apply(params["head"], feats, compute_dtype=dt)[:, 0]


def loss_fn(cfg: DCNConfig, params, batch) -> torch.Tensor:
    """Binary cross-entropy of the logits against ``label f32[B]``."""
    logits = forward(cfg, params, batch)
    return L.binary_cross_entropy(logits, batch["label"])


def retrieval_scores(cfg: DCNConfig, params, batch) -> torch.Tensor:
    """One user context against ``n_candidates`` items: the candidate id
    replaces sparse field 0, every other feature broadcasts.  Returns
    ``[n_cand]`` scores."""
    n_cand = batch["candidates"].shape[0]
    ids = batch["sparse_ids"].reshape(1, cfg.n_sparse).expand(
        n_cand, cfg.n_sparse).clone()
    ids[:, 0] = batch["candidates"]
    dense = batch["dense"].reshape(1, cfg.n_dense).expand(n_cand, cfg.n_dense)
    return forward(cfg, params, dict(dense=dense, sparse_ids=ids))
