"""SASRec (arXiv:1808.09781): self-attentive sequential recommendation.

``encode``, ``user_embedding`` and ``retrieval_scores`` serve; ``loss_fn``
trains (BPR over sampled negatives).  Every gather (items, positions,
candidates, the loss's positives and negatives) is one ``embedding_bag``
launch, and in training one launch of its backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers as L
from repro_torch.models.attention import chunked_attention
from repro_torch.models.recsys import embedding as E


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    d_ff: int = 200
    compute_dtype: Any = torch.float32

    def param_count(self) -> int:
        d = self.embed_dim
        attn = 4 * d * d
        ffn = 2 * d * self.d_ff
        per_block = attn + ffn + 4 * d
        return (self.n_items + self.seq_len) * d + self.n_blocks * per_block


def init(cfg: SASRecConfig, seed: int = 0, *,
         device="cuda") -> Dict[str, Any]:
    """Random f32 parameters from ``seed``, made on ``device``."""
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    d = cfg.embed_dim
    p: Dict[str, Any] = {
        "item_embed": L.embedding_init(gen, cfg.n_items, d),
        "pos_embed": L.embedding_init(gen, cfg.seq_len, d),
    }
    for i in range(cfg.n_blocks):
        p[f"block_{i}"] = {
            "ln1": L.layernorm_init(d, dev),
            "ln2": L.layernorm_init(d, dev),
            "wq": L.dense_init(gen, d, d),
            "wk": L.dense_init(gen, d, d),
            "wv": L.dense_init(gen, d, d),
            "wo": L.dense_init(gen, d, d),
            "ff1": L.dense_init(gen, d, cfg.d_ff, bias=True),
            "ff2": L.dense_init(gen, cfg.d_ff, d, bias=True),
        }
    return p


def encode(cfg: SASRecConfig, params, item_seq: torch.Tensor) -> torch.Tensor:
    """``item_seq int32[B, S]`` -> hidden ``[B, S, d]`` (causal)."""
    b, s = item_seq.shape
    dt = cfg.compute_dtype
    hd = cfg.embed_dim // cfg.n_heads
    h = L.embedding_apply(params["item_embed"], item_seq, compute_dtype=dt)
    h = h + L.embedding_apply(
        params["pos_embed"], torch.arange(s, device=item_seq.device)[None, :],
        compute_dtype=dt)
    for i in range(cfg.n_blocks):
        p = params[f"block_{i}"]
        x = L.layernorm_apply(p["ln1"], h)
        q, k, v = (L.dense_apply(p[w], x, compute_dtype=dt).reshape(
            b, s, cfg.n_heads, hd) for w in ("wq", "wk", "wv"))
        o = chunked_attention(q, k, v, n_kv_heads=cfg.n_heads, causal=True,
                              chunk=min(s, 512))
        h = h + L.dense_apply(p["wo"], o.reshape(b, s, -1), compute_dtype=dt)
        x = L.layernorm_apply(p["ln2"], h)
        h = h + L.dense_apply(
            p["ff2"], torch.relu(L.dense_apply(p["ff1"], x, compute_dtype=dt)),
            compute_dtype=dt)
    return h


def loss_fn(cfg: SASRecConfig, params, batch) -> torch.Tensor:
    """Next-item BPR loss with sampled negatives.

    batch: ``item_seq``, ``pos``, ``neg`` (int32) and ``mask`` (f32), each
    ``[B, S]``."""
    h = encode(cfg, params, batch["item_seq"])
    table = params["item_embed"]["table"]
    pos_e = E.item_lookup(table, batch["pos"], h.dtype)
    neg_e = E.item_lookup(table, batch["neg"], h.dtype)
    pos_s = (h * pos_e).sum(dim=-1)
    neg_s = (h * neg_e).sum(dim=-1)
    mask = batch["mask"]
    nll = -torch.log(torch.sigmoid(pos_s - neg_s) + 1e-9) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def user_embedding(cfg: SASRecConfig, params,
                   item_seq: torch.Tensor) -> torch.Tensor:
    """Last hidden state: the user representation for retrieval."""
    return encode(cfg, params, item_seq)[:, -1, :]


def retrieval_scores(cfg: SASRecConfig, params, batch) -> torch.Tensor:
    """One user history against ``n_candidates``: one dot a candidate.

    batch: ``item_seq [1, S]``, ``candidates int32 [n_cand]`` ->
    ``[n_cand]``."""
    u = user_embedding(cfg, params, batch["item_seq"])          # [1, d]
    cand = E.item_lookup(params["item_embed"]["table"], batch["candidates"],
                         u.dtype)                               # [n_cand, d]
    return cand @ u[0]
