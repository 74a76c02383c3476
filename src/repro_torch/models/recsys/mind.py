"""MIND (arXiv:1904.08030): multi-interest capsule network for retrieval.

``user_interests``, ``label_aware_scores`` and ``retrieval_scores``
serve; ``loss_fn`` trains (a sampled softmax).  Every gather (history,
candidates) is one ``embedding_bag`` launch, and in training one launch of
its backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers as L
from repro_torch.models.recsys import embedding as E


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0          # label-aware attention sharpness
    n_negatives: int = 127      # sampled-softmax negatives (training)
    compute_dtype: Any = torch.float32

    def param_count(self) -> int:
        d = self.embed_dim
        return self.n_items * d + d * d + 2 * d * d


def init(cfg: MINDConfig, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """Random f32 parameters from ``seed``, made on ``device``."""
    gen = seeded_generator(resolve_device(device), seed)
    d = cfg.embed_dim
    return {
        "item_embed": L.embedding_init(gen, cfg.n_items, d),
        # shared bilinear map S of B2I routing (behavior -> interest space)
        "s_map": L.dense_init(gen, d, d),
        "out": L.mlp_init(gen, [d, 2 * d, d]),
    }


def _squash(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    n2 = x.square().sum(dim=axis, keepdim=True)
    return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + 1e-9)


def user_interests(cfg: MINDConfig, params, hist: torch.Tensor,
                   hist_mask: torch.Tensor) -> torch.Tensor:
    """B2I dynamic routing: ``hist int32[B, H]`` -> interests ``[B, K, d]``."""
    dt = cfg.compute_dtype
    b, hlen = hist.shape
    e = L.embedding_apply(params["item_embed"], hist, compute_dtype=dt)
    eh = L.dense_apply(params["s_map"], e, compute_dtype=dt)     # [B, H, d]
    eh = eh * hist_mask[..., None].to(dt)
    # routing logits in f32, fixed at 0 to start (the paper samples them;
    # 0 is deterministic)
    blog = torch.zeros((b, hlen, cfg.n_interests), dtype=torch.float32,
                       device=hist.device)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=-1) * hist_mask[..., None]  # [B, H, K]
        z = torch.einsum("bhk,bhd->bkd", w.to(dt), eh)
        interests = _squash(z)
        blog = blog + torch.einsum("bhd,bkd->bhk", eh, interests).float()
    # per-interest output MLP (the paper's two-layer head)
    return L.mlp_apply(params["out"], interests, compute_dtype=dt)


def label_aware_scores(cfg: MINDConfig, interests: torch.Tensor,
                       target_e: torch.Tensor) -> torch.Tensor:
    """Label-aware attention: ``softmax(p * u.e)``-weighted score, ``[B]``."""
    sims = torch.einsum("bkd,bd->bk", interests, target_e)
    att = torch.softmax(cfg.pow_p * sims, dim=-1)
    return (att * sims).sum(dim=-1)


def loss_fn(cfg: MINDConfig, params, batch) -> torch.Tensor:
    """Sampled softmax: the target against ``n_negatives`` sampled items a
    row (in-batch negatives would build a ``[B, K, B]`` tensor).

    batch: ``hist [B, H]``, ``hist_mask [B, H]``, ``target [B]``, ``neg [B,
    n_negatives]``."""
    dt = cfg.compute_dtype
    interests = user_interests(cfg, params, batch["hist"],
                               batch["hist_mask"])
    cand = torch.cat([batch["target"][:, None], batch["neg"]], dim=1)
    ce = E.item_lookup(params["item_embed"]["table"], cand, dt)  # [B, C, d]
    sims = torch.einsum("bkd,bcd->bkc", interests, ce)           # [B, K, C]
    att = torch.softmax(cfg.pow_p * sims, dim=1)
    scores = (att * sims).sum(dim=1)                             # [B, C]
    labels = torch.zeros((scores.shape[0],), dtype=torch.int32,
                         device=scores.device)   # the target at column 0
    return L.softmax_cross_entropy(scores, labels)


def retrieval_scores(cfg: MINDConfig, params, batch) -> torch.Tensor:
    """One user against ``n_candidates``: the max over interests (the
    paper's serving rule).

    batch: ``hist [1, H]``, ``hist_mask [1, H]``, ``candidates int32
    [n_cand]`` -> ``[n_cand]``."""
    interests = user_interests(cfg, params, batch["hist"],
                               batch["hist_mask"])
    cand = E.item_lookup(params["item_embed"]["table"], batch["candidates"],
                         interests.dtype)                       # [n_cand, d]
    sims = torch.einsum("kd,cd->kc", interests[0], cand)
    return sims.amax(dim=0)
