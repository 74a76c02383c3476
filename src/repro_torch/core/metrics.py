"""Accuracy metrics: RAG@k (paper Section 4.2) and friends, on dense
``[Q, n]`` rows (``repro.core.metrics``).  Top-k sets follow
``jax.lax.top_k``'s tie order (``frontier.topk_dense``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.frontier import topk_dense


def rag_at_k(exact: torch.Tensor, approx: torch.Tensor, k: int
             ) -> torch.Tensor:
    """Relative Aggregated Goodness per row: the exact mass of the
    approximate top-k set over the exact mass of the exact top-k set,
    ``f32[Q]`` in [0, 1]."""
    _, approx_top = topk_dense(approx, k)
    exact_topv, _ = topk_dense(exact, k)
    num = torch.gather(exact, 1, approx_top.long()).sum(dim=1)
    return num / torch.clamp(exact_topv.sum(dim=1), min=1e-30)


def mean_rag(exact, approx, k: int) -> float:
    return float(rag_at_k(exact, approx, k).mean())


def l1_error(exact: torch.Tensor, approx: torch.Tensor) -> torch.Tensor:
    return (exact - approx).abs().sum(dim=-1)


def linf_error(exact: torch.Tensor, approx: torch.Tensor) -> torch.Tensor:
    return (exact - approx).abs().amax(dim=-1)


def precision_at_k(exact: torch.Tensor, approx: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """``|top_k(exact) & top_k(approx)| / k`` per row."""
    _, et = topk_dense(exact, k)
    _, at = topk_dense(approx, k)
    hit = (et[:, :, None] == at[:, None, :]).any(dim=-1)
    return hit.to(torch.float32).mean(dim=-1)


def is_stochastic(p, atol: float = 1e-4) -> np.ndarray:
    """Row-wise check that ``p`` is a probability vector (host numpy)."""
    p = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    return (p >= -atol).all(axis=-1) & (
        np.abs(p.sum(axis=-1) - 1.0) <= atol * max(p.shape[-1], 1))
