"""Gradient compression with error feedback (the reference's
``distributed/compression.py``).

Casting gradients to bf16 (or int8 with a scale) halves (quarters) the
bytes of a gradient all-reduce; error feedback (Seide et al. 2014;
Karimireddy et al. 2019) keeps the quantization error in a residual and
adds it back the next step.  ``grads, residual = compress(cfg, grads,
residual)``; the returned gradients are what the receiving side would
reconstruct, so the optimizer sees the lossy collective's values.  Plug it
into ``train_loop.make_train_step``'s ``grad_transform``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    method: str = "bf16_ef"      # none | bf16 | bf16_ef | int8_ef
    int8_clip: float = 6.0        # standard deviations kept before int8 saturates


def init(params: Any) -> Any:
    """Error-feedback residuals: f32 zeros like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_bf16(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16).to(torch.float32)


def _quant_int8(g: torch.Tensor, clip_sigmas: float) -> torch.Tensor:
    sigma = torch.std(g, correction=0) + 1e-12      # jnp.std: population
    scale = clip_sigmas * sigma / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    return q * scale


def compress(cfg: CompressionConfig, grads: Any,
             residual: Any) -> Tuple[Any, Any]:
    """``(gradients after quantization, new residual)``."""
    if cfg.method == "none":
        return grads, residual

    def one(g, r):
        g32 = g.to(torch.float32)
        if cfg.method == "bf16":
            return _quant_bf16(g32), r
        if cfg.method == "bf16_ef":
            target = g32 + r
            q = _quant_bf16(target)
            return q, target - q
        if cfg.method == "int8_ef":
            target = g32 + r
            q = _quant_int8(target, cfg.int8_clip)
            return q, target - q
        raise ValueError(cfg.method)

    flat_g, treedef = tree_flatten(grads)
    pairs = [one(g, r) for g, r in zip(flat_g, tree_leaves(residual))]
    return (tree_unflatten(treedef, [p[0] for p in pairs]),
            tree_unflatten(treedef, [p[1] for p in pairs]))


def wire_bytes(grads: Any, cfg: CompressionConfig) -> int:
    """Bytes this gradient tree puts on the wire per all-reduce."""
    per = {"none": 4, "bf16": 2, "bf16_ef": 2, "int8_ef": 1}[cfg.method]
    return sum(x.numel() * per for x in tree_leaves(grads))
