"""Shared layers: plain functions over dicts of tensors, as in the reference.

Parameters stay f32 and are cast to the compute dtype at use.  A dense
weight keeps the reference's ``[d_in, d_out]`` layout (so ``y = x @ w``),
which lets ``convert.params_from_arrays`` carry the reference's
parameters across without a transpose.  Every ``*_init`` draws from a
``torch.Generator`` and makes its tensors on the generator's device.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels import ops


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None):
    """``w`` of ``N(0, 1) * scale`` (``N(0, 1) / sqrt(d_in)`` by default),
    and ``b`` zeros where ``bias``."""
    w = _randn(gen, (d_in, d_out))
    p = {"w": w / math.sqrt(d_in) if scale is None else w * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def dense_apply(p, x, *, compute_dtype=None):
    """``x @ w`` (``+ b`` where ``p`` has one), each operand cast to
    ``compute_dtype`` (``None``: ``x``'s dtype) first."""
    dt = compute_dtype or x.dtype
    y = x.to(dt) @ p["w"].to(dt)
    if "b" in p:
        y = y + p["b"].to(dt)
    return y


def embedding_init(gen: torch.Generator, vocab: int, dim: int):
    """The table ``[vocab, dim]`` of ``N(0, 1) * 0.02``."""
    return {"table": _randn(gen, (vocab, dim)).mul_(0.02)}  # in place


def embedding_apply(p, ids, *, compute_dtype=None):
    """``table[ids]`` (``[*ids.shape, dim]``) in ``compute_dtype`` (``None``:
    the table's dtype): one ``embedding_bag`` launch over bags of one with
    no mask, so each row is the table's row rounded once, as the
    reference's ``jnp.take`` of the cast table gives it; negative ids count
    from the end, ids outside ``[-V, V)`` give NaN rows."""
    table = p["table"]
    dt = compute_dtype or table.dtype
    rows = ops.embedding_bag(ids.reshape(-1, 1).to(torch.int32), None, table,
                             row_dtype=dt, out_dtype=dt)
    return rows.reshape(*ids.shape, table.shape[1])


def embedding_block_apply(p, ids, start: int, *, compute_dtype=None):
    """The rows of ``ids`` that a vocabulary block holds: ``p["table"]``
    is rows ``[start, start + Vb)`` of the whole table, and each id in them
    gets its row, every other id a zero row (``[*ids.shape, dim]`` in
    ``compute_dtype``).  One ``embedding_bag`` launch over bags of one,
    the ids outside masked to weight zero; the backward
    (``embedding_bag_backward``) gives the block's gradient, in which a
    masked slot adds nothing.  A row times one is the row, so the blocks'
    lookups summed over the vocabulary's shards are the whole table's
    bits (``embedding_apply``'s)."""
    table = p["table"]
    dt = compute_dtype or table.dtype
    local = ids.reshape(-1, 1).long() - start
    inside = (local >= 0) & (local < table.shape[0])
    rows = ops.embedding_bag(
        torch.where(inside, local, torch.zeros_like(local)).to(torch.int32),
        inside.to(torch.float32), table, row_dtype=dt, out_dtype=dt)
    return rows.reshape(*ids.shape, table.shape[1])


def vocab_parallel_nll(mesh, logits: Sequence[torch.Tensor],
                       labels: torch.Tensor,
                       starts: Sequence[int]) -> torch.Tensor:
    """The token NLL ``[...]`` of logits split over ``mesh``'s ``model``
    axis: ``logits`` holds each local model shard's f32 block ``[...,
    Vb]`` of the vocabulary, whose first id is the matching ``starts``
    entry, and ``labels`` the int ids ``[...]``.  The ``logsumexp`` is
    shifted by the largest logit over the shards (``pmax``, a constant to
    autograd, as the shift of ``torch.logsumexp``), its exponentials summed
    over the shards (``fan_in``); the gold logit comes from the block that
    holds the label, zeros from the others, summed likewise."""
    top = mesh.pmax([x.amax(dim=-1) for x in logits], "model")
    total = mesh.fan_in([torch.exp(x - top[..., None]).sum(dim=-1)
                         for x in logits], "model")
    golds = []
    for x, start in zip(logits, starts):
        local = labels.long() - start
        inside = (local >= 0) & (local < x.shape[-1])
        gold = torch.gather(x, -1, local.clamp(0, x.shape[-1] - 1)[..., None])
        golds.append(torch.where(inside, gold[..., 0],
                                 torch.zeros_like(gold[..., 0])))
    return top + torch.log(total) - mesh.fan_in(golds, "model")


def rmsnorm_init(dim: int, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    """RMS norm computed in f32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layernorm_apply(p, x, *, eps: float = 1e-5):
    """Layer norm (population variance, as ``jnp.var``) computed in f32,
    cast back to ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = centered.square().mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def mlp_init(gen: torch.Generator, dims: Sequence[int], *, bias: bool = True):
    """Plain MLP tower: ``layer_i`` maps ``dims[i] -> dims[i + 1]``."""
    return {f"layer_{i}": dense_init(gen, dims[i], dims[i + 1], bias=bias)
            for i in range(len(dims) - 1)}


def mlp_apply(p, x, *, act: Callable = torch.relu,
              final_act: Optional[Callable] = None, compute_dtype=None):
    """Dense layers with ``act`` between them and ``final_act`` (if any)
    after the last."""
    n = len(p)
    for i in range(n):
        x = dense_apply(p[f"layer_{i}"], x, compute_dtype=compute_dtype)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device="cpu") -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """``x [..., seq, heads, head_dim]``; ``positions`` broadcastable to
    ``[..., seq]``.  Rotates the two halves of each head in f32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs    # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token NLL of ``logits [..., V]`` at int ``labels [...]``
    (masked mean where ``mask`` is given)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def binary_cross_entropy(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``max(x, 0) - x * y + log1p(exp(-|x|))``, with the
    reference's gradients at x = 0: ``jnp.maximum`` splits a tie in half
    (as ``torch.maximum`` does, not ``clamp``) and ``jnp.abs`` has slope 1
    there (``torch.abs`` has 0)."""
    logits = logits.float()
    labels = labels.float()
    abs_x = torch.where(logits >= 0, logits, -logits)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * labels + torch.log1p(torch.exp(-abs_x)))
