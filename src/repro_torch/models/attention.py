"""GQA attention: chunked (flash-style) prefill path and KV-cache decode.

The counterpart of the reference's ``models/attention.py``, which has no
Pallas kernel: plain tensor ops here too.  The chunk loop is the
reference's online softmax over KV chunks, kept as a loop so peak memory
is ``O(Sq * chunk)``.  The arithmetic is the reference's: both products
accumulate in f32 from f32 operands (its ``preferred_element_type=
jnp.float32``; a torch bf16 product would return bf16), the probabilities
are rounded to ``q``'s dtype before the PV product, and the ``1 /
sqrt(hd)`` scale is rounded to ``q``'s dtype before it multiplies, as
JAX does with a Python scalar.  ``scaled_dot_product_attention`` rounds
elsewhere, so it is not used.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Decode cache. k/v: [layers, batch, max_seq, kv_heads, head_dim]."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # int32 [] tokens currently valid


def _scaled(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with ``c`` rounded to ``x``'s dtype first (JAX's weakly
    typed scalar), not carried in f32 as torch carries a Python float."""
    return x * torch.tensor(c, dtype=x.dtype)  # a CPU scalar: no copy


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, Sq, Hkv, G, hd]; k: [B, C, Hkv, hd] -> f32 [B, Hkv, G, Sq, C]."""
    return torch.einsum("bqhgd,bchd->bhgqc", q.float(), k.float())


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      n_kv_heads: int, causal: bool = True, chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention.

    q: [B, Sq, Hq, hd]; k, v: [B, Skv, Hkv, hd].  Returns [B, Sq, Hq, hd]
    in ``q``'s dtype; query ``i`` sits at position ``q_offset + i``.
    """
    b, sq, hq, hd = q.shape
    skv = k.shape[1]
    g = hq // n_kv_heads
    qg = _scaled(q.reshape(b, sq, n_kv_heads, g, hd), hd ** -0.5)
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"{skv} keys do not split into chunks of {chunk}")
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, n_kv_heads, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, n_kv_heads, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, skv, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = _gqa_scores(qg, kb)                          # f32
        if causal:
            k_pos = c0 + torch.arange(chunk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]      # [Sq, C]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        # probabilities in the compute dtype for the PV product (f32
        # accumulate), as the reference rounds them
        acc = acc * scale[..., None] + torch.einsum(
            "bhgqc,bchd->bhgqd", p.to(q.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_length: Union[int, torch.Tensor], *,
                     n_kv_heads: int) -> torch.Tensor:
    """One-token attention against the cache.

    q: [B, 1, Hq, hd]; k_cache/v_cache: [B, S, Hkv, hd]; positions >=
    ``cache_length`` are masked.
    """
    b, _, hq, hd = q.shape
    s = k_cache.shape[1]
    g = hq // n_kv_heads
    qg = _scaled(q.reshape(b, n_kv_heads, g, hd), hd ** -0.5)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float())
    valid = torch.arange(s, device=q.device)[None, :] < cache_length
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)
