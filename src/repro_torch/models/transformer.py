"""Decoder-only transformer LM: GQA + RoPE + SwiGLU (the reference's
``models/transformer.py``).

``forward`` is the prefill (every position of a ``[B, S]`` batch at
once); ``loss_fn`` is the next-token cross-entropy of training (the
logits whole, or ``loss_chunk`` positions at a time, each chunk's logits
recomputed in the backward); ``init_cache`` and ``decode_step`` are the
KV-cache decode, with
the reference's int8 cache (``kv_quant``: per-token, per-head bf16
scales).  Parameters keep the reference's tree: ``embed.table``,
``layers.{ln_attn, ln_ffn, wq, wk, wv, wo, w_gate, w_up, w_down}`` stacked
with a leading ``n_layers`` axis, ``ln_final`` and ``lm_head``, so a plain
tree copy (``convert.params_from_arrays``) carries the reference's
parameters across.  The reference's ``lax.scan`` over the stacked layers
is a Python loop over their slices here (``unbind``, so the backward
stacks each leaf's layer gradients once); with ``remat`` (the
reference's default) each layer body runs under
``torch.utils.checkpoint`` when grad mode is on, so the backward keeps
only each layer's input and recomputes the rest.

Every token lookup is one ``embedding_bag`` launch
(``layers.embedding_apply``); the attention is the plain PyTorch of
``models/attention.py``, whose rounding is the reference's.  The
reference's config fields that only steer XLA's lowering (``act_shard``,
``precast_params``) are not carried; ``param_dtype`` neither:
parameters are f32, cast to ``compute_dtype`` at use.  The MoE FFN is not
ported: ``moe`` stays a field, and ``init``, ``forward``, ``loss_fn`` and
``decode_step`` raise when it is set.

``decode_step`` writes the new K/V into the cache's tensors in place (the
reference's ``dynamic_update_slice`` copies the whole cache) at
``length`` clamped to the last slot, as that slice clamps its start; it
reads nothing back to the host, so a step can be captured in a CUDA
graph.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.models import layers as L
from repro_torch.models.attention import chunked_attention, decode_attention


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    ep_split: int = 1          # virtual experts per expert (ff-dim split)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    compute_dtype: Any = torch.bfloat16
    attn_chunk: int = 1024
    loss_chunk: int = 0        # 0 = unchunked
    remat: bool = True         # recompute each layer body in the backward
    # int8 KV cache (per-token, per-head dynamic scales)
    kv_quant: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
        if self.moe:
            ffn = self.moe.n_experts * (2 * d * ff + ff * d) + d * self.moe.n_experts
        else:
            ffn = 2 * d * ff + ff * d
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        full_ffn = self.moe.n_experts * 3 * d * ff
        active_ffn = self.moe.top_k * 3 * d * ff
        return self.param_count() - self.n_layers * (full_ffn - active_ffn)


def _no_moe(cfg: TransformerConfig, what: str) -> None:
    if cfg.moe:
        raise NotImplementedError(
            f"{what}: the MoE FFN is not ported; it comes with the MoE archs "
            "on the multi-GPU mesh")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked_dense(gen: torch.Generator, n: int, d_in: int, d_out: int, *,
                   bias: bool = False) -> Dict[str, torch.Tensor]:
    """``n`` layers of ``layers.dense_init``: ``w [n, d_in, d_out]`` of
    ``N(0, 1) / sqrt(d_in)`` and ``b [n, d_out]`` zeros where ``bias``."""
    w = torch.randn((n, d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device).div_(math.sqrt(d_in))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((n, d_out), dtype=torch.float32,
                             device=gen.device)
    return p


def init(cfg: TransformerConfig, seed: int = 0, *,
         device="cuda") -> Dict[str, Any]:
    """Random f32 parameters from ``seed``, made on ``device``, in the
    reference's tree (layers stacked on a leading ``n_layers`` axis)."""
    _no_moe(cfg, "init")
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    qkv = dict(bias=cfg.qkv_bias)

    def norm():
        return {"scale": torch.ones((n, d), dtype=torch.float32, device=dev)}

    layers = {
        "ln_attn": norm(),
        "ln_ffn": norm(),
        "wq": _stacked_dense(gen, n, d, cfg.n_heads * hd, **qkv),
        "wk": _stacked_dense(gen, n, d, cfg.n_kv_heads * hd, **qkv),
        "wv": _stacked_dense(gen, n, d, cfg.n_kv_heads * hd, **qkv),
        "wo": _stacked_dense(gen, n, cfg.n_heads * hd, d),
        "w_gate": _stacked_dense(gen, n, d, cfg.d_ff),
        "w_up": _stacked_dense(gen, n, d, cfg.d_ff),
        "w_down": _stacked_dense(gen, n, cfg.d_ff, d),
    }
    return {
        "embed": L.embedding_init(gen, cfg.vocab, d),
        "layers": layers,
        "ln_final": L.rmsnorm_init(d, dev),
        "lm_head": L.dense_init(gen, d, cfg.vocab),
    }


def _unbound(layers, n: int) -> List[Dict[str, Any]]:
    """Every layer's parameters (views), each stacked leaf ``unbind``-ed
    once (its backward stacks the ``n`` slices' gradients in one
    tensor)."""
    parts = {name: {k: v.unbind(0) for k, v in p.items()}
             for name, p in layers.items()}
    return [{name: {k: v[i] for k, v in p.items()}
             for name, p in parts.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# layer + forward
# ---------------------------------------------------------------------------

def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    step rounded to ``x``'s dtype: the reference's ``jax.nn.silu`` as XLA
    expands its logistic.  ``F.silu`` rounds once, from f32, and so
    gives other bf16 values."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _dense_ffn(cfg: TransformerConfig, p, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    g = _silu(L.dense_apply(p["w_gate"], x, compute_dtype=dt))
    u = L.dense_apply(p["w_up"], x, compute_dtype=dt)
    return L.dense_apply(p["w_down"], g * u, compute_dtype=dt)


def _qkv(cfg: TransformerConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """The roped ``q [B, S, H, hd]`` and ``k``, and ``v [B, S, Hkv, hd]``
    of ``x [B, S, d]`` at ``positions [B, S]``."""
    b, s, _ = x.shape
    dt, hd = cfg.compute_dtype, cfg.hd
    q = L.dense_apply(p["wq"], x, compute_dtype=dt).reshape(
        b, s, cfg.n_heads, hd)
    k = L.dense_apply(p["wk"], x, compute_dtype=dt).reshape(
        b, s, cfg.n_kv_heads, hd)
    v = L.dense_apply(p["wv"], x, compute_dtype=dt).reshape(
        b, s, cfg.n_kv_heads, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn(cfg: TransformerConfig, p, h: torch.Tensor) -> torch.Tensor:
    b, s, _ = h.shape
    pos = torch.arange(s, device=h.device).expand(b, s)
    q, k, v = _qkv(cfg, p, h, pos)
    o = chunked_attention(q, k, v, n_kv_heads=cfg.n_kv_heads, causal=True,
                          chunk=cfg.attn_chunk)
    return L.dense_apply(p["wo"], o.reshape(b, s, cfg.n_heads * cfg.hd),
                         compute_dtype=cfg.compute_dtype)


def _layer_body(cfg: TransformerConfig, h: torch.Tensor, p) -> torch.Tensor:
    h = h + _attn(cfg, p, L.rmsnorm_apply(p["ln_attn"], h))
    return h + _dense_ffn(cfg, p, L.rmsnorm_apply(p["ln_ffn"], h))


def forward(cfg: TransformerConfig, params,
            tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (hidden ``[B, S, d]`` in the compute dtype,
    aux loss: an f32 zero without MoE)."""
    _no_moe(cfg, "forward")
    h = L.embedding_apply(params["embed"], tokens,
                          compute_dtype=cfg.compute_dtype)
    body = functools.partial(_layer_body, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _unbound(params["layers"], cfg.n_layers):
        h = checkpoint(body, h, p, use_reentrant=False) if remat \
            else body(h, p)
    h = L.rmsnorm_apply(params["ln_final"], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: TransformerConfig, params,
            batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy ``(loss, {"ce", "aux"})`` of ``tokens``,
    ``labels`` (int32) and ``mask`` (f32), each ``[B, S]``.  With
    ``loss_chunk`` dividing S, the logits are made ``loss_chunk`` positions
    at a time and each chunk is recomputed in the backward (the
    reference's checkpointed scan), so no ``[B, S, V]`` buffer is kept."""
    h, aux = forward(cfg, params, batch["tokens"])
    head = params["lm_head"]
    labels, mask = batch["labels"], batch["mask"]
    dt = cfg.compute_dtype
    if cfg.loss_chunk and h.shape[1] % cfg.loss_chunk == 0:
        b, s, d = h.shape
        nc = s // cfg.loss_chunk
        hc = h.reshape(b, nc, cfg.loss_chunk, d).transpose(0, 1)
        lc = labels.reshape(b, nc, cfg.loss_chunk).transpose(0, 1)
        mc = mask.reshape(b, nc, cfg.loss_chunk).transpose(0, 1)

        def chunk_nll(hx, lx, mx):
            logits32 = L.dense_apply(head, hx, compute_dtype=dt).float()
            logz = torch.logsumexp(logits32, dim=-1)
            gold = torch.gather(logits32, -1, lx[..., None].long())[..., 0]
            return ((logz - gold) * mx).sum(), mx.sum()

        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(nc):
            t, c = checkpoint(chunk_nll, hc[i], lc[i], mc[i],
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + c
        ce = tot / torch.clamp(cnt, min=1.0)
    else:
        logits = L.dense_apply(head, h, compute_dtype=dt)
        ce = L.softmax_cross_entropy(logits, labels, mask)
    loss = ce + aux
    return loss, dict(ce=ce, aux=aux)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device="cuda") -> Dict[str, torch.Tensor]:
    """An empty cache on ``device``: ``k``/``v [layers, batch, max_seq,
    kv_heads, head_dim]`` of ``dtype`` (int8 with ``k_scale``/``v_scale``
    ``bf16 [layers, batch, max_seq, kv_heads]`` under ``kv_quant``) and
    ``length``, an int32 scalar."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=dev)  # noqa: E731
    cache = {"length": zeros((), torch.int32)}
    if cfg.kv_quant:
        cache.update(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                     k_scale=zeros(shape[:-1], torch.bfloat16),
                     v_scale=zeros(shape[:-1], torch.bfloat16))
    else:
        cache.update(k=zeros(shape, dtype), v=zeros(shape, dtype))
    return cache


def _quantize_kv(x: torch.Tensor):
    """[B, 1, H, hd] -> (int8 values, bf16 per-(token, head) scale); the
    rounding is half to even, as ``jnp.round``'s."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0].to(torch.bfloat16)


def decode_step(cfg: TransformerConfig, params, cache,
                tokens: torch.Tensor):
    """One decode step. tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the
    cache with ``length + 1``).

    Each layer writes its new K/V into ``cache``'s tensors in place at
    position ``length`` (the last slot where ``length`` is past it) and
    attends to positions ``< length + 1``; the returned cache shares them.
    """
    _no_moe(cfg, "decode_step")
    b = tokens.shape[0]
    dt, hd = cfg.compute_dtype, cfg.hd
    length = cache["length"]
    slot = torch.clamp(length, 0, cache["k"].shape[2] - 1).reshape(1).long()
    pos = length.expand(b, 1)
    h = L.embedding_apply(params["embed"], tokens, compute_dtype=dt)
    for i, p in enumerate(_unbound(params["layers"], cfg.n_layers)):
        q, k, v = _qkv(cfg, p, L.rmsnorm_apply(p["ln_attn"], h), pos)
        kc, vc = cache["k"][i], cache["v"][i]
        if cfg.kv_quant:
            ks, vs = cache["k_scale"][i], cache["v_scale"][i]
            for c, sc, x in ((kc, ks, k), (vc, vs, v)):
                xq, x_sc = _quantize_kv(x)
                c.index_copy_(1, slot, xq)
                sc.index_copy_(1, slot, x_sc)
            k_deq = kc.to(dt) * ks[..., None].to(dt)
            v_deq = vc.to(dt) * vs[..., None].to(dt)
        else:
            kc.index_copy_(1, slot, k.to(kc.dtype))
            vc.index_copy_(1, slot, v.to(vc.dtype))
            k_deq, v_deq = kc, vc
        o = decode_attention(q, k_deq, v_deq, length + 1,
                             n_kv_heads=cfg.n_kv_heads)
        h = h + L.dense_apply(p["wo"], o.reshape(b, 1, cfg.n_heads * hd),
                              compute_dtype=dt)
        h = h + _dense_ffn(cfg, p, L.rmsnorm_apply(p["ln_ffn"], h))
    h = L.rmsnorm_apply(params["ln_final"], h)
    logits = L.dense_apply(params["lm_head"], h, compute_dtype=dt)
    return logits, {**cache, "length": length + 1}
