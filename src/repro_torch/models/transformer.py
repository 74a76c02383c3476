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
parameters are f32, cast to ``compute_dtype`` at use.

With ``moe`` set, each layer's FFN is the reference's capacity-based
mixture of experts (``_moe_ffn``): the router ``router.w [n, d, E]``,
the expert stacks ``w_gate``/``w_up [n, E * split, d, ff / split]`` and
``w_down [n, E * split, ff / split, d]`` (``split = ep_split`` virtual
experts a real one, each a slice of its ff axis).  ``forward`` returns the
layers' summed load-balancing loss and ``loss_fn`` adds it.  The
expert-parallel form (``_moe_ffn_shardmap``, the reference's ``shard_map``
dispatch) runs on a :class:`~repro_torch.distributed.mesh.ShardMesh`
given as ``mesh=`` to ``forward``, ``loss_fn`` and ``decode_step``; it
takes the place of the reference's ``act_shard.mesh``.  The same calls
take a :class:`~repro_torch.distributed.mesh.RankMesh` (one shard a
process): each rank then holds its blocks of the expert stacks
(``sharding.rank_param_specs``) and runs the dense layers on the whole
batch, as the stacked mesh does, and the backward through the mesh's
differentiable collectives gives every rank the stacked mesh's gradients
of its blocks.

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
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, seeded_generator
from repro_torch.distributed import sharding
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


def init(cfg: TransformerConfig, seed: int = 0, *, device="cuda",
         experts_fn=None) -> Dict[str, Any]:
    """Random f32 parameters from ``seed``, made on ``device``, in the
    reference's tree (layers stacked on a leading ``n_layers`` axis).
    ``experts_fn(name, stack)`` is applied to each MoE expert stack as it
    is drawn (``"w_gate"``, ``"w_up"``, ``"w_down"``; a rank keeps its
    block), so no more than one whole stack is held at a time."""
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
    }
    if cfg.moe:
        e = cfg.moe.n_experts * cfg.moe.ep_split
        ffs = cfg.d_ff // cfg.moe.ep_split

        def experts(name, a, b):    # [n, E * split, a, b] of N(0, 1) / sqrt(a)
            w = torch.randn((n, e, a, b), generator=gen,
                            dtype=torch.float32,
                            device=gen.device).div_(math.sqrt(a))
            return w if experts_fn is None else experts_fn(name, w)

        layers.update(router=_stacked_dense(gen, n, d, cfg.moe.n_experts),
                      w_gate=experts("w_gate", d, ffs),
                      w_up=experts("w_up", d, ffs),
                      w_down=experts("w_down", ffs, d))
    else:
        layers.update(w_gate=_stacked_dense(gen, n, d, cfg.d_ff),
                      w_up=_stacked_dense(gen, n, d, cfg.d_ff),
                      w_down=_stacked_dense(gen, n, cfg.d_ff, d))
    return {
        "embed": L.embedding_init(gen, cfg.vocab, d),
        "layers": layers,
        "ln_final": L.rmsnorm_init(d, dev),
        "lm_head": L.dense_init(gen, d, cfg.vocab),
    }


def _unbound(layers, n: int) -> List[Dict[str, Any]]:
    """Every layer's parameters (views), each stacked leaf ``unbind``-ed
    once (its backward stacks the ``n`` slices' gradients in one
    tensor).  A leaf is a tensor (the MoE expert stacks) or a dict of
    them (``w``, ``b``, ``scale``)."""
    def split(p):
        return ({k: split(v) for k, v in p.items()} if isinstance(p, dict)
                else p.unbind(0))

    def pick(p, i):
        return ({k: pick(v, i) for k, v in p.items()} if isinstance(p, dict)
                else p[i])

    parts = split(layers)
    return [pick(parts, i) for i in range(n)]


# ---------------------------------------------------------------------------
# MoE ffn
# ---------------------------------------------------------------------------

class MoERoute(NamedTuple):
    """One batch's routing, the reference's ``_moe_ffn`` up to its
    dispatch.  The ``T * k * split`` slots (token, rank, virtual expert)
    are in the order of a stable sort by virtual expert, as the
    reference's ``argsort(flat_e, stable=True)`` leaves them."""
    top_e: torch.Tensor     # int64 [T, k]: experts by gate, lower first on ties
    se: torch.Tensor        # int64 [T * kv]: each slot's virtual expert
    stok: torch.Tensor      # int64 [T * kv]: each slot's token
    sw: torch.Tensor        # f32 [T * kv]: each slot's normalised gate
    pos: torch.Tensor       # int64 [T * kv]: its place in its expert's queue
    keep: torch.Tensor      # bool [T * kv]: pos < cap
    starts: torch.Tensor    # int64 [E * split]: each expert's first slot
    counts: torch.Tensor    # int64 [E * split]: slots routed to each
    cap: int
    aux: Optional[torch.Tensor]   # f32 []: the load-balancing loss


@functools.lru_cache(maxsize=16)
def _sequential_folds(n: int, c_bits: int, device: str) -> torch.Tensor:
    """``f32[n + 1]``: ``i`` adds of ``f32(c)`` into an f32 zero, one at a
    time, at index ``i`` (``c_bits``: ``c``'s f32 bits).  The reference's
    ``ce`` adds ``1 / (t k)`` once a slot with XLA's scatter, so an
    expert's share is this fold at its count, not the count times ``c``.
    Made on the host and copied to ``device`` at the first use of each
    ``n`` (a token count), then kept, the last 16 of them: a step reads
    nothing back, but a CUDA-graph capture of a forward needs one run at
    its token count first.  ``decode_step`` computes no aux and never
    comes here."""
    folds = np.zeros(n + 1, np.float32)
    c = np.array([c_bits], np.int32).view(np.float32)[0]
    np.cumsum(np.full(n, c, np.float32), dtype=np.float32, out=folds[1:])
    return torch.from_numpy(folds).to(device)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the lower index first on
    ties (a stable descending sort; ``torch.topk`` does not promise it)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _moe_route(moe: MoEConfig, router_w: torch.Tensor, x: torch.Tensor,
               with_aux: bool = True) -> MoERoute:
    """Route ``x [T, d]``: f32 router logits, softmax gates, the top ``k``
    experts a token with their gates normalised, the Switch aux loss
    ``w * E * sum_e f_e * P_e`` (``None`` unless ``with_aux``), then each selected expert's ``split``
    virtual experts sorted stably by virtual expert, each slot's place in
    its expert's queue and whether it is within the capacity ``cap``.
    Integer work only past the gates, with static shapes and no host read
    (searchsorted over the sorted experts in place of counts and a
    cumsum)."""
    t = x.shape[0]
    e_real, k, split = moe.n_experts, moe.top_k, moe.ep_split
    e_virt, kv = e_real * split, k * split
    cap = max(int(t * kv * moe.capacity_factor / e_virt), 1)
    gates = torch.softmax(x.float() @ router_w, dim=-1)          # [T, E]
    top_g, top_e = _top_k(gates, k)                              # [T, k]
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

    flat_e = (top_e[:, :, None] * split + torch.arange(
        split, device=x.device)).reshape(-1)                     # [T * kv]
    se, order = torch.sort(flat_e, stable=True)
    stok = torch.div(order, kv, rounding_mode="floor")
    sw = top_g.reshape(-1)[torch.div(order, split, rounding_mode="floor")]
    experts = torch.arange(e_virt, device=x.device)
    starts = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - starts
    pos = torch.arange(t * kv, device=x.device) - torch.searchsorted(se, se)
    keep = pos < cap

    aux = None
    if with_aux:
        me = gates.mean(dim=0)
        c_bits = int(np.float32(1.0 / (t * k)).view(np.int32))
        ce = _sequential_folds(t * k, c_bits, str(x.device))[
            counts.reshape(e_real, split)[:, 0]]
        aux = moe.aux_loss_weight * e_real * torch.sum(me * ce)
    return MoERoute(top_e, se, stok, sw, pos, keep, starts, counts, cap, aux)


def _moe_dispatch(r: MoERoute, xt: torch.Tensor) -> torch.Tensor:
    """``[E * split, cap, d]``: each expert's queue of token rows, zero past
    its count.  A gather of slot ``starts[e] + c`` for place ``c``: the
    reference's scatter has one writer a place (its dropped slots add
    zeros at ``cap - 1``), so this is its buffer, bit for bit, with no
    scatter."""
    n_slots = r.se.shape[0]
    c = torch.arange(r.cap, device=xt.device)
    slot = torch.clamp(r.starts[:, None] + c, max=n_slots - 1)
    rows = xt[r.stok[slot]]                                      # [E, cap, d]
    return torch.where((c < r.counts[:, None])[..., None], rows,
                       torch.zeros((), dtype=xt.dtype, device=xt.device))


def _moe_experts(cfg: TransformerConfig, buf: torch.Tensor, wg, wu,
                 wd) -> torch.Tensor:
    """The experts' SwiGLU on their queues: ``[e, cap, d] -> [e, cap, d]``,
    the weights cast to the compute dtype at use (plain batched matrix
    products, as the reference's einsums)."""
    dt = cfg.compute_dtype
    h = _silu(torch.bmm(buf, wg.to(dt))) * torch.bmm(buf, wu.to(dt))
    return torch.bmm(h, wd.to(dt))


def _moe_combine(r: MoERoute, out_buf: torch.Tensor, t: int) -> torch.Tensor:
    """``[T, d]``: each token's kept slots' expert outputs weighted by
    ``keep * gate`` (cast to the compute dtype before the product), summed
    as the reference's scatter-add sums them: into a zero row, in slot
    order (ascending virtual expert, the sorted order), rounding to the
    compute dtype after each add.  A short loop over the ``k * split``
    columns; no atomics, so two runs give the same bytes."""
    kv = r.se.shape[0] // t
    pos_c = torch.clamp(r.pos, max=r.cap - 1)
    tok_out = out_buf[r.se, pos_c] * (
        r.keep.float() * r.sw).to(out_buf.dtype)[:, None]        # sorted
    # token i's slots, in sorted order: a stable sort of the slots' tokens
    cols = torch.argsort(r.stok, stable=True).reshape(t, kv)
    out = torch.zeros((t, out_buf.shape[-1]), dtype=out_buf.dtype,
                      device=out_buf.device)
    for i in range(kv):
        out = out + tok_out[cols[:, i]]
    return out


def _moe_ffn(cfg: TransformerConfig, p, x: torch.Tensor,
             with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[T, d]`` -> (``[T, d]`` in the compute dtype, aux loss or
    ``None``): the reference's capacity-based sort dispatch on one
    device."""
    r = _moe_route(cfg.moe, p["router"]["w"], x, with_aux)
    buf = _moe_dispatch(r, x.to(cfg.compute_dtype))
    out_buf = _moe_experts(cfg, buf, p["w_gate"], p["w_up"], p["w_down"])
    return _moe_combine(r, out_buf, x.shape[0]), r.aux


# the expert stacks' specs in a layer: the stacked leaves' minus the lead
_EXPERT_SPECS = {name: tuple(sharding.lm_leaf_spec(f"layers/{name}", 4))[1:]
                 for name in ("w_gate", "w_up", "w_down")}


def _moe_ffn_shardmap(cfg: TransformerConfig, p, x: torch.Tensor, mesh,
                      with_aux: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel MoE (its ``shard_map`` dispatch) on
    ``mesh``: tokens split over ``data`` (replicated where ``T`` is below
    or not a multiple of it, as at a one-token decode), each data shard
    routing and dispatching its own tokens with a capacity from its own
    count; the experts' weights laid out by ``sharding``'s specs (virtual
    experts over ``model``, the d axis over ``data``) and all-gathered
    over ``data``, each model shard running its ``E * split / model``
    experts on its queues; the partial token outputs summed over
    ``model`` and the aux loss averaged over ``data``.

    The loops run over the shards this process holds: every one of a
    stacked ``ShardMesh`` (``p``'s expert stacks whole), one of a
    ``RankMesh`` (``p``'s expert stacks the rank's blocks
    ``[e_local, d / data, ffs]``; ``x`` whole on every rank, and the
    output whole).  On a rank the mesh's differentiable collectives give
    the stacked gradients: the router's summed over ``data`` (each data
    shard routes once, whichever model shards use the routing), the
    gates' and the dispatch buffer's cotangents gathered over ``model``
    (each model shard's combine and experts see only their own experts),
    the experts' summed over ``data``, and ``x``'s gathered over
    ``data`` as the output is."""
    moe = cfg.moe
    e_virt = moe.n_experts * moe.ep_split
    if e_virt % mesh.model:
        raise ValueError(f"{e_virt} virtual experts do not split over "
                         f"{mesh.model} model shards")
    e_local = e_virt // mesh.model
    t, d = x.shape
    split_tokens = t % mesh.data == 0 and t >= mesh.data
    if split_tokens:                       # [local data, t / data, d]
        xb = mesh.split_axis(x, "data", 0)
    else:
        xb = mesh.pvary(x, "data").expand(len(mesh.local_data), t, d)
    router = mesh.pvary(p["router"]["w"], "data")
    # [local data, local model, e_local, d, ffs] (w_down: [..., ffs, d])
    # a rank holds its block of each stack, a stacked mesh the whole
    rank = sharding.is_rank_mesh(mesh)
    w = {name: mesh.all_gather_axis(
             p[name][None, None] if rank
             else sharding.shard(p[name], _EXPERT_SPECS[name], mesh),
             "data", dim=_EXPERT_SPECS[name].index("data"))
         for name in _EXPERT_SPECS}
    parts, auxes = [], []
    for i in range(len(mesh.local_data)):
        r = _moe_route(moe, router, xb[i], with_aux)
        r = r._replace(sw=mesh.pvary(r.sw, "model"))
        buf = _moe_dispatch(r, xb[i].to(cfg.compute_dtype))
        mine = mesh.split_axis(buf, "model", 0)   # [local model, e_local, ...]
        row = []
        for j, m in enumerate(mesh.local_model):
            full = torch.zeros_like(buf)
            full[m * e_local:(m + 1) * e_local] = _moe_experts(
                cfg, mine[j], w["w_gate"][i, j], w["w_up"][i, j],
                w["w_down"][i, j])
            row.append(_moe_combine(r, full, xb.shape[1]))
        parts.append(torch.stack(row))
        if with_aux:
            auxes.append(r.aux.expand(len(mesh.local_model)))
    out = mesh.psum_axis(torch.stack(parts), "model")[:, 0]   # [data, t_l, d]
    y = (mesh.concat_axis(out, "data", 0) if split_tokens
         else mesh.from_first(out, "data"))
    if not with_aux:
        return y, None
    return y, mesh.pmean_axis(torch.stack(auxes), "data")[0, 0]


def _ffn(cfg: TransformerConfig, p, x: torch.Tensor, mesh=None,
         with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN of ``x [B, S, d]``: ``(y [B, S, d], aux)``, the
    dense SwiGLU with an f32 zero, or the MoE (``mesh``: its
    expert-parallel form on that mesh; aux ``None`` unless
    ``with_aux``)."""
    if not cfg.moe:
        return _dense_ffn(cfg, p, x), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    b, s, d = x.shape
    moe_fn = _moe_ffn if mesh is None else functools.partial(
        _moe_ffn_shardmap, mesh=mesh)
    y, aux = moe_fn(cfg, p, x.reshape(b * s, d), with_aux=with_aux)
    return y.reshape(b, s, d), aux


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


def _layer_body(cfg: TransformerConfig, h: torch.Tensor, p,
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    h = h + _attn(cfg, p, L.rmsnorm_apply(p["ln_attn"], h))
    y, aux = _ffn(cfg, p, L.rmsnorm_apply(p["ln_ffn"], h), mesh)
    return h + y, aux


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, *,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (hidden ``[B, S, d]`` in the compute dtype,
    aux loss: the layers' MoE losses summed, an f32 zero without MoE).
    ``mesh``: a ``ShardMesh`` or ``RankMesh`` that runs the MoE
    expert-parallel."""
    h = L.embedding_apply(params["embed"], tokens,
                          compute_dtype=cfg.compute_dtype)
    body = functools.partial(_layer_body, cfg, mesh=mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for p in _unbound(params["layers"], cfg.n_layers):
        h, aux = checkpoint(body, h, p, use_reentrant=False) if remat \
            else body(h, p)
        auxes.append(aux)
    h = L.rmsnorm_apply(params["ln_final"], h)
    return h, torch.stack(auxes).sum()


def loss_fn(cfg: TransformerConfig, params, batch, *,
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy ``(loss, {"ce", "aux"})`` of ``tokens``,
    ``labels`` (int32) and ``mask`` (f32), each ``[B, S]``.  With
    ``loss_chunk`` dividing S, the logits are made ``loss_chunk`` positions
    at a time and each chunk is recomputed in the backward (the
    reference's checkpointed scan), so no ``[B, S, V]`` buffer is kept."""
    h, aux = forward(cfg, params, batch["tokens"], mesh=mesh)
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
                tokens: torch.Tensor, *, mesh=None):
    """One decode step. tokens ``[B, 1]`` -> (logits ``[B, 1, V]``, the
    cache with ``length + 1``).

    Each layer writes its new K/V into ``cache``'s tensors in place at
    position ``length`` (the last slot where ``length`` is past it) and
    attends to positions ``< length + 1``; the returned cache shares them.
    A MoE layer routes the ``B`` tokens as one batch (``mesh``: on that
    mesh); the aux loss, which the reference computes and drops,
    is not computed, so a step makes no host copy at any batch size.
    """
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
        h = h + _ffn(cfg, p, L.rmsnorm_apply(p["ln_ffn"], h), mesh,
                     with_aux=False)[0]
    h = L.rmsnorm_apply(params["ln_final"], h)
    logits = L.dense_apply(params["lm_head"], h, compute_dtype=dt)
    return logits, {**cache, "length": length + 1}
