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
layers' summed load-balancing loss and ``loss_fn`` adds it.

``forward``, ``loss_fn`` and ``decode_step`` take ``mesh=``, a
:class:`~repro_torch.distributed.mesh.ShardMesh` (every shard stacked in
one process) or a :class:`~repro_torch.distributed.mesh.RankMesh` (one
shard a process); it takes the place of the reference's ``act_shard``.
The parameters are laid out in the reference's 2-D layout
(``sharding.rank_param_specs``: on a rank each leaf is its block, on a
stacked mesh whole) and the batch's rows split over ``data``
(``sharding.batch_split``).  Each layer's dense blocks are all-gathered
over ``data`` before use (FSDP; the backward a reduce-scatter); the
attention runs each model shard's heads (``wq``/``wk``/``wv`` column
parallel, ``wo`` row parallel) and the dense FFN its ``d_ff`` columns,
their partial outputs summed over ``model``; the MoE runs expert
parallel (``_moe_ffn_mesh``, the reference's ``shard_map`` dispatch).
The token lookup and the loss are vocabulary parallel
(``layers.embedding_block_apply``, ``layers.vocab_parallel_nll``).  Both
meshes run the same loops over their local shards with the same blocks
and the same sums, and a rank's backward through the mesh's
differentiable collectives gives it the stacked mesh's gradients of its
blocks, bit for bit.  A small LM (``sharding.lm_is_small``: smollm-135m)
keeps every leaf whole on a mesh, as the reference does, and trains data
parallel (``data_parallel_loss_fn``).

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

from repro_torch.device import OnMeta, resolve_device, seeded_generator
from repro_torch.distributed import sharding
from repro_torch.models import layers as L
from repro_torch.models.attention import chunked_attention, decode_attention
from repro_torch.tree import tree_flatten, tree_unflatten


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
         keep=None) -> Dict[str, Any]:
    """Random f32 parameters from ``seed``, made on ``device``, in the
    reference's tree (layers stacked on a leading ``n_layers`` axis).
    ``keep(path, leaf)`` is applied to each leaf as it is drawn (its path
    in the tree, ``"layers/wq/w"``; a rank keeps its block,
    ``sharding.rank_block``), so no more than one whole leaf is held at a
    time and every leaf comes from the whole ``init``'s generator
    stream."""
    dev = resolve_device(device)
    gen = seeded_generator(dev, seed)
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    qkv = dict(bias=cfg.qkv_bias)
    if keep is None:
        def keep(path, leaf):
            return leaf

    def kept(path, tree):
        return {k: keep(f"{path}/{k}", v) for k, v in tree.items()}

    def norm(name):
        return kept(f"layers/{name}", {"scale": torch.ones(
            (n, d), dtype=torch.float32, device=dev)})

    def dense(name, d_in, d_out, **kw):
        return kept(f"layers/{name}", _stacked_dense(gen, n, d_in, d_out,
                                                      **kw))

    layers = {
        "ln_attn": norm("ln_attn"),
        "ln_ffn": norm("ln_ffn"),
        "wq": dense("wq", d, cfg.n_heads * hd, **qkv),
        "wk": dense("wk", d, cfg.n_kv_heads * hd, **qkv),
        "wv": dense("wv", d, cfg.n_kv_heads * hd, **qkv),
        "wo": dense("wo", cfg.n_heads * hd, d),
    }
    if cfg.moe:
        e = cfg.moe.n_experts * cfg.moe.ep_split
        ffs = cfg.d_ff // cfg.moe.ep_split

        def experts(name, a, b):    # [n, E * split, a, b] of N(0, 1) / sqrt(a)
            w = torch.randn((n, e, a, b), generator=gen,
                            dtype=torch.float32,
                            device=gen.device).div_(math.sqrt(a))
            return keep(f"layers/{name}", w)

        layers.update(router=dense("router", d, cfg.moe.n_experts),
                      w_gate=experts("w_gate", d, ffs),
                      w_up=experts("w_up", d, ffs),
                      w_down=experts("w_down", ffs, d))
    else:
        layers.update(w_gate=dense("w_gate", d, cfg.d_ff),
                      w_up=dense("w_up", d, cfg.d_ff),
                      w_down=dense("w_down", cfg.d_ff, d))
    return {
        "embed": kept("embed", L.embedding_init(gen, cfg.vocab, d)),
        "layers": layers,
        "ln_final": kept("ln_final", L.rmsnorm_init(d, dev)),
        "lm_head": kept("lm_head", L.dense_init(gen, d, cfg.vocab)),
    }


def param_specs(cfg: TransformerConfig, mesh) -> Dict[str, Any]:
    """``sharding.rank_param_specs`` of :func:`init`'s tree on ``mesh``, the
    tree made on meta (nothing is allocated)."""
    with OnMeta():
        tree = init(cfg, device="meta")
    return sharding.rank_param_specs(tree, cfg, mesh)


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


# ---------------------------------------------------------------------------
# the 2-D layout on a mesh
# ---------------------------------------------------------------------------

def _layer_spec(cfg: TransformerConfig, mesh, path: str, ndim: int):
    """The spec of one layer's slice of the stacked leaf ``layers/<path>``
    (its ``rank_leaf_spec`` without the layer axis)."""
    return tuple(sharding.rank_leaf_spec(f"layers/{path}", ndim + 1, cfg,
                                         mesh))[1:]


def _local(mesh, leaf: torch.Tensor, spec) -> List[List[torch.Tensor]]:
    """The weight each shard this process holds uses, ``[[w for each local
    model shard] for each local data shard]``: the shard's block of
    ``leaf`` under ``spec``, all-gathered over ``data`` where ``spec``
    splits it there (FSDP; the backward is a reduce-scatter).  ``leaf`` is
    a rank's block, or on a stacked mesh the whole.  Where ``spec`` leaves
    an axis whole, the shards' cotangents of the block are summed over
    that axis's group: over ``data`` first, then ``model``, on both
    meshes (a rank's ``pvary``; a stacked mesh's ``expand``, one axis at a
    time)."""
    used = {a for e in spec for a in sharding._entry_axes(e)}
    if sharding.is_rank_mesh(mesh):
        x = leaf[None, None]
        for axis in ("model", "data"):
            if axis not in used:
                x = mesh.pvary(x, axis)
    else:
        x = sharding.shard(leaf, spec, mesh)
        if "model" not in used:
            x = x[:, :1].expand(-1, mesh.model, *x.shape[2:])
        if "data" not in used:
            x = x[:1].expand(mesh.data, *x.shape[1:])
    if "data" in used:
        x = mesh.all_gather_axis(x, "data", dim=list(spec).index("data"))
    return [list(row.unbind(0)) for row in x.unbind(0)]


def _mesh_check(cfg: TransformerConfig, mesh) -> None:
    """Raise, naming the config, where its 2-D layout does not split
    whole over ``mesh``: the heads, a dense ``d_ff`` and the vocabulary
    over ``model``, ``d_model`` over ``data``, and each model shard's
    query heads over whole kv heads (the experts: ``_moe_ffn_mesh``)."""
    bad = []
    if cfg.n_heads % mesh.model:
        bad.append(f"{cfg.n_heads} heads over model = {mesh.model}")
    if cfg.vocab % mesh.model:
        bad.append(f"vocab {cfg.vocab} over model = {mesh.model}")
    if not cfg.moe and cfg.d_ff % mesh.model:
        bad.append(f"d_ff {cfg.d_ff} over model = {mesh.model}")
    if cfg.d_model % mesh.data:
        bad.append(f"d_model {cfg.d_model} over data = {mesh.data}")
    if not bad and not sharding.kv_heads_split(cfg, mesh):
        hl, g = cfg.n_heads // mesh.model, cfg.n_heads // cfg.n_kv_heads
        if hl % g and g % hl:
            bad.append(f"{hl} query heads a model shard over kv groups of "
                       f"{g}")
    if bad:
        raise ValueError(
            f"the LM (d_model {cfg.d_model}, {cfg.n_heads} heads, "
            f"{cfg.n_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab}) does not split on a {mesh.data} x {mesh.model} "
            f"mesh: {'; '.join(bad)} (the reference's GSPMD padding of "
            f"such dimensions is not ported)")


def _shard_heads(cfg: TransformerConfig, mesh, m: int):
    """``(heads, (first, count))``: model shard ``m``'s query heads, and the
    kv heads they read in its ``wk``/``wv`` weight (:func:`_qkv`'s
    arguments): the block's own where the kv heads split over ``model``,
    else a slice of the whole."""
    hl = cfg.n_heads // mesh.model
    if sharding.kv_heads_split(cfg, mesh):
        return hl, (0, cfg.n_kv_heads // mesh.model)
    g = cfg.n_heads // cfg.n_kv_heads
    return hl, (m * hl // g, max(hl // g, 1))


def _data_rows(mesh, x: torch.Tensor, split: bool) -> List[torch.Tensor]:
    """Each local data shard's rows of ``x``: its contiguous share where
    ``split`` (``sharding.batch_split``), else all of them (``fan_out``,
    whose backward sums the data shards' cotangents)."""
    if split:
        return list(mesh.split_axis(x, "data", 0).unbind(0))
    return mesh.fan_out(x, "data")


def _join_rows(mesh, parts: List[torch.Tensor], split: bool) -> torch.Tensor:
    """The whole from the local data shards' rows: joined in shard order
    where ``split``, else the first data shard's."""
    x = torch.stack(parts)
    return (mesh.concat_axis(x, "data", 0) if split
            else mesh.from_first(x, "data"))


# the expert stacks' specs in a layer: the stacked leaves' minus the lead
_EXPERT_SPECS = {name: tuple(sharding.lm_leaf_spec(f"layers/{name}", 4))[1:]
                 for name in ("w_gate", "w_up", "w_down")}


def _moe_ffn_mesh(cfg: TransformerConfig, p, xs: List[torch.Tensor], mesh,
                  with_aux: bool = True):
    """The reference's expert-parallel MoE (its ``shard_map`` dispatch) of
    each local data shard's tokens ``xs[i] [t, d]``: each data shard
    routes and dispatches its own tokens with a capacity from its own
    count; the experts' weights laid out by ``sharding``'s specs (virtual
    experts over ``model``, the d axis over ``data``) and all-gathered
    over ``data``, each model shard running its ``E * split / model``
    experts on its queues; the partial token outputs summed over
    ``model`` and the aux loss averaged over ``data``.  Returns ``(ys,
    aux)``: each local data shard's output ``[t, d]`` and the aux (``None``
    unless ``with_aux``).

    On a rank the mesh's differentiable collectives give the stacked
    gradients: the router's summed over ``data`` (each data shard routes
    once, whichever model shards use the routing), the gates' and the
    dispatch buffer's cotangents gathered over ``model`` (each model
    shard's combine and experts see only their own experts) and the
    experts' summed over ``data``."""
    moe = cfg.moe
    e_virt = moe.n_experts * moe.ep_split
    if e_virt % mesh.model:
        raise ValueError(f"{e_virt} virtual experts do not split over "
                         f"{mesh.model} model shards")
    e_local = e_virt // mesh.model
    router = mesh.fan_out(p["router"]["w"], "data")
    # each local shard's [e_local, d, ffs] (w_down: [..., ffs, d])
    w = {name: _local(mesh, p[name], _EXPERT_SPECS[name])
         for name in _EXPERT_SPECS}
    ys, auxes = [], []
    for i, x in enumerate(xs):
        r = _moe_route(moe, router[i], x, with_aux)
        r = r._replace(sw=mesh.pvary(r.sw, "model"))
        buf = _moe_dispatch(r, x.to(cfg.compute_dtype))
        mine = mesh.split_axis(buf, "model", 0)   # [local model, e_local, ...]
        row = []
        for j, m in enumerate(mesh.local_model):
            full = torch.zeros_like(buf)
            full[m * e_local:(m + 1) * e_local] = _moe_experts(
                cfg, mine[j], w["w_gate"][i][j], w["w_up"][i][j],
                w["w_down"][i][j])
            row.append(_moe_combine(r, full, x.shape[0]))
        ys.append(mesh.fan_in(row, "model"))
        if with_aux:
            auxes.append(r.aux)
    if not with_aux:
        return ys, None
    return ys, mesh.fan_in(auxes, "data") / mesh.data


def _moe_ffn_shardmap(cfg: TransformerConfig, p, x: torch.Tensor, mesh,
                      with_aux: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_moe_ffn_mesh` of the whole ``x [T, d]`` on ``mesh``: the
    tokens split over ``data`` (each data shard routing all of them where
    ``T`` is below or not a multiple of it, as at a one-token decode, and
    the output the first's), the output ``[T, d]`` whole.  ``p``'s expert
    stacks are a rank's blocks ``[e_local, d / data, ffs]`` on a
    ``RankMesh``, whole on a stacked ``ShardMesh``."""
    split = sharding.batch_split(x.shape[0], mesh)
    ys, aux = _moe_ffn_mesh(cfg, p, _data_rows(mesh, x, split), mesh,
                            with_aux)
    return _join_rows(mesh, ys, split), aux


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


def _qkv(cfg: TransformerConfig, p, x: torch.Tensor, positions: torch.Tensor,
         heads: Optional[int] = None, kv: Optional[Tuple[int, int]] = None):
    """The roped ``q [B, S, heads, hd]`` and ``k``, and ``v [B, S, count,
    hd]`` of ``x [B, S, d]`` at ``positions [B, S]``: ``wq`` holds
    ``heads`` query heads (all of them by default; a model shard's on a
    mesh), ``wk``/``wv`` the kv heads ``kv = (first, count)`` read from
    (the whole weight by default; on a mesh a slice of it where the kv
    heads do not split over ``model``)."""
    b, s, _ = x.shape
    dt, hd = cfg.compute_dtype, cfg.hd
    heads = heads or cfg.n_heads
    k0, kvl = kv or (0, cfg.n_kv_heads)

    def proj(name, first, count):
        w = p[name]
        if count * hd != w["w"].shape[-1]:
            w = {k: v[..., first * hd:(first + count) * hd]
                 for k, v in w.items()}
        return L.dense_apply(w, x, compute_dtype=dt).reshape(b, s, count, hd)

    q = L.apply_rope(proj("wq", 0, heads), positions, cfg.rope_theta)
    k = L.apply_rope(proj("wk", k0, kvl), positions, cfg.rope_theta)
    return q, k, proj("wv", k0, kvl)


def _attn(cfg: TransformerConfig, p, h: torch.Tensor,
          heads: Optional[int] = None,
          kv: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The causal attention of ``h [B, S, d]`` over :func:`_qkv`'s heads,
    through ``wo``'s rows of them: the whole output, or on a mesh a model
    shard's partial output, which the model shards' sum completes."""
    b, s, _ = h.shape
    pos = torch.arange(s, device=h.device).expand(b, s)
    q, k, v = _qkv(cfg, p, h, pos, heads, kv)
    o = chunked_attention(q, k, v, n_kv_heads=k.shape[2], causal=True,
                          chunk=cfg.attn_chunk)
    return L.dense_apply(p["wo"], o.reshape(b, s, q.shape[2] * cfg.hd),
                         compute_dtype=cfg.compute_dtype)


def _layer_body(cfg: TransformerConfig, h: torch.Tensor,
                p) -> Tuple[torch.Tensor, torch.Tensor]:
    h = h + _attn(cfg, p, L.rmsnorm_apply(p["ln_attn"], h))
    y, aux = _ffn(cfg, p, L.rmsnorm_apply(p["ln_ffn"], h))
    return h + y, aux


_ATTN = ("wq", "wk", "wv", "wo")
_DENSE_FFN = ("w_gate", "w_up", "w_down")


def _layer_weights(cfg: TransformerConfig, mesh, p, names):
    """``{name: {"w": [[...]], "b": [[...]]}}``: each local shard's weights
    (:func:`_local`) of the layer's dense leaves ``names``."""
    return {name: {k: _local(mesh, v, _layer_spec(cfg, mesh, f"{name}/{k}",
                                                  v.dim()))
                   for k, v in p[name].items()} for name in names}


def _shard_weights(ws, i: int, j: int):
    """Local shard ``(i, j)``'s entry of :func:`_layer_weights`."""
    return {name: {k: v[i][j] for k, v in leaf.items()}
            for name, leaf in ws.items()}


def _layer_mesh(cfg: TransformerConfig, mesh, split: bool,
                hs: List[torch.Tensor],
                p) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One layer on ``mesh`` of each local data shard's residual stream
    ``hs[i] [b, s, d]`` (the whole stream, alike on its model shards; the
    data shard's rows where ``split``, else all of them): the attention
    over each model shard's heads and the dense FFN over its ``d_ff``
    columns, each from weights gathered over ``data`` and its partial
    outputs summed over ``model``, or the expert-parallel MoE.  The norms'
    scales are used once a data shard (their cotangents summed over
    ``data``); each normed stream is fanned out to the model shards (its
    cotangents summed over ``model``).  Where the rows do not split but
    their tokens do, each data shard routes its contiguous block of the
    tokens, as the reference's ``shard_map`` splits them, and the blocks'
    outputs are joined and fanned out to every data shard's stream.
    Returns the new streams and the layer's aux (an f32 zero without
    MoE)."""
    ln_a = mesh.fan_out(p["ln_attn"]["scale"], "data")
    ln_f = mesh.fan_out(p["ln_ffn"]["scale"], "data")
    model = list(enumerate(mesh.local_model))
    ws = _layer_weights(cfg, mesh, p, _ATTN)
    out = []
    for i, h in enumerate(hs):
        xs = mesh.fan_out(L.rmsnorm_apply({"scale": ln_a[i]}, h), "model")
        out.append(h + mesh.fan_in(
            [_attn(cfg, _shard_weights(ws, i, j), xs[j],
                   *_shard_heads(cfg, mesh, m))
             for j, m in model], "model"))
    del ws
    xs = [L.rmsnorm_apply({"scale": ln_f[i]}, h) for i, h in enumerate(out)]
    if cfg.moe:
        flat = [x.reshape(-1, x.shape[-1]) for x in xs]
        if split or not sharding.batch_split(flat[0].shape[0], mesh):
            ys, aux = _moe_ffn_mesh(cfg, p, flat, mesh)
        else:
            ys, aux = _moe_ffn_mesh(cfg, p, [
                x.unflatten(0, (mesh.data, -1))[d]
                for x, d in zip(flat, mesh.local_data)], mesh)
            ys = mesh.fan_out(mesh.concat_axis(torch.stack(ys), "data", 0),
                              "data")
        ys = [y.reshape(x.shape) for y, x in zip(ys, xs)]
    else:
        ws = _layer_weights(cfg, mesh, p, _DENSE_FFN)
        ys = []
        for i, x in enumerate(xs):
            xm = mesh.fan_out(x, "model")
            ys.append(mesh.fan_in(
                [_dense_ffn(cfg, _shard_weights(ws, i, j), xm[j])
                 for j, _ in model], "model"))
        aux = torch.zeros((), dtype=torch.float32, device=hs[0].device)
    return [h + y for h, y in zip(out, ys)], aux


def _forward_mesh(cfg: TransformerConfig, mesh, params,
                  toks: List[torch.Tensor], split: bool):
    """:func:`forward` of each local data shard's tokens on ``mesh`` (its
    rows where ``split``, else all of them): ``(hs, aux)``, each shard's
    final-normed hidden states and the aux.
    The lookup is vocabulary parallel: each model shard looks up the
    tokens its ``[V / model, d]`` block of the table holds (gathered over
    ``data``) and the blocks' rows are summed over ``model``."""
    _mesh_check(cfg, mesh)
    dt = cfg.compute_dtype
    tables = _local(mesh, params["embed"]["table"], sharding.rank_leaf_spec(
        "embed/table", 2, cfg, mesh))
    vb = cfg.vocab // mesh.model
    hs = [mesh.fan_in([L.embedding_block_apply(
        {"table": tables[i][j]}, t, m * vb, compute_dtype=dt)
        for j, m in enumerate(mesh.local_model)], "model")
        for i, t in enumerate(toks)]
    del tables
    body = functools.partial(_layer_mesh, cfg, mesh, split)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for p in _unbound(params["layers"], cfg.n_layers):
        hs, aux = checkpoint(body, hs, p, use_reentrant=False) if remat \
            else body(hs, p)
        auxes.append(aux)
    ln = mesh.fan_out(params["ln_final"]["scale"], "data")
    hs = [L.rmsnorm_apply({"scale": ln[i]}, h) for i, h in enumerate(hs)]
    return hs, torch.stack(auxes).sum()


def forward(cfg: TransformerConfig, params, tokens: torch.Tensor, *,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (hidden ``[B, S, d]`` in the compute dtype,
    aux loss: the layers' MoE losses summed, an f32 zero without MoE).
    ``mesh``: a ``ShardMesh`` or ``RankMesh`` on which the model runs in
    the reference's 2-D layout (``sharding.rank_param_specs``; a rank's
    ``params`` are its blocks): the rows split over ``data``
    (``sharding.batch_split``), each layer tensor parallel over ``model``,
    the MoE expert parallel; the hidden states come back whole."""
    if mesh is not None:
        split = sharding.batch_split(tokens.shape[0], mesh)
        hs, aux = _forward_mesh(cfg, mesh, params,
                                _data_rows(mesh, tokens, split), split)
        return _join_rows(mesh, hs, split), aux
    h = L.embedding_apply(params["embed"], tokens,
                          compute_dtype=cfg.compute_dtype)
    body = functools.partial(_layer_body, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for p in _unbound(params["layers"], cfg.n_layers):
        h, aux = checkpoint(body, h, p, use_reentrant=False) if remat \
            else body(h, p)
        auxes.append(aux)
    h = L.rmsnorm_apply(params["ln_final"], h)
    return h, torch.stack(auxes).sum()


def _nll_sums(cfg: TransformerConfig, sums, h: torch.Tensor,
              labels: torch.Tensor, mask: torch.Tensor):
    """``(sum of masked NLL, sum of mask)`` of ``h [b, s, d]``, ``sums(h,
    labels, mask)`` giving them for a span of positions: over all of them,
    or ``loss_chunk`` positions at a time where it divides S, each chunk
    recomputed in the backward (the reference's checkpointed scan), so no
    ``[b, s, V]`` buffer is kept."""
    c = cfg.loss_chunk
    if not (c and h.shape[1] % c == 0):
        return sums(h, labels, mask)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], c):
        span = slice(c0, c0 + c)
        t, n = checkpoint(sums, h[:, span], labels[:, span], mask[:, span],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot, cnt


def _head_sums(cfg: TransformerConfig, head):
    """:func:`_nll_sums`'s ``sums`` of the whole head ``{"w": [d, V]}``:
    the f32 logits' ``logsumexp`` less the gold logit
    (``layers.softmax_cross_entropy``'s NLL)."""
    def sums(hx, lx, mx):
        logits = L.dense_apply(head, hx, compute_dtype=cfg.compute_dtype)
        logits = logits.float()
        gold = torch.gather(logits, -1, lx[..., None].long()).squeeze(-1)
        nll = torch.logsumexp(logits, dim=-1) - gold
        return (nll * mx).sum(), mx.sum()
    return sums


def _vocab_parallel_sums(cfg: TransformerConfig, mesh, heads):
    """:func:`_nll_sums`'s ``sums`` on ``mesh``: the logits vocabulary
    parallel from each local model shard's ``[d, V / model]`` block of the
    head (``heads``), the NLL ``layers.vocab_parallel_nll``'s."""
    vb = cfg.vocab // mesh.model
    starts = [m * vb for m in mesh.local_model]

    def sums(hx, lx, mx):
        xs = mesh.fan_out(hx, "model")
        logits = [L.dense_apply({"w": w}, x,
                                compute_dtype=cfg.compute_dtype).float()
                  for w, x in zip(heads, xs)]
        nll = L.vocab_parallel_nll(mesh, logits, lx, starts)
        return (nll * mx).sum(), mx.sum()
    return sums


def _global_mean(mesh, parts, split: bool) -> torch.Tensor:
    """``tot / cnt`` of each local data shard's ``[tot, cnt]``, summed over
    ``data`` before the divide where the rows split (the mean over the
    global batch, not a mean of the shards' means), else the first data
    shard's."""
    tot, cnt = (mesh.fan_in(parts, "data") if split
                else mesh.from_first(torch.stack(parts), "data"))
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: TransformerConfig, params, batch, *,
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy ``(loss, {"ce", "aux"})`` of ``tokens``,
    ``labels`` (int32) and ``mask`` (f32), each ``[B, S]``, the logits
    whole or in ``loss_chunk`` chunks (:func:`_nll_sums`).  ``mesh``:
    :func:`forward`'s layout, the logits split over ``model`` by the
    vocabulary (``layers.vocab_parallel_nll``) and the masked NLL's sum
    and the mask's count summed over ``data`` before the divide: the mean
    over the global batch."""
    if mesh is None:
        h, aux = forward(cfg, params, batch["tokens"])
        tot, cnt = _nll_sums(cfg, _head_sums(cfg, params["lm_head"]), h,
                             batch["labels"], batch["mask"])
        ce = tot / torch.clamp(cnt, min=1.0)
        return ce + aux, dict(ce=ce, aux=aux)
    split = sharding.batch_split(batch["tokens"].shape[0], mesh)
    rows = {k: _data_rows(mesh, batch[k], split)
            for k in ("tokens", "labels", "mask")}
    hs, aux = _forward_mesh(cfg, mesh, params, rows["tokens"], split)
    heads = _local(mesh, params["lm_head"]["w"], sharding.rank_leaf_spec(
        "lm_head/w", 2, cfg, mesh))
    ce = _global_mean(mesh, [torch.stack(_nll_sums(
        cfg, _vocab_parallel_sums(cfg, mesh, heads[i]), h,
        rows["labels"][i], rows["mask"][i])) for i, h in enumerate(hs)],
        split)
    return ce + aux, dict(ce=ce, aux=aux)


def data_parallel_loss_fn(cfg: TransformerConfig, params, batch, *,
                          mesh) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
    """:func:`loss_fn` of a small LM (``sharding.lm_is_small``: smollm-135m)
    on ``mesh`` in the reference's layout for it: every leaf whole on
    every shard (``sharding.lm_param_specs``' replicated branch), the rows
    split over ``data`` where they reach it (``sharding.batch_split``),
    each data shard running the one-device body on its rows with the
    leaves fanned out over ``data`` (their cotangents summed there), the
    CE's sum and count summed over ``data`` before the divide and the aux
    averaged over it.  The model shards compute alike: the reference
    spends ``model`` on splitting the sequence, which gives the same
    numbers and is not ported."""
    split = sharding.batch_split(batch["tokens"].shape[0], mesh)
    rows = {k: _data_rows(mesh, batch[k], split)
            for k in ("tokens", "labels", "mask")}
    leaves, tdef = tree_flatten(params)
    copies = [mesh.fan_out(x, "data") for x in leaves]
    parts, auxes = [], []
    for i, toks in enumerate(rows["tokens"]):
        p = tree_unflatten(tdef, [c[i] for c in copies])
        h, aux = forward(cfg, p, toks)
        parts.append(torch.stack(_nll_sums(
            cfg, _head_sums(cfg, p["lm_head"]), h, rows["labels"][i],
            rows["mask"][i])))
        auxes.append(aux)
    ce = _global_mean(mesh, parts, split)
    aux = (mesh.fan_in(auxes, "data") / mesh.data if split
           else mesh.from_first(torch.stack(auxes), "data"))
    return ce + aux, dict(ce=ce, aux=aux)


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
    On a ``RankMesh`` the cache is whole on every rank and each dense
    leaf is gathered whole from the ranks' blocks before its use
    (``sharding.assemble``); the expert stacks stay the rank's blocks.
    """
    b = tokens.shape[0]
    dt, hd = cfg.compute_dtype, cfg.hd
    length = cache["length"]
    slot = torch.clamp(length, 0, cache["k"].shape[2] - 1).reshape(1).long()
    pos = length.expand(b, 1)

    def whole(tree, spec_of):
        """``tree``'s dense leaves (``{name: {k: leaf}}``) whole, a rank's
        blocks gathered; an expert stack (a bare tensor) as it is."""
        if not sharding.is_rank_mesh(mesh):
            return tree
        return {name: leaf if not isinstance(leaf, dict) else {
            k: sharding.assemble(x, spec_of(f"{name}/{k}", x.dim()), mesh)
            for k, x in leaf.items()} for name, leaf in tree.items()}

    def top(path, ndim):
        return sharding.rank_leaf_spec(path, ndim, cfg, mesh)

    layer = functools.partial(_layer_spec, cfg, mesh)
    h = L.embedding_apply(whole({"embed": params["embed"]}, top)["embed"],
                          tokens, compute_dtype=dt)
    for i, p in enumerate(_unbound(params["layers"], cfg.n_layers)):
        p = whole(p, layer)
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
    logits = L.dense_apply(
        whole({"lm_head": params["lm_head"]}, top)["lm_head"], h,
        compute_dtype=dt)
    return logits, {**cache, "length": length + 1}
