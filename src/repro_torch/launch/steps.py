"""Step factory: (arch, shape) -> init / step callables + batch specs.

The counterpart of the reference's ``launch/steps.py``: every cell of
its ten architectures, the five LMs (``smollm-135m``, ``qwen1.5-32b``,
``command-r-plus-104b`` and the MoE LMs ``dbrx-132b`` and
``grok-1-314b``), ``gcn-cora`` and DLRM RM2, DCN-v2, SASRec and MIND:

* training (``kind == "train"``): ``lm_train`` (``train_4k``, B = 256, S =
  4,096), ``rec_train`` (``train_batch``, B = 65,536) and the GCN's
  ``gnn_full`` (``full_graph_sm``, cora's 2,708 nodes; ``ogb_products``,
  2,449,029 nodes and 61,859,140 edges), ``gnn_minibatch``
  (``minibatch_lg``: 1,024 seeds, fanout 15-10) and ``gnn_batched``
  (``molecule``: 128 graphs of 30 nodes); ``step_fn(params, opt_state,
  batch) -> (params, opt_state, metrics)`` is
  ``training.train_loop.make_train_step`` of the model's loss under
  :attr:`StepBundle.opt_cfg` (``DEFAULT_OPT``, bf16 moments, at full size;
  ``SMOKE_OPT`` reduced), and updates the parameters and moments in place;
* ``lm_prefill`` (``prefill_32k``, the next-token logits of a ``[B, S]``
  batch) and ``lm_decode`` (``decode_32k``, ``long_500k``: one token a row
  against a KV cache, which :attr:`StepBundle.make_cache` makes on the
  device; the int8 cache wherever the bf16 one would pass 0.5 TB, as at
  every large LM's ``decode_32k`` and qwen's ``long_500k``);
* ``rec_serve`` (``serve_p99`` at B = 512, ``serve_bulk`` at B = 262,144)
  and ``rec_retrieval`` (``retrieval_cand``, one user against 10^6
  candidates).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.device import OnMeta, resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import gcn as gcn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.recsys import dcn, dlrm, mind, sasrec
from repro_torch.training import train_loop
from repro_torch.training.optimizer import AdamWConfig

F32 = torch.float32
I32 = torch.int32

TensorSpec = Tuple[Tuple[int, ...], torch.dtype]   # (shape, dtype)


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one (arch x shape) cell."""

    arch_id: str
    shape_name: str
    kind: str                               # train | serve
    init_fn: Callable[[int], Any]           # seed -> params on the device
    # train: (params, opt_state, batch) -> (params, opt_state, metrics);
    # serve: (params, [cache,] batch) -> outputs
    step_fn: Callable[..., Any]
    batch_spec: Dict[str, TensorSpec]
    make_batch: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    model_flops_per_step: float = 0.0
    # lm_decode: the cache's tensors, and ``make_cache(batch=None)``, an
    # empty cache on the device (``batch`` rows in place of the shape's)
    cache_spec: Optional[Dict[str, TensorSpec]] = None
    make_cache: Optional[Callable[..., Dict[str, torch.Tensor]]] = None
    opt_cfg: Optional[AdamWConfig] = None   # the config step_fn uses (train)
    # train: the ``loss(params, batch)`` that step_fn trains
    loss_fn: Optional[Callable[[Any, Any], Any]] = None
    # an LM train cell's rules: microbatches and the accumulator's dtype
    microbatches: int = 1
    accum_dtype: Optional[torch.dtype] = None
    # an LM train cell on a mesh: its parameters' layout
    # (``sharding.rank_param_specs``)
    param_specs: Optional[Any] = None


DEFAULT_OPT = AdamWConfig(moment_dtype=torch.bfloat16)
SMOKE_OPT = AdamWConfig(moment_dtype=torch.float32, warmup_steps=2,
                        total_steps=100)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _reduce_lm_shape(shape: ShapeSpec) -> ShapeSpec:
    table = {
        "lm_train": dict(seq_len=32, global_batch=4),
        "lm_prefill": dict(seq_len=64, global_batch=2),
        "lm_decode": dict(seq_len=64, global_batch=2),
    }
    return dataclasses.replace(shape, **table[shape.kind])


def lm_train_rules(n_params: int, batch: int, opt_cfg: AdamWConfig, *,
                   force: bool = False):
    """The reference's train rules at ``n_params`` parameters:
    ``(microbatches, opt_cfg, accum_dtype)``.  Gradient accumulation grows
    with model size (8 above 1.2e11, 4 above 6e10, 2 above 1.5e10; 1 where
    that does not divide ``batch``), and above 6e10 the moments take fp8
    ``mu`` and bf16 ``nu`` and the accumulator bf16, when ``opt_cfg`` is
    ``DEFAULT_OPT`` (or ``force``)."""
    mb = 8 if n_params > 1.2e11 else 4 if n_params > 6e10 else \
        2 if n_params > 1.5e10 else 1
    mb = mb if batch % mb == 0 else 1
    accum = F32
    if n_params > 6e10 and (force or opt_cfg is DEFAULT_OPT):
        opt_cfg = dataclasses.replace(opt_cfg, mu_dtype=torch.float8_e4m3fn,
                                      nu_dtype=torch.bfloat16)
        accum = torch.bfloat16
    return mb, opt_cfg, accum


def _lm_bundle(arch: ArchSpec, shape: ShapeSpec, cfg: tfm.TransformerConfig,
               opt_cfg: AdamWConfig, device: torch.device, *,
               rule_params: int, force_rules: bool = False,
               mesh=None) -> StepBundle:
    b, s = shape.global_batch, shape.seq_len
    n_params_active = cfg.active_param_count()
    # on a mesh the reference's layout: a small LM's leaves whole
    # (``lm_param_specs``' replicated branch, by the published config)
    # and its rows split over data; a large LM's 2-D layout
    small = mesh is not None and sharding.lm_is_small(arch.config)
    loss = functools.partial(
        tfm.data_parallel_loss_fn if small else tfm.loss_fn, cfg, mesh=mesh)
    specs = None
    if small:
        with OnMeta():
            specs = sharding.lm_param_specs(tfm.init(cfg, device="meta"),
                                            arch.config)
    elif mesh is not None:
        specs = tfm.param_specs(cfg, mesh)

    def init_fn(seed: int):
        if small or not sharding.is_rank_mesh(mesh):
            return tfm.init(cfg, seed, device=device)
        # a rank keeps its block of each leaf as it is drawn
        return tfm.init(cfg, seed, device=device, keep=lambda path, w: (
            sharding.rank_block(w, sharding.rank_leaf_spec(
                path, w.dim(), cfg, mesh), mesh)))

    if shape.kind == "lm_train":
        # the reference's rules, from the published config's size
        # (``rule_params``) however the depth is cut
        mb, opt_cfg, accum = lm_train_rules(rule_params, b, opt_cfg,
                                            force=force_rules)
        step = train_loop.make_train_step(
            loss, opt_cfg, microbatches=mb, accum_dtype=accum, mesh=mesh,
            specs=specs)

        def make_batch(gen: torch.Generator):
            toks = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                 dtype=I32, device=gen.device).to(device)
            return dict(tokens=toks, labels=torch.roll(toks, -1, dims=1),
                        mask=torch.ones((b, s), dtype=F32, device=device))

        spec = dict(tokens=((b, s), I32), labels=((b, s), I32),
                    mask=((b, s), F32))
        return StepBundle(
            arch.id, shape.name, "train", init_fn, step, spec, make_batch,
            model_flops_per_step=6.0 * n_params_active * b * s,  # fwd+bwd
            opt_cfg=opt_cfg, loss_fn=loss, microbatches=mb,
            accum_dtype=accum, param_specs=specs)

    def tokens(rows: int, cols: int):
        def make_batch(gen: torch.Generator):
            return dict(tokens=torch.randint(
                0, cfg.vocab, (rows, cols), generator=gen, dtype=I32,
                device=gen.device).to(device))
        return make_batch

    if mesh is not None:
        raise ValueError("mesh= is the train bundle's: a serve cell takes a "
                         "mesh through the model's own mesh= calls")

    if shape.kind == "lm_prefill":
        def serve_prefill(params, batch):
            h, _ = tfm.forward(cfg, params, batch["tokens"])
            dt = cfg.compute_dtype
            return h[:, -1:, :].to(dt) @ params["lm_head"]["w"].to(dt)

        return StepBundle(
            arch.id, shape.name, "serve", init_fn, serve_prefill,
            dict(tokens=((b, s), I32)), tokens(b, s),
            model_flops_per_step=2.0 * n_params_active * b * s)

    # lm_decode: the int8 cache with per-token scales wherever the bf16
    # cache would exceed ~0.5 TB (the reference's switch)
    cache_bytes_bf16 = (cfg.n_layers * b * s * cfg.n_kv_heads
                        * cfg.hd * 2 * 2)
    if cache_bytes_bf16 > 0.5e12 and cfg.compute_dtype == torch.bfloat16:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    cache_dt = torch.bfloat16 if cfg.compute_dtype == torch.bfloat16 else F32
    cshape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_quant:
        sshape = cshape[:-1]
        cache_spec = dict(k=(cshape, torch.int8), v=(cshape, torch.int8),
                          k_scale=(sshape, torch.bfloat16),
                          v_scale=(sshape, torch.bfloat16),
                          length=((), I32))
    else:
        cache_spec = dict(k=(cshape, cache_dt), v=(cshape, cache_dt),
                          length=((), I32))

    def serve_decode(params, cache, batch):
        return tfm.decode_step(cfg, params, cache, batch["tokens"])

    def make_cache(batch: Optional[int] = None):
        return tfm.init_cache(cfg, b if batch is None else batch, s,
                              cache_dt, device=device)

    return StepBundle(
        arch.id, shape.name, "serve", init_fn, serve_decode,
        dict(tokens=((b, 1), I32)), tokens(b, 1),
        model_flops_per_step=2.0 * n_params_active * b,  # a token a row
        cache_spec=cache_spec, make_cache=make_cache)


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def _gnn_cfg(template, shape: ShapeSpec) -> gcn_mod.GCNConfig:
    x = shape.extra
    return gcn_mod.GCNConfig(
        n_layers=template.n_layers, d_feat=x["d_feat"],
        d_hidden=template.d_hidden, n_classes=x["n_classes"],
        aggregator="sym" if shape.kind == "gnn_full" else "mean",
        readout="mean" if shape.kind == "gnn_batched" else None,
        compute_dtype=template.compute_dtype,
    )


def _reduce_gnn_shape(shape: ShapeSpec) -> ShapeSpec:
    x = dict(shape.extra)
    if shape.kind == "gnn_full":
        x.update(n_nodes=120, n_edges=480, d_feat=32, n_classes=7)
    elif shape.kind == "gnn_minibatch":
        x.update(n_nodes=500, n_edges=4000, batch_nodes=8, fanout=(3, 2),
                 d_feat=16, n_classes=5)
    else:  # batched molecules
        x.update(n_nodes=10, n_edges=16, batch=8, d_feat=8, n_classes=2)
    return dataclasses.replace(shape, extra=x)


def _gnn_full_flops(cfg: gcn_mod.GCNConfig, n: int, m: int) -> float:
    """A gather-mac of ``2 m d`` a layer plus the dense ``2 n d_in
    d_out``, x3 for the forward and the backward."""
    dims = cfg.dims()
    return 3.0 * sum(2.0 * m * dims[i] + 2.0 * n * dims[i] * dims[i + 1]
                     for i in range(cfg.n_layers))


def _gnn_bundle(arch: ArchSpec, shape: ShapeSpec, template,
                opt_cfg: AdamWConfig, device: torch.device) -> StepBundle:
    """The reference's three GNN train bundles: its batch keys, shapes,
    dtypes and distributions (drawn from a ``torch.Generator``), its
    512-multiple padding and masks, and its model FLOPs."""
    cfg = _gnn_cfg(template, shape)
    x = shape.extra

    def init_fn(seed: int):
        return gcn_mod.init(cfg, seed, device=device)

    def draw(gen: torch.Generator):
        g = gen.device
        ints = lambda lo, hi, size: torch.randint(  # noqa: E731
            lo, hi, size, generator=gen, dtype=I32, device=g)
        normal = lambda size: torch.randn(  # noqa: E731
            size, generator=gen, dtype=F32, device=g)
        return g, ints, normal

    def bundle(spec, loss, make_batch, flops):
        return StepBundle(arch.id, shape.name, "train", init_fn,
                          train_loop.make_train_step(loss, opt_cfg), spec,
                          make_batch, model_flops_per_step=flops,
                          opt_cfg=opt_cfg, loss_fn=loss)

    if shape.kind == "gnn_full":
        # n and m padded to 512-multiples (the reference's input shardings
        # need them); the masks keep the math exact on the padding
        n = ((x["n_nodes"] + 511) // 512) * 512
        m = ((x["n_edges"] + 511) // 512) * 512
        n_real, m_real = x["n_nodes"], x["n_edges"]
        spec = dict(features=((n, cfg.d_feat), F32), edge_src=((m,), I32),
                    edge_dst=((m,), I32), edge_mask=((m,), F32),
                    labels=((n,), I32), label_mask=((n,), F32))

        def make_batch(gen: torch.Generator):
            g, ints, normal = draw(gen)
            out = dict(
                features=normal((n, cfg.d_feat)),
                edge_src=ints(0, n_real, (m,)),
                edge_dst=ints(0, n_real, (m,)),
                edge_mask=(torch.arange(m, device=g) < m_real).to(F32),
                labels=ints(0, cfg.n_classes, (n,)),
                label_mask=(torch.arange(n, device=g) < n_real).to(F32))
            return {k: v.to(device) for k, v in out.items()}

        return bundle(spec, functools.partial(gcn_mod.loss_full, cfg),
                      make_batch, _gnn_full_flops(cfg, n, m))

    if shape.kind == "gnn_minibatch":
        seeds = x["batch_nodes"]
        f1, f2 = x["fanout"]
        n1 = seeds + seeds * f1                 # block-1 node set
        n2 = n1 + n1 * f2                       # block-2 node set
        e1, e2 = seeds * f1, n1 * f2
        spec = dict(feats=((n2, cfg.d_feat), F32), e2_src=((e2,), I32),
                    e2_dst=((e2,), I32), e2_mask=((e2,), F32),
                    e1_src=((e1,), I32), e1_dst=((e1,), I32),
                    e1_mask=((e1,), F32), labels=((seeds,), I32))

        def loss(params, batch):
            return gcn_mod.loss_sampled(cfg, params, dict(
                block_feats=[None, batch["feats"]],
                block_edges=[
                    dict(edge_src=batch["e1_src"], edge_dst=batch["e1_dst"],
                         edge_mask=batch["e1_mask"], n_dst=seeds),
                    dict(edge_src=batch["e2_src"], edge_dst=batch["e2_dst"],
                         edge_mask=batch["e2_mask"], n_dst=n1)],
                labels=batch["labels"]))

        def make_batch(gen: torch.Generator):
            g, ints, normal = draw(gen)
            out = dict(
                feats=normal((n2, cfg.d_feat)),
                e2_src=ints(0, n2, (e2,)), e2_dst=ints(0, n1, (e2,)),
                e2_mask=torch.ones((e2,), dtype=F32, device=g),
                e1_src=ints(0, n1, (e1,)), e1_dst=ints(0, seeds, (e1,)),
                e1_mask=torch.ones((e1,), dtype=F32, device=g),
                labels=ints(0, cfg.n_classes, (seeds,)))
            return {k: v.to(device) for k, v in out.items()}

        flops = 3.0 * (2.0 * e2 * cfg.d_feat
                       + 2.0 * n1 * cfg.d_feat * cfg.d_hidden
                       + 2.0 * e1 * cfg.d_hidden
                       + 2.0 * seeds * cfg.d_hidden * cfg.n_classes)
        return bundle(spec, loss, make_batch, flops)

    # batched molecules: block-diagonal edges, each graph's own offsets
    bsz, npg, epg = x["batch"], x["n_nodes"], x["n_edges"]
    n, m = bsz * npg, bsz * epg * 2
    spec = dict(features=((n, cfg.d_feat), F32), edge_src=((m,), I32),
                edge_dst=((m,), I32), edge_mask=((m,), F32),
                graph_ids=((n,), I32), graph_labels=((bsz,), I32))

    def make_batch(gen: torch.Generator):
        g, ints, normal = draw(gen)
        graphs = torch.arange(bsz, dtype=I32, device=g)
        edge_off = torch.repeat_interleave(graphs * npg, 2 * epg)
        out = dict(
            edge_src=ints(0, npg, (m,)) + edge_off,
            edge_dst=ints(0, npg, (m,)) + edge_off,
            features=normal((n, cfg.d_feat)),
            edge_mask=torch.ones((m,), dtype=F32, device=g),
            graph_ids=torch.repeat_interleave(graphs, npg),
            graph_labels=ints(0, cfg.n_classes, (bsz,)))
        return {k: v.to(device) for k, v in out.items()}

    return bundle(spec, functools.partial(gcn_mod.loss_full, cfg),
                  make_batch, _gnn_full_flops(cfg, n, m))


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

_REC_MODS = {"dcn": dcn, "dlrm": dlrm, "sasrec": sasrec, "mind": mind}


def _reduce_rec_shape(shape: ShapeSpec) -> ShapeSpec:
    if shape.kind == "rec_retrieval":
        return dataclasses.replace(
            shape, extra=dict(n_candidates=256), global_batch=1)
    return dataclasses.replace(shape, global_batch=32)


def _rec_batch_spec(kind_model: str, cfg, b: int,
                    with_label: bool = False) -> dict:
    if kind_model in ("dcn", "dlrm"):
        spec = dict(dense=((b, cfg.n_dense), F32),
                    sparse_ids=((b, cfg.n_sparse), I32))
        if with_label:
            spec["label"] = ((b,), F32)
    elif kind_model == "sasrec":
        spec = dict(item_seq=((b, cfg.seq_len), I32))
        if with_label:
            spec.update(pos=((b, cfg.seq_len), I32),
                        neg=((b, cfg.seq_len), I32),
                        mask=((b, cfg.seq_len), F32))
    else:
        spec = dict(hist=((b, cfg.hist_len), I32),
                    hist_mask=((b, cfg.hist_len), F32))
        if with_label:
            spec.update(target=((b,), I32),
                        neg=((b, cfg.n_negatives), I32))
    return spec


def _rec_make_batch(kind_model: str, cfg, b: int, device: torch.device,
                    with_label: bool = False):
    """``make_batch(gen)``: a random batch drawn on the generator's device,
    moved to ``device``; ``with_label`` adds the training targets (a
    Bernoulli(0.3) click label; SASRec's positives, negatives and mask;
    MIND's target and negatives)."""
    def make_batch(gen: torch.Generator):
        g = gen.device
        ints = lambda hi, shape: torch.randint(  # noqa: E731
            0, hi, shape, generator=gen, dtype=I32, device=g)
        if kind_model in ("dcn", "dlrm"):
            out = dict(
                dense=torch.randn((b, cfg.n_dense), generator=gen,
                                  dtype=F32, device=g),
                sparse_ids=ints(cfg.vocab_per_field, (b, cfg.n_sparse)))
            if with_label:
                out["label"] = (torch.rand((b,), generator=gen, device=g)
                                < 0.3).to(F32)
        elif kind_model == "sasrec":
            out = dict(item_seq=ints(cfg.n_items, (b, cfg.seq_len)))
            if with_label:
                out.update(pos=ints(cfg.n_items, (b, cfg.seq_len)),
                           neg=ints(cfg.n_items, (b, cfg.seq_len)),
                           mask=torch.ones((b, cfg.seq_len), dtype=F32,
                                           device=g))
        else:
            out = dict(hist=ints(cfg.n_items, (b, cfg.hist_len)),
                       hist_mask=torch.ones((b, cfg.hist_len), dtype=F32,
                                            device=g))
            if with_label:
                out.update(target=ints(cfg.n_items, (b,)),
                           neg=ints(cfg.n_items, (b, cfg.n_negatives)))
        return {k: v.to(device) for k, v in out.items()}
    return make_batch


def _rec_dense_flops(kind_model: str, cfg, b: int) -> float:
    """Dense-compute model FLOPs of ``b`` examples (embedding gathers
    excluded)."""
    if kind_model == "dcn":
        d = cfg.x0_dim
        cross = cfg.n_cross_layers * 2 * d * d
        dims = [d] + list(cfg.mlp)
        deep = sum(2 * a * o for a, o in zip(dims[:-1], dims[1:]))
        return b * float(cross + deep)
    if kind_model == "dlrm":
        bot = sum(2 * a * o for a, o in
                  zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
        dims = [cfg.top_in] + list(cfg.top_mlp)
        top = sum(2 * a * o for a, o in zip(dims[:-1], dims[1:]))
        inter = 2 * cfg.n_vectors ** 2 * cfg.embed_dim
        return b * float(bot + top + inter)
    if kind_model == "sasrec":
        d = cfg.embed_dim
        per_block = 8 * d * d * cfg.seq_len + 4 * d * cfg.d_ff * cfg.seq_len \
            + 4 * cfg.seq_len ** 2 * d
        return b * float(cfg.n_blocks * per_block)
    d = cfg.embed_dim
    routing = cfg.capsule_iters * 4 * cfg.hist_len * cfg.n_interests * d
    return b * float(2 * cfg.hist_len * d * d + routing)


def _rec_bundle(arch: ArchSpec, shape: ShapeSpec, cfg, opt_cfg: AdamWConfig,
                device: torch.device) -> StepBundle:
    kind_model = arch.model_kind
    mod = _REC_MODS[kind_model]

    def init_fn(seed: int):
        return mod.init(cfg, seed, device=device)

    b = shape.global_batch
    if shape.kind == "rec_train":
        loss = functools.partial(mod.loss_fn, cfg)
        return StepBundle(
            arch.id, shape.name, "train", init_fn,
            train_loop.make_train_step(loss, opt_cfg),
            _rec_batch_spec(kind_model, cfg, b, with_label=True),
            _rec_make_batch(kind_model, cfg, b, device, with_label=True),
            model_flops_per_step=3.0 * _rec_dense_flops(kind_model, cfg, b),
            opt_cfg=opt_cfg, loss_fn=loss)
    if shape.kind == "rec_serve":
        def serve(params, batch):
            if kind_model in ("dcn", "dlrm"):
                return mod.forward(cfg, params, batch)
            if kind_model == "sasrec":
                return sasrec.user_embedding(cfg, params, batch["item_seq"])
            return mind.user_interests(cfg, params, batch["hist"],
                                       batch["hist_mask"])

        return StepBundle(
            arch.id, shape.name, "serve", init_fn, serve,
            _rec_batch_spec(kind_model, cfg, b),
            _rec_make_batch(kind_model, cfg, b, device),
            model_flops_per_step=_rec_dense_flops(kind_model, cfg, b))

    # retrieval: 1 user x n_candidates
    nc = shape.extra["n_candidates"]
    spec = _rec_batch_spec(kind_model, cfg, 1)
    spec["candidates"] = ((nc,), I32)

    def retrieve(params, batch):
        return mod.retrieval_scores(cfg, params, batch)

    base_make = _rec_make_batch(kind_model, cfg, 1, device)
    vocab = getattr(cfg, "n_items", getattr(cfg, "vocab_per_field", 1000))

    def make_batch(gen: torch.Generator):
        out = base_make(gen)
        out["candidates"] = torch.randint(
            0, vocab, (nc,), generator=gen, dtype=I32,
            device=gen.device).to(device)
        return out

    if kind_model in ("dcn", "dlrm"):
        flops = _rec_dense_flops(kind_model, cfg, nc)
    else:
        flops = 2.0 * nc * cfg.embed_dim
    return StepBundle(arch.id, shape.name, "serve", init_fn, retrieve, spec,
                      make_batch, model_flops_per_step=flops)


def reduce_shape(arch: ArchSpec, shape: ShapeSpec) -> ShapeSpec:
    """The reduced (CPU smoke) size of ``shape``."""
    if arch.family == "lm":
        return _reduce_lm_shape(shape)
    if arch.family == "gnn":
        return _reduce_gnn_shape(shape)
    return _reduce_rec_shape(shape)


def build(arch: Union[str, ArchSpec], shape_name: str, *,
          reduced: bool = False, device="cuda",
          opt_cfg: Optional[AdamWConfig] = None,
          config_overrides: Optional[Dict[str, Any]] = None,
          published_rules: bool = False, mesh=None) -> StepBundle:
    """The :class:`StepBundle` of one cell, its parameters and batches on
    ``device``.  ``reduced=True`` swaps in the smoke config and the reduced
    shape; ``opt_cfg`` replaces a train cell's optimizer config
    (``SMOKE_OPT`` reduced, ``DEFAULT_OPT`` otherwise);
    ``config_overrides`` replaces model-config fields (such as
    ``compute_dtype``).

    An LM train cell takes the reference's size rules
    (:func:`lm_train_rules`) from the published config's parameter count,
    also where ``config_overrides`` cut its depth or width; a reduced
    cell from the reduced config's, unless ``published_rules``, which
    forces the published config's rules (its moment and accumulator
    dtypes whatever ``opt_cfg``; its microbatches where they divide the
    batch).  ``mesh``: an LM train cell on that mesh in the reference's
    2-D layout (a ``ShardMesh``, or a ``RankMesh`` whose ``init_fn`` keeps
    the rank's block of each leaf as it is drawn), the layout in the
    bundle's ``param_specs``; ``make_batch`` draws the whole batch on
    every rank and the loss gives each data shard its rows of each
    microbatch."""
    dev = resolve_device(device)
    if isinstance(arch, str):
        arch = get_arch(arch)
    shape = arch.shape(shape_name)
    cfg = arch.reduced if reduced else arch.config
    if reduced:
        shape = reduce_shape(arch, shape)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    opt = opt_cfg or (SMOKE_OPT if reduced else DEFAULT_OPT)
    if arch.family == "lm":
        rules = (arch.config if published_rules or not reduced
                 else cfg).param_count()
        return _lm_bundle(arch, shape, cfg, opt, dev, rule_params=rules,
                          force_rules=published_rules, mesh=mesh)
    if mesh is not None:
        raise ValueError("mesh= is an LM train cell's")
    if arch.family == "gnn":
        return _gnn_bundle(arch, shape, cfg, opt, dev)
    return _rec_bundle(arch, shape, cfg, opt, dev)
