"""Step factory: (arch, shape) -> init / step callables + batch specs.

The counterpart of the reference's ``launch/steps.py`` for what the port
holds, every cell of ``smollm-135m`` and of DLRM RM2, DCN-v2, SASRec and
MIND:

* training (``kind == "train"``): ``lm_train`` (``train_4k``, B = 256, S =
  4,096) and ``rec_train`` (``train_batch``, B = 65,536); ``step_fn(params,
  opt_state, batch) -> (params, opt_state, metrics)`` is
  ``training.train_loop.make_train_step`` of the model's ``loss_fn`` under
  :attr:`StepBundle.opt_cfg` (``DEFAULT_OPT``, bf16 moments, at full size;
  ``SMOKE_OPT`` reduced), and updates the parameters and moments in place;
* ``lm_prefill`` (``prefill_32k``, the next-token logits of a ``[B, S]``
  batch) and ``lm_decode`` (``decode_32k``, ``long_500k``: one token a row
  against a KV cache, which :attr:`StepBundle.make_cache` makes on the
  device);
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
from repro_torch.device import resolve_device
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


def _lm_bundle(arch: ArchSpec, shape: ShapeSpec, cfg: tfm.TransformerConfig,
               opt_cfg: AdamWConfig, device: torch.device) -> StepBundle:
    b, s = shape.global_batch, shape.seq_len
    n_params_active = cfg.active_param_count()

    def init_fn(seed: int):
        return tfm.init(cfg, seed, device=device)

    if shape.kind == "lm_train":
        # the reference's rules: gradient accumulation grows with model
        # size, and the biggest models take fp8 mu, bf16 nu and a bf16
        # accumulator (neither reached by a model one card holds)
        n_params = cfg.param_count()
        mb = 8 if n_params > 1.2e11 else 4 if n_params > 6e10 else \
            2 if n_params > 1.5e10 else 1
        mb = mb if b % max(mb, 1) == 0 else 1
        accum = F32
        if n_params > 6e10 and opt_cfg is DEFAULT_OPT:
            opt_cfg = dataclasses.replace(
                opt_cfg, mu_dtype=torch.float8_e4m3fn,
                nu_dtype=torch.bfloat16)
            accum = torch.bfloat16
        step = train_loop.make_train_step(
            functools.partial(tfm.loss_fn, cfg), opt_cfg, microbatches=mb,
            accum_dtype=accum)

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
            opt_cfg=opt_cfg)

    def tokens(rows: int, cols: int):
        def make_batch(gen: torch.Generator):
            return dict(tokens=torch.randint(
                0, cfg.vocab, (rows, cols), generator=gen, dtype=I32,
                device=gen.device).to(device))
        return make_batch

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
        step = train_loop.make_train_step(
            functools.partial(mod.loss_fn, cfg), opt_cfg)
        return StepBundle(
            arch.id, shape.name, "train", init_fn, step,
            _rec_batch_spec(kind_model, cfg, b, with_label=True),
            _rec_make_batch(kind_model, cfg, b, device, with_label=True),
            model_flops_per_step=3.0 * _rec_dense_flops(kind_model, cfg, b),
            opt_cfg=opt_cfg)
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


def build(arch: Union[str, ArchSpec], shape_name: str, *,
          reduced: bool = False, device="cuda",
          opt_cfg: Optional[AdamWConfig] = None,
          config_overrides: Optional[Dict[str, Any]] = None) -> StepBundle:
    """The :class:`StepBundle` of one cell, its parameters and batches on
    ``device``.  ``reduced=True`` swaps in the smoke config and the reduced
    shape; ``opt_cfg`` replaces a train cell's optimizer config
    (``SMOKE_OPT`` reduced, ``DEFAULT_OPT`` otherwise);
    ``config_overrides`` replaces model-config fields (such as
    ``compute_dtype``)."""
    dev = resolve_device(device)
    if isinstance(arch, str):
        arch = get_arch(arch)
    shape = arch.shape(shape_name)
    cfg = arch.reduced if reduced else arch.config
    lm = arch.family == "lm"
    if reduced:
        shape = (_reduce_lm_shape if lm else _reduce_rec_shape)(shape)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    opt = opt_cfg or (SMOKE_OPT if reduced else DEFAULT_OPT)
    if lm:
        return _lm_bundle(arch, shape, cfg, opt, dev)
    return _rec_bundle(arch, shape, cfg, opt, dev)
