"""Step factory: (arch, shape) -> init / step callables + batch specs.

The counterpart of the reference's ``launch/steps.py`` for what the port
holds: the recsys serve kinds of DLRM RM2, DCN-v2, SASRec and MIND
(``rec_serve``: ``serve_p99`` at B = 512 and ``serve_bulk`` at B = 262,144;
``rec_retrieval``: ``retrieval_cand``, one user against 10^6 candidates).
``rec_train`` comes with the training slice and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models.recsys import dcn, dlrm, mind, sasrec

F32 = torch.float32
I32 = torch.int32

TensorSpec = Tuple[Tuple[int, ...], torch.dtype]   # (shape, dtype)


@dataclasses.dataclass
class StepBundle:
    """Everything needed to run one (arch x shape) cell."""

    arch_id: str
    shape_name: str
    kind: str                               # serve
    init_fn: Callable[[int], Any]           # seed -> params on the device
    step_fn: Callable[..., Any]             # (params, batch) -> outputs
    batch_spec: Dict[str, TensorSpec]
    make_batch: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    model_flops_per_step: float = 0.0


_REC_MODS = {"dcn": dcn, "dlrm": dlrm, "sasrec": sasrec, "mind": mind}


def _reduce_rec_shape(shape: ShapeSpec) -> ShapeSpec:
    if shape.kind == "rec_retrieval":
        return dataclasses.replace(
            shape, extra=dict(n_candidates=256), global_batch=1)
    return dataclasses.replace(shape, global_batch=32)


def _rec_batch_spec(kind_model: str, cfg, b: int) -> dict:
    if kind_model in ("dcn", "dlrm"):
        return dict(dense=((b, cfg.n_dense), F32),
                    sparse_ids=((b, cfg.n_sparse), I32))
    if kind_model == "sasrec":
        return dict(item_seq=((b, cfg.seq_len), I32))
    return dict(hist=((b, cfg.hist_len), I32),
                hist_mask=((b, cfg.hist_len), F32))


def _rec_make_batch(kind_model: str, cfg, b: int, device: torch.device):
    """``make_batch(gen)``: a random batch drawn on the generator's device,
    moved to ``device``."""
    def make_batch(gen: torch.Generator):
        g = gen.device
        ints = lambda hi, shape: torch.randint(  # noqa: E731
            0, hi, shape, generator=gen, dtype=I32, device=g)
        if kind_model in ("dcn", "dlrm"):
            out = dict(
                dense=torch.randn((b, cfg.n_dense), generator=gen,
                                  dtype=F32, device=g),
                sparse_ids=ints(cfg.vocab_per_field, (b, cfg.n_sparse)))
        elif kind_model == "sasrec":
            out = dict(item_seq=ints(cfg.n_items, (b, cfg.seq_len)))
        else:
            out = dict(hist=ints(cfg.n_items, (b, cfg.hist_len)),
                       hist_mask=torch.ones((b, cfg.hist_len), dtype=F32,
                                            device=g))
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


def _rec_bundle(arch: ArchSpec, shape: ShapeSpec, cfg,
                device: torch.device) -> StepBundle:
    kind_model = arch.model_kind
    mod = _REC_MODS[kind_model]

    def init_fn(seed: int):
        return mod.init(cfg, seed, device=device)

    b = shape.global_batch
    if shape.kind == "rec_train":
        raise NotImplementedError(
            f"{arch.id}/{shape.name}: training (rec_train) is not ported; it "
            "comes with the training slice and its optimizer")
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
          config_overrides: Optional[Dict[str, Any]] = None) -> StepBundle:
    """The :class:`StepBundle` of one cell, its parameters and batches on
    ``device``.  ``reduced=True`` swaps in the smoke config and the reduced
    shape; ``config_overrides`` replaces model-config fields (such as
    ``compute_dtype``)."""
    dev = resolve_device(device)
    if isinstance(arch, str):
        arch = get_arch(arch)
    shape = arch.shape(shape_name)
    cfg = arch.reduced if reduced else arch.config
    if reduced:
        shape = _reduce_rec_shape(shape)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    return _rec_bundle(arch, shape, cfg, dev)
