"""Step factory: (arch, shape) -> init / step callables + batch specs.

The counterpart of the reference's ``launch/steps.py`` for what the port
holds: the recsys serve kinds of DLRM RM2 (``rec_serve``: ``serve_p99`` at
B = 512 and ``serve_bulk`` at B = 262,144; ``rec_retrieval``:
``retrieval_cand``, one user against 10^6 candidates).  ``rec_train``
comes with the training slice and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models.recsys import dlrm

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
    step_fn: Callable[..., Any]             # (params, batch) -> scores
    batch_spec: Dict[str, TensorSpec]
    make_batch: Callable[[torch.Generator], Dict[str, torch.Tensor]]
    model_flops_per_step: float = 0.0


def _reduce_rec_shape(shape: ShapeSpec) -> ShapeSpec:
    if shape.kind == "rec_retrieval":
        return dataclasses.replace(
            shape, extra=dict(n_candidates=256), global_batch=1)
    return dataclasses.replace(shape, global_batch=32)


def _rec_batch_spec(cfg, b: int) -> dict:
    return dict(dense=((b, cfg.n_dense), F32),
                sparse_ids=((b, cfg.n_sparse), I32))


def _rec_make_batch(cfg, b: int, device: torch.device):
    """``make_batch(gen)``: a random batch drawn on the generator's device,
    moved to ``device``."""
    def make_batch(gen: torch.Generator):
        g = gen.device
        out = dict(
            dense=torch.randn((b, cfg.n_dense), generator=gen, dtype=F32,
                              device=g),
            sparse_ids=torch.randint(0, cfg.vocab_per_field,
                                     (b, cfg.n_sparse), generator=gen,
                                     dtype=I32, device=g),
        )
        return {k: v.to(device) for k, v in out.items()}
    return make_batch


def _rec_dense_flops(cfg, b: int) -> float:
    """Dense-compute model FLOPs of ``b`` examples (embedding gathers
    excluded)."""
    bot = sum(2 * a * o for a, o in zip(cfg.bot_mlp[:-1], cfg.bot_mlp[1:]))
    dims = [cfg.top_in] + list(cfg.top_mlp)
    top = sum(2 * a * o for a, o in zip(dims[:-1], dims[1:]))
    inter = 2 * cfg.n_vectors ** 2 * cfg.embed_dim
    return b * float(bot + top + inter)


def _rec_bundle(arch: ArchSpec, shape: ShapeSpec, cfg,
                device: torch.device) -> StepBundle:
    def init_fn(seed: int):
        return dlrm.init(cfg, seed, device=device)

    b = shape.global_batch
    if shape.kind == "rec_train":
        raise NotImplementedError(
            f"{arch.id}/{shape.name}: training (rec_train) is not ported; it "
            "comes with the training slice and its optimizer")
    if shape.kind == "rec_serve":
        def serve(params, batch):
            return dlrm.forward(cfg, params, batch)

        return StepBundle(
            arch.id, shape.name, "serve", init_fn, serve,
            _rec_batch_spec(cfg, b),
            _rec_make_batch(cfg, b, device),
            model_flops_per_step=_rec_dense_flops(cfg, b))

    # retrieval: 1 user x n_candidates
    nc = shape.extra["n_candidates"]
    spec = _rec_batch_spec(cfg, 1)
    spec["candidates"] = ((nc,), I32)

    def retrieve(params, batch):
        return dlrm.retrieval_scores(cfg, params, batch)

    base_make = _rec_make_batch(cfg, 1, device)

    def make_batch(gen: torch.Generator):
        out = base_make(gen)
        out["candidates"] = torch.randint(
            0, cfg.vocab_per_field, (nc,), generator=gen, dtype=I32,
            device=gen.device).to(device)
        return out

    return StepBundle(arch.id, shape.name, "serve", init_fn, retrieve, spec,
                      make_batch,
                      model_flops_per_step=_rec_dense_flops(cfg, nc))


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
