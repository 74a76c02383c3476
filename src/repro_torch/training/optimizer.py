"""AdamW and its schedule (the reference's ``training/optimizer.py``).

The arithmetic is the reference's element by element: master weights in
f32, the moments stored in their configured dtypes (``mu_dt``, ``nu_dt``:
f32 by default, bf16 under ``launch/steps.DEFAULT_OPT``, fp8 ``mu`` where
the reference's moment rule picks it), global-norm clipping and decoupled
weight decay.  Leaves are walked in JAX's flatten order (:mod:`repro_torch.
tree`), so ``global_norm`` sums its leaves in the reference's order.

:func:`update` writes the new parameters and moments into their tensors
in place (the counterpart of the reference's donated buffers) and walks
each leaf in blocks (:func:`leaf_blocks`: at most :data:`UPDATE_ROWS`
leading-axis rows and :data:`UPDATE_ELEMS` elements): the same operations
on each element, with f32 temporaries of one block, so neither a
1.66-billion-element embedding table nor a layer's 3.17-billion-element
expert stack needs four f32 copies of itself alongside.
PyTorch does no arithmetic in fp8: a moment is read as f32 and written
back through :func:`cast_moment`, which rounds as the reference's
``astype`` does (to nearest, a value past the format's range to NaN,
where PyTorch's own cast saturates at 448).

On a mesh (``mesh=`` with ``specs``, the layout of the gradients) the
norm is taken over the distinct blocks of each leaf
(``sharding.distinct_blocks``): each block's f32 sum of squares, summed in
shard order within a leaf, the leaves in flatten order.  A stacked
``ShardMesh`` sums the blocks of its whole leaves; a ``RankMesh`` gathers
every rank's sums of its own blocks, so a replicated leaf counts once and
every rank holds the stacked mesh's ``grad_norm``, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

UPDATE_ROWS = 1 << 21      # leading-axis rows a block of the update
UPDATE_ELEMS = 1 << 28     # ...and elements (1 GiB a block's f32 temporary)


class AdamState(NamedTuple):
    step: torch.Tensor       # int32 []
    mu: Any                  # tree like params (maybe bf16 or fp8)
    nu: Any                  # tree like params (maybe bf16)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # split moment dtypes: mu tolerates fp8 (FP8-LM, arXiv:2310.18313),
    # nu needs more range; both f32 by default
    moment_dtype: Any = torch.float32   # sets both when mu/nu not given
    mu_dtype: Any = None
    nu_dtype: Any = None
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1

    @property
    def mu_dt(self):
        return self.mu_dtype if self.mu_dtype is not None else self.moment_dtype

    @property
    def nu_dt(self):
        return self.nu_dtype if self.nu_dtype is not None else self.moment_dtype


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio * lr`` (f32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init(cfg: AdamWConfig, params: Any) -> AdamState:
    """Zero moments like ``params`` (on each leaf's device) and step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.mu_dt,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.nu_dt,
                                          device=p.device), params),
    )


def leaf_blocks(*xs: torch.Tensor):
    """Matching blocks of ``xs`` (views, so a write to a block is a write
    to its leaf): the whole where it holds at most :data:`UPDATE_ROWS`
    leading-axis rows and :data:`UPDATE_ELEMS` elements, else runs of
    leading-axis rows (as many as both limits allow, at least one), a
    single row split in turn along its own leading axis."""
    x = xs[0]
    if x.dim() == 0 or (x.shape[0] <= UPDATE_ROWS
                        and x.numel() <= UPDATE_ELEMS):
        yield xs
        return
    rows = x.shape[0]
    if rows == 1:
        yield from leaf_blocks(*(t[0] for t in xs))
        return
    per_row = max(x.numel() // rows, 1)
    step = max(1, min(UPDATE_ROWS, UPDATE_ELEMS // per_row))
    for i in range(0, rows, step):
        yield from leaf_blocks(*(t[i:i + step] for t in xs))


def _squares(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of ``x``, a block of rows at a time."""
    return sum(torch.sum(torch.square(b.to(torch.float32)))
               for (b,) in leaf_blocks(x))


def global_norm(tree: Any, *, mesh=None, specs: Any = None) -> torch.Tensor:
    """``sqrt`` of the sum over leaves (in flatten order) of each leaf's
    sum of squares in f32; on ``mesh``, each sharded leaf's (under
    ``specs``) the sum of its distinct blocks' in shard order."""
    leaves = tree_leaves(tree)
    if mesh is None:
        parts = [_squares(x) for x in leaves]
    else:
        parts = _block_squares(leaves, sharding._spec_leaves(specs), mesh)
    total = 0
    for part in parts:
        total = total + part
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _block_squares(leaves, specs, mesh) -> list:
    """Each leaf's sum of squares by blocks: a replicated leaf's whole, a
    sharded leaf's distinct blocks' in shard order (a stacked mesh reads
    them from the whole leaf; a rank gathers every rank's own)."""
    rank = sharding.is_rank_mesh(mesh)
    out, sharded = [], []
    for x, spec in zip(leaves, specs):
        if sharding.is_replicated(spec):
            out.append(_squares(x))
        elif rank:
            out.append(None)
            sharded.append(_squares(x.contiguous()))
        else:
            blocks = sharding.shard(x, spec, mesh)
            out.append(sum(_squares(blocks[d, m].contiguous())
                           for d, m in sharding.distinct_blocks(spec, mesh)))
    if rank and sharded:
        every = mesh.gather_blocks(torch.stack(sharded)[None],
                                   ("data", "model"), dst=None)
        j = 0
        for i, spec in enumerate(specs):
            if out[i] is None:
                out[i] = sum(every[d * mesh.model + m][0, j]
                             for d, m in sharding.distinct_blocks(spec, mesh))
                j += 1
    return out


def cast_moment(x32: torch.Tensor, dtype) -> torch.Tensor:
    """``x32`` in a moment's ``dtype``; into ``float8_e4m3fn`` as the
    reference casts: to nearest, and a value that rounds past 448 (above
    464 in magnitude, or infinite) to NaN of its sign."""
    if dtype != torch.float8_e4m3fn:
        return x32.to(dtype)
    nan = torch.copysign(torch.full_like(x32, float("nan")), x32)
    return torch.where(x32.abs() > 464.0, nan, x32).to(dtype)


def _one(cfg: AdamWConfig, p, g, m, v, clip, lr, b1c, b2c) -> None:
    """The reference's per-leaf update of one block, written in place."""
    g = g.to(torch.float32) * clip
    m32 = m.to(torch.float32)
    v32 = v.to(torch.float32)
    m32 = cfg.b1 * m32 + (1.0 - cfg.b1) * g
    v32 = cfg.b2 * v32 + (1.0 - cfg.b2) * torch.square(g)
    upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
    p32 = p.to(torch.float32)
    p32 = p32 - lr * (upd + cfg.weight_decay * p32)
    p.copy_(p32.to(p.dtype))
    m.copy_(cast_moment(m32, cfg.mu_dt))
    v.copy_(cast_moment(v32, cfg.nu_dt))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: AdamState,
           params: Any, *, mesh=None,
           specs: Any = None) -> Tuple[Any, AdamState, dict]:
    """One AdamW step: ``params`` and the state's moments are written in
    place; returns ``(params, new_state, metrics)`` with the metrics
    ``grad_norm`` and ``lr`` (f32 scalars on the device).  ``mesh`` and
    ``specs``: the leaves are blocks laid out by ``specs`` (a rank's, or
    a stacked mesh's whole leaves), and ``grad_norm`` is taken by blocks;
    the rest is element by element."""
    gnorm = global_norm(grads, mesh=mesh, specs=specs)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    flat_p, treedef = tree_flatten(params)
    flat_g, flat_m, flat_v = (tree_leaves(t) for t in
                              (grads, state.mu, state.nu))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in structure")
    for leaf in zip(flat_p, flat_g, flat_m, flat_v):
        for p, g, m, v in leaf_blocks(*leaf):
            _one(cfg, p, g, m, v, clip, lr, b1c, b2c)
    metrics = dict(grad_norm=gnorm, lr=lr)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu), metrics


def sgd_update(params: Any, grads: Any, lr: float) -> Any:
    """Plain SGD (small tests, full-batch baselines); returns new tensors."""
    return tree_map(
        lambda p, g: (p.to(torch.float32) - lr * g.to(torch.float32)).to(
            p.dtype), params, grads)
