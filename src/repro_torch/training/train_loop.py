"""Train-step factory: loss and gradients -> (compressed) gradients -> AdamW.

The reference's ``training/train_loop.py``: optional microbatch gradient
accumulation (a Python loop over the batch's leading-axis slices,
accumulated in ``accum_dtype`` in microbatch order, in place, each
microbatch's gradients freed before the next), a pluggable gradient
transform (the compression module's quantizers), and the metrics ``loss``,
the loss's aux entries, ``grad_norm`` and ``lr`` every step.  The gradients
come from ``torch.autograd.grad`` over the parameter leaves; the step then
writes the parameters and the optimizer's moments in place under
``no_grad`` (the reference donates their buffers).

The reference's ``grad_pspecs`` shard the gradient accumulator the way
the parameters are sharded.  Here ``mesh=`` with ``specs=`` is its
counterpart, the parameters laid out by ``sharding.rank_param_specs``
(the reference's 2-D layout of an LM: tensor parallel over ``model``,
FSDP over ``data``): on a ``RankMesh`` each rank's parameters,
gradients, accumulator and moments are its blocks of every leaf (a norm
scale or the router whole), the accumulator in ``accum_dtype``, and
``grad_norm`` is taken over the distinct blocks of every rank
(``optimizer.global_norm``); on a stacked ``ShardMesh`` the leaves are
whole and the norm is taken by the same blocks, so both give the same
bits.  Microbatch ``i`` is the batch's rows ``[i B / mb, (i + 1) B /
mb)``, as the reference slices them, and the loss on the mesh gives data
shard ``d`` its contiguous share of those rows.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.training import optimizer as opt_mod
from repro_torch.training.optimizer import AdamState, AdamWConfig
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


def value_and_grad(loss_fn: Callable[[Any, Any], Any]):
    """``grads_of(params, batch) -> (loss, aux, grads)`` for ``loss_fn(params,
    batch)`` returning a scalar or ``(scalar, aux dict)``: the gradient of
    every parameter leaf (zeros for a leaf the loss does not use), in the
    structure of ``params``; ``params`` are not modified."""

    def grads_of(params, batch):
        leaves, treedef = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            out = loss_fn(tree_unflatten(treedef, live), batch)
            loss, aux = out if isinstance(out, tuple) else (out, {})
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        aux = {k: v.detach() for k, v in aux.items()}
        return loss.detach(), aux, tree_unflatten(treedef, grads)

    return grads_of


def make_train_step(
    loss_fn: Callable[[Any, Any], Any],
    opt_cfg: AdamWConfig,
    *,
    grad_transform: Optional[Callable[[Any], Any]] = None,
    microbatches: int = 1,
    accum_dtype=torch.float32,
    mesh=None,
    specs=None,
):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``params`` and the moments are updated in place.
    ``mesh``: the LM's parameters are laid out on that mesh by ``specs``
    (``sharding.rank_param_specs``), whose blocks the gradient norm sums;
    ``loss_fn`` is the mesh's own (``loss_fn(..., mesh=mesh)``)."""
    if mesh is not None and specs is None:
        raise ValueError("make_train_step(mesh=) needs the parameters' "
                         "layout: specs=sharding.rank_param_specs(params, "
                         "config, mesh)")
    grads_of = value_and_grad(loss_fn)

    def train_step(params, opt_state: AdamState, batch):
        if microbatches > 1:
            leaves = tree_leaves(params)
            acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                   for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            micro = tree_map(lambda x: x.reshape(
                (microbatches, x.shape[0] // microbatches)
                + tuple(x.shape[1:])), batch)
            for i in range(microbatches):
                mb_loss, _, grads = grads_of(
                    params, tree_map(lambda x: x[i], micro))
                with torch.no_grad():     # in place, a block at a time
                    for a, g in zip(acc, tree_leaves(grads)):
                        for ab, gb in opt_mod.leaf_blocks(a, g):
                            ab.copy_(ab.to(torch.float32)
                                     + gb.to(torch.float32))
                del grads
                loss = loss + mb_loss
            loss = loss / microbatches
            for a in acc:
                a.div_(microbatches)
            grads = tree_unflatten(tree_flatten(params)[1], acc)
            aux = {}
        else:
            loss, aux, grads = grads_of(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, new_state, om = opt_mod.update(opt_cfg, grads, opt_state,
                                               params, mesh=mesh, specs=specs)
        metrics = dict(loss=loss, **aux, **om)
        return params, new_state, metrics

    return train_step


def init_state(opt_cfg: AdamWConfig, params) -> AdamState:
    return opt_mod.init(opt_cfg, params)
