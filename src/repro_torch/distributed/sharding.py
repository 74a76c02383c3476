"""Per-arch sharding policy: parameter, batch and cache partition specs.

The counterpart of ``repro.distributed.sharding``, over the port's trees
and a :class:`~repro_torch.distributed.mesh.ShardMesh`.  Axis roles:

* ``model``: tensor, expert and vertex parallelism;
* ``data``: data parallelism and the ZeRO/FSDP shard of parameters and
  optimizer state.  The reference's ``pod`` axis (more data parallelism
  across pods) is folded into ``data``, as ``launch/mesh.py`` folds it.

A spec is a :class:`P`, a tuple with one entry a tensor axis: an axis
name, a tuple of them, or ``None`` (replicated).  The rules are path
based over the parameter tree, whose names are the reference's, so
``_lm_spec`` is its rule table as written.  Uneven dimensions are
allowed (GSPMD pads them: qwen's 40 heads over a 16-way axis); a shard
then holds the ceiling, as :func:`shard` and :func:`per_device_bytes`
count it.

:func:`shard` lays a whole tensor out on a stacked mesh as per-shard
blocks ``[data, model, *block]``, the layout every stacked collective of
``ShardMesh`` takes; it is the port's ``named``.  On a
:class:`~repro_torch.distributed.mesh.RankMesh` it gives the rank's own
block ``[1, 1, *block]``.

A rank's train state is laid out by :func:`rank_param_specs`: every LM
leaf by its ``_lm_spec`` (the reference's ``lm_param_specs`` on a large
LM), tensor parallel over ``model`` and FSDP over ``data``, with one
departure where a config's kv heads do not split over ``model`` (see
:func:`rank_leaf_spec`).  :func:`rank_blocks` cuts a whole tree to a
rank's blocks, :func:`assemble` gathers a rank's block back into the
whole, :func:`distinct_blocks` names the blocks a sum over the mesh counts
once each, and :func:`batch_split` says whether a batch's rows split over
``data`` (``batch_spec_lm``'s rule).
"""

from __future__ import annotations

import math
import re
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves


class P(tuple):
    """A partition spec: ``P("data", None)``; entries are axis names,
    tuples of them, or ``None``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


AXES = ("data", "model")


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ``("data",)`` (``pod`` is folded in)."""
    return ("data",)


def data_axis_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def model_axis_size(mesh) -> int:
    return int(mesh.shape["model"])


# ---------------------------------------------------------------------------
# LM transformer params
# ---------------------------------------------------------------------------

def _lm_spec(path: str, ndim: int, stacked: bool) -> P:
    """PartitionSpec for one transformer param.

    ``stacked`` params carry a leading n_layers dim (inside
    params['layers']).  2-D policy: TP over 'model' on the
    contraction-free big dim, FSDP over 'data' on the other: every large
    tensor is fully sharded.
    """
    lead: Tuple = (None,) if stacked else ()

    def spec(*axes):
        return P(*(lead + axes))

    if "embed" in path:                       # [V, d]
        return P("model", "data")
    if "lm_head" in path:                     # [d, V]
        return P("data", "model")
    if re.search(r"w[qkv]/w$", path):         # [d, H*hd]
        return spec("data", "model")
    if re.search(r"w[qkv]/b$", path):         # [H*hd]
        return spec("model")
    if path.endswith("wo/w"):                 # [H*hd, d]
        return spec("model", "data")
    if path.endswith("wo/b"):
        return spec("data")
    if "router" in path:                      # [d, E] small
        return spec(None, None)
    if re.search(r"w_(gate|up)/w$", path):    # dense ffn [d, ff]
        return spec("data", "model")
    if path.endswith("w_down/w"):             # [ff, d]
        return spec("model", "data")
    if re.search(r"w_(gate|up)/b$", path):
        return spec("model")
    if path.endswith("w_down/b"):
        return spec("data")
    if re.search(r"w_(gate|up)$", path):      # MoE [E, d, ffs]
        return spec("model", "data", None)
    if path.endswith("w_down"):               # MoE [E, ffs, d]
        return spec("model", None, "data")
    # norms / scalars / anything small: replicate
    return P(*([None] * ndim))


def lm_leaf_spec(path: str, ndim: int) -> P:
    """The spec of the LM leaf at ``path`` (``"layers/wq/w"``), padded or
    cut to its ``ndim`` axes."""
    base = _lm_spec(path, ndim, "layers" in path)
    axes = tuple(base) + (None,) * (ndim - len(base))
    return P(*axes[:ndim])


def lm_is_small(config) -> bool:
    """Models too narrow for 16-way TP (smollm): the model axis is better
    spent on sequence parallelism with replicated params."""
    return getattr(config, "d_model", 1 << 30) < 2048


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, paths joined with ``/``
    (the reference's ``_path_str``)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def _replicated(leaf) -> P:
    return P(*([None] * len(leaf.shape)))


def lm_param_specs(params_shape: Any, config=None) -> Any:
    if config is not None and lm_is_small(config):
        return _map_with_path(lambda _, leaf: _replicated(leaf),
                              params_shape)
    return _map_with_path(lambda p, leaf: lm_leaf_spec(p, len(leaf.shape)),
                          params_shape)


# ---------------------------------------------------------------------------
# GNN / RecSys params
# ---------------------------------------------------------------------------

def gnn_param_specs(params_shape: Any) -> Any:
    """GCN weights are tiny (d_hidden 16): replicate everything."""
    return _map_with_path(lambda _, leaf: _replicated(leaf), params_shape)


def recsys_param_specs(params_shape: Any) -> Any:
    """Embedding tables row-sharded over 'model' + FSDP'd big MLPs, each
    dim sharded only if the 16-way axis divides it (the reference's
    explicit in_shardings need exact divisibility)."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        if ("table" in path and len(shape) == 2 and shape[0] >= 4096
                and shape[0] % 16 == 0):
            return P("model", None)
        if len(shape) == 2 and shape[0] * shape[1] >= 1 << 18:
            d0 = "data" if shape[0] % 16 == 0 else None
            d1 = "model" if shape[1] % 16 == 0 else None
            return P(d0, d1)
        return _replicated(leaf)
    return _map_with_path(one, params_shape)


def param_specs(family: str, params_shape: Any, config=None) -> Any:
    if family == "lm":
        return lm_param_specs(params_shape, config)
    return {
        "gnn": gnn_param_specs,
        "recsys": recsys_param_specs,
    }[family](params_shape)


# ---------------------------------------------------------------------------
# Optimizer state & batches
# ---------------------------------------------------------------------------

def opt_state_specs(pspec_tree: Any) -> Any:
    """AdamState(step, mu, nu): moments follow their param's spec."""
    from repro_torch.training.optimizer import AdamState
    return AdamState(step=P(), mu=pspec_tree, nu=pspec_tree)


def batch_spec_lm(mesh, kind: str, batch: int) -> dict:
    ba = batch_axes(mesh)
    b_ax = ba if batch >= data_axis_size(mesh) else None
    if kind == "lm_train":
        return dict(tokens=P(b_ax, None), labels=P(b_ax, None),
                    mask=P(b_ax, None))
    if kind == "lm_prefill":
        return dict(tokens=P(b_ax, None))
    raise ValueError(kind)


def cache_spec(mesh, batch: int, quantized: bool = False) -> dict:
    """KV cache [L, B, S, H, hd]: B over data (if it divides), S over model.

    When the batch can't use the data axes (long_500k: B=1), the head_dim
    takes them instead (always 64/128, so always divisible; kv-head
    counts like 8 or 40 are not), so the data replicas do not idle while
    one model group holds the whole cache.
    """
    ba = batch_axes(mesh)
    small_b = batch < data_axis_size(mesh)
    b_ax = None if small_b else ba
    d_ax = ba if small_b else None
    kv = P(None, b_ax, "model", None, d_ax)
    out = dict(k=kv, v=kv, length=P())
    if quantized:
        out["k_scale"] = P(None, b_ax, "model", None)
        out["v_scale"] = P(None, b_ax, "model", None)
    return out


# ---------------------------------------------------------------------------
# Layout on a stacked mesh
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    for a in names:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r} (the port's mesh has "
                             f"{AXES})")
    return names


def _ways(entry, mesh) -> int:
    return math.prod(mesh.shape[a] for a in _entry_axes(entry))


def block_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One shard's block of a ``shape`` tensor under ``spec``: each sharded
    dimension's ceiling over its axes' ways (the padding GSPMD adds)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // _ways(e, mesh)) for n, e in zip(shape, spec))


def shard(tensor: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``tensor`` laid out on the stacked ``mesh`` as per-shard blocks
    ``[data, model, *block]`` (:func:`block_shape`): shard ``(i, j)``
    holds the slice its coordinates give along each sharded dimension,
    zero padded past the end where the axes do not divide it, and the
    whole extent along a replicated one.  Where nothing pads, it is a view
    of ``tensor`` (replicas share its memory).  On a
    :class:`~repro_torch.distributed.mesh.RankMesh`, the rank's own block
    of that layout, ``[1, 1, *block]``."""
    spec = tuple(spec) + (None,) * (tensor.dim() - len(spec))
    if len(spec) != tensor.dim():
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{tensor.dim()} axes")
    used = [a for e in spec for a in _entry_axes(e)]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} names a mesh axis twice")
    blk = block_shape(tensor.shape, spec, mesh)
    pad = []
    for n, b, e in zip(tensor.shape, blk, spec):
        pad = [0, b * _ways(e, mesh) - n] + pad
    x = torch.nn.functional.pad(tensor, pad) if any(pad) else tensor
    # split each sharded dim into (its axes' sizes..., block), in order
    split, where = [], {}
    for n, b, e in zip(x.shape, blk, spec):
        for a in _entry_axes(e):
            where[a] = len(split)
            split.append(mesh.shape[a])
        split.append(b)
    x = x.reshape(split)
    blocks = [i for i in range(len(split)) if i not in where.values()]
    for a in AXES:                       # an unused axis: a replica axis
        if a not in where:
            x = x.unsqueeze(0)
            where = {k: v + 1 for k, v in where.items()}
            blocks = [i + 1 for i in blocks]
            where[a] = 0
    x = x.permute([where[a] for a in AXES] + blocks)
    x = x.expand(mesh.data, mesh.model, *x.shape[2:])
    if not is_rank_mesh(mesh):
        return x
    d, m = mesh.local_data[0], mesh.local_model[0]
    return x[d:d + 1, m:m + 1]


def is_rank_mesh(mesh) -> bool:
    from repro_torch.distributed.mesh import RankMesh

    return isinstance(mesh, RankMesh)


def _spec_tree_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _spec_tree_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def kv_heads_split(config, mesh) -> bool:
    """Whether ``config``'s kv heads split over ``mesh``'s ``model``
    axis."""
    return config.n_kv_heads % mesh.model == 0


def rank_leaf_spec(path: str, ndim: int, config, mesh) -> P:
    """The spec of the LM leaf at ``path`` on a ``(data, model)`` mesh: its
    ``lm_leaf_spec`` (``wq``/``wk``/``wv`` column parallel, ``wo`` row
    parallel, the dense FFN's ``w_gate``/``w_up`` column and ``w_down``
    row parallel, the embedding ``(model, data)`` and the head ``(data,
    model)``, the expert stacks over experts and ``d``; norms and the
    router whole), except where ``config``'s kv heads do not split over
    ``mesh``'s ``model`` axis (the reduced dbrx and grok, 2 kv heads, on
    1 x 4): ``wk``/``wv`` then stay whole over ``model`` (``w`` split over
    ``data`` only, ``b`` whole) and each model shard takes the kv heads
    its query heads read.  The reference's GSPMD splits such a dimension
    mid-head and reshards it before the attention, which gives the same
    numbers; a shard of the port computes whole heads only."""
    spec = lm_leaf_spec(path, ndim)
    if (re.search(r"(^|/)w[kv]/[wb]$", path)
            and not kv_heads_split(config, mesh)):
        return P(*(None if a == "model" else a for a in spec))
    return spec


def rank_param_specs(params: Any, config, mesh) -> Any:
    """The layout of an LM's state on a ``(data, model)`` mesh: each leaf's
    :func:`rank_leaf_spec` (``config`` and ``mesh`` decide the kv heads'
    rule).  A small LM (``lm_is_small``: smollm-135m) stays whole, as the
    reference keeps it: ``launch.steps.build`` lays it out by
    :func:`lm_param_specs` with its published config."""
    return _map_with_path(
        lambda p, leaf: rank_leaf_spec(p, len(leaf.shape), config, mesh),
        params)


def batch_split(rows: int, mesh) -> bool:
    """Whether a batch of ``rows`` splits over ``data`` (``batch_spec_lm``'s
    ``b_ax``): where the rows reach the axis's size and divide by it, data
    shard ``d`` takes the ``d``-th contiguous share; else every data shard
    takes them all (a one-row decode, a microbatch narrower than
    ``data``)."""
    return rows >= mesh.data and rows % mesh.data == 0


def rank_block(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``mesh``'s rank's block of the whole ``leaf`` under ``spec`` (its own
    copy; a replicated leaf as it is); on a stacked mesh ``leaf``."""
    if not is_rank_mesh(mesh) or is_replicated(spec):
        return leaf
    return shard(leaf, spec, mesh)[0, 0].clone()


def assemble(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from ``mesh``'s rank's ``block`` under ``spec``, its
    group's blocks gathered along each sharded dimension (every dimension
    a multiple of its axes' ways); on a stacked mesh ``block`` is the
    whole."""
    if not is_rank_mesh(mesh):
        return block
    x = block[None, None]
    spec = tuple(spec) + (None,) * (block.dim() - len(spec))
    for dim, entry in enumerate(spec):
        for axis in reversed(_entry_axes(entry)):    # the inner axis first
            x = mesh.all_gather_axis(x, axis, dim)
    return x[0, 0]


def is_replicated(spec) -> bool:
    return not any(_entry_axes(e) for e in spec)


def rank_blocks(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s whole leaves cut to ``mesh``'s rank's blocks under
    ``specs`` (:func:`rank_block`); on a stacked mesh ``tree`` itself."""
    if not is_rank_mesh(mesh):
        return tree
    return _spec_tree_map(lambda leaf, spec: rank_block(leaf, spec, mesh),
                          tree, specs)


def distinct_blocks(spec, mesh) -> list:
    """The ``(data, model)`` shards whose blocks of a leaf under ``spec``
    are its distinct parts, in shard order: every shard along the axes the
    spec uses, the first along a replica axis."""
    used = {a for e in spec for a in _entry_axes(e)}
    return [(d, m) for d in range(mesh.data if "data" in used else 1)
            for m in range(mesh.model if "model" in used else 1)]


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree``'s tensors laid out by ``specs``
    (a tree of the same nesting), each sharded dimension at its ceiling."""
    leaves = tree_leaves(tree)
    spec_leaves = _spec_leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(leaves)} tensors but {len(spec_leaves)} "
                         "specs")
    return sum(math.prod(block_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, spec_leaves))


def _spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in the tree's flatten order (a spec is a
    tuple, so the tree walk would open it)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, (tuple, list)):
        return [s for c in specs for s in _spec_leaves(c)]
    raise TypeError(f"not a spec tree: {type(specs)}")

