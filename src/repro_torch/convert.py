"""Carry state across from the JAX package: numpy arrays -> port objects.

The reference's arrays are passed in as numpy (``np.asarray(jax_array)``),
so nothing here imports JAX.  The parity tests use these to feed both
packages the same graph, index, PRNG key and model parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed_engine import ShardedGraph
from repro_torch.core.graph import Graph
from repro_torch.core.index import PPRIndex
from repro_torch.device import resolve_device


def graph_from_arrays(row_ptr, col_idx, src, out_deg, n: int, m: int,
                      device="cuda") -> Graph:
    """A :class:`Graph` holding exactly the given CSR/COO arrays."""
    dev = resolve_device(device)
    as_t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(a, dtype=np.int32, copy=True)).to(dev)
    return Graph(row_ptr=as_t(row_ptr), col_idx=as_t(col_idx), src=as_t(src),
                 out_deg=as_t(out_deg), n=int(n), m=int(m))


def index_from_arrays(values, indices, device="cuda") -> PPRIndex:
    """A :class:`PPRIndex` from ``values f32[n, L]`` / ``indices int32[n, L]``."""
    dev = resolve_device(device)
    v = torch.from_numpy(np.array(values, dtype=np.float32, copy=True)).to(dev)
    i = torch.from_numpy(np.array(indices, dtype=np.int32, copy=True)).to(dev)
    n, l = v.shape
    return PPRIndex(values=v, indices=i, l=int(l), n=int(n))


def key_from_array(key) -> torch.Tensor:
    """A port PRNG key from the reference's raw ``uint32[2]`` key data."""
    k = np.asarray(key).astype(np.uint32).astype(np.int64)
    if k.shape != (2,):
        raise ValueError(f"expected a raw uint32[2] key, got shape {k.shape}")
    return torch.from_numpy(k)


def sharded_graph_from_arrays(row_ptr, col_idx, edge_w, dangling,
                              device="cuda") -> ShardedGraph:
    """A :class:`ShardedGraph` holding exactly the reference's stacked
    slabs (``row_ptr int32[ep, ns + 1]``, ``col_idx int32[ep, m_shard]``,
    ``edge_w f32[ep, *]``, ``dangling f32[ep, ns]``)."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(  # noqa: E731
        np.array(a, dtype=dt, copy=True)).to(dev)
    return ShardedGraph(
        row_ptr=as_t(row_ptr, np.int32), col_idx=as_t(col_idx, np.int32),
        edge_w=as_t(edge_w, np.float32), dangling=as_t(dangling, np.float32))


def sharded_index_from_arrays(values, indices, ep: int, device="cuda",
                              shards=None):
    """An ``[n_pad, L]`` index as the engine's vertex-sharded ``(values
    f32[S, n_pad / ep, L], indices int32[S, n_pad / ep, L])``: every one of
    the ``ep`` shards (``S = ep``), or the listed model ``shards`` in that
    order (a rank's own: ``RankMesh.local_model``)."""
    values, indices = np.asarray(values), np.asarray(indices)
    n, l = values.shape
    if n % ep:
        raise ValueError(f"{n} index rows do not split over {ep} shards")
    keep = list(range(ep) if shards is None else shards)
    index = index_from_arrays(
        values.reshape(ep, n // ep, l)[keep].reshape(-1, l),
        indices.reshape(ep, n // ep, l)[keep].reshape(-1, l), device=device)
    return (index.values.reshape(len(keep), n // ep, l),
            index.indices.reshape(len(keep), n // ep, l))


def params_from_arrays(tree, device="cuda"):
    """The port's parameters of any ported model (``smollm-135m``, DLRM
    RM2, DCN-v2, SASRec, MIND) from the reference's parameter pytree given
    as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``):
    the same nesting and names, each array copied into a tensor of its
    dtype.  Dense weights keep the reference's ``[d_in, d_out]`` layout and
    the transformer's layers their leading ``n_layers`` axis, so nothing is
    transposed.  A KV cache (``k``, ``v``, ``length``) crosses the same
    way."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_arrays(v, dev) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


recsys_params_from_arrays = params_from_arrays
dlrm_params_from_arrays = params_from_arrays
