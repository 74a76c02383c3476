"""Shared layers: plain functions over dicts of tensors, as in the reference.

Parameters stay f32 and are cast to the compute dtype at use.  A dense
weight keeps the reference's ``[d_in, d_out]`` layout (so ``y = x @ w``),
which lets ``convert.dlrm_params_from_arrays`` carry the reference's
parameters across without a transpose.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int):
    """``w`` of ``N(0, 1/d_in)`` on the generator's device, ``b`` zeros."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device) / math.sqrt(d_in)
    return {"w": w, "b": torch.zeros((d_out,), dtype=torch.float32,
                                     device=gen.device)}


def dense_apply(p, x, *, compute_dtype):
    """``x @ w + b``, each operand cast to ``compute_dtype`` first."""
    dt = compute_dtype
    return x.to(dt) @ p["w"].to(dt) + p["b"].to(dt)


def mlp_init(gen: torch.Generator, dims: Sequence[int]):
    """Plain MLP tower: ``layer_i`` maps ``dims[i] -> dims[i + 1]``."""
    return {f"layer_{i}": dense_init(gen, dims[i], dims[i + 1])
            for i in range(len(dims) - 1)}


def mlp_apply(p, x, *, compute_dtype,
              final_act: Optional[Callable] = None):
    """Dense layers with a ReLU between them and ``final_act`` (if any)
    after the last."""
    n = len(p)
    for i in range(n):
        x = dense_apply(p[f"layer_{i}"], x, compute_dtype=compute_dtype)
        if i < n - 1:
            x = torch.relu(x)
        elif final_act is not None:
            x = final_act(x)
    return x
