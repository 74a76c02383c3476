"""no-replicated-index violations: a build step stacked on its model
shards whose every shard holds (and returns) the whole ``[n, L]`` index —
what a gather-then-broadcast build would run — and a step that returns
its rows unstacked, with no shard axis to audit."""

import torch


def replicated_step(ep: int, n: int, l: int):
    def fn(contrib: torch.Tensor):
        out = torch.empty((ep, n, l), dtype=torch.float32)
        for me in range(ep):
            out[me] = contrib.sum()
        return (out,)
    return fn


def unstacked_step(ep: int, n: int, l: int):
    def fn(contrib: torch.Tensor):
        return (torch.zeros((n // ep, l)) + contrib.sum(),)
    return fn
