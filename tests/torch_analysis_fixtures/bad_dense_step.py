"""dense-state-bound violation: a walk chunk whose step holds an
``f32[rows, n]`` accumulator — what the sparse build must never hold."""

import torch


def dense_chunk(rows: torch.Tensor, n: int) -> torch.Tensor:
    # a [rows, n]-dense accumulator
    acc = torch.zeros((rows.shape[0], n), dtype=torch.float32)
    return acc.index_add_(1, rows.long() % n, torch.ones(
        rows.shape[0], rows.shape[0])).sum(dim=1)
