"""Threefry-2x32 counter-based RNG, bit-identical to ``jax.random``.

Matches ``jax.random`` with the default ``threefry2x32`` implementation and
``jax_threefry_partitionable=True``: the same key gives the same bits, so a
walk build driven from the same key reproduces the reference index bit for
bit (and later resume/repair can replay any chunk's stream).

A key is an ``int64`` tensor whose last axis holds the two uint32 words.
The uint32 arithmetic is carried in int64 with ``& 0xFFFFFFFF`` masks
(torch's uint32 op coverage is thin); every intermediate stays below 2**62.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable int64 tensors in
    ``[0, 2**32)``: ``(k1, k2)`` the key words, ``(x0, x1)`` the counter
    words.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words ``(0, seed)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def key_data(key) -> torch.Tensor:
    """Normalize a key-like (tensor, numpy array, sequence) to int64 ``[..., 2]``
    on the CPU."""
    k = torch.as_tensor(key).to(torch.int64).cpu() & MASK
    if k.shape[-1] != 2:
        raise ValueError(f"a key has 2 uint32 words, got shape {tuple(k.shape)}")
    return k


def fold_in(key, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``(0, data)`` under ``key``.  ``data`` may
    be an int or an integer tensor (one folded key per element)."""
    k = key_data(key)
    d = torch.as_tensor(data, dtype=torch.int64) & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): key ``i`` is
    ``threefry(key, (0, i))``.  Returns ``[..., num, 2]``."""
    k = key_data(key)
    i = torch.arange(num, dtype=torch.int64)
    y0, y1 = threefry2x32(
        k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i
    )
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 in ``[0, 2**32)``), shape
    ``key.shape[:-1] + shape``: the counter is the row-major element index
    split into (hi, lo) words, the output ``y0 ^ y1``."""
    k = key_data(key).to(device)
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    cnt = torch.arange(size, dtype=torch.int64, device=device)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(*lead, 1)
    k2 = k[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k1, k2, cnt >> 32, cnt & MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32 on ``[0, 1)``: the top 23
    bits become the mantissa of a float in ``[1, 2)``, minus 1."""
    bits = random_bits(key, shape, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0
