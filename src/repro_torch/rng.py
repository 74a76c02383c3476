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
    """Normalize a key-like (tensor, numpy array, sequence) to int64 ``[..., 2]``;
    a tensor keeps its device, anything else lands on the CPU."""
    k = torch.as_tensor(key).to(torch.int64) & MASK
    if k.shape[-1] != 2:
        raise ValueError(f"a key has 2 uint32 words, got shape {tuple(k.shape)}")
    return k


def fold_in(key, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``(0, data)`` under ``key``.  ``data`` may
    be an int or an integer tensor (one folded key per element)."""
    k = key_data(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): key ``i`` is
    ``threefry(key, (0, i))``.  Returns ``[..., num, 2]``."""
    k = key_data(key)
    i = torch.arange(num, dtype=torch.int64, device=k.device)
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


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits to ``jax.random.uniform``'s f32 on ``[0, 1)``: the top
    23 bits become the mantissa of a float in ``[1, 2)``, minus 1."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32 on ``[0, 1)``."""
    return bits_to_uniform(random_bits(key, shape, device))


_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _urem(x: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """uint32 remainder; ``x % 0`` is ``x``, as in XLA."""
    return torch.where(span == 0, x, x % torch.where(span == 0, 1, span))


def bits_to_randint(higher: torch.Tensor, lower: torch.Tensor, minval,
                    maxval) -> torch.Tensor:
    """``jax.random.randint``'s int32 draw from its two 32-bit words
    (``higher`` from the first half of the split key, ``lower`` from the
    second): ``span = maxval - minval`` as uint32 (1 where ``maxval <=
    minval``, one more where ``maxval`` is above the int32 range),
    ``multiplier = (2**16 % span)**2 % span`` and ``offset = (higher % span)
    * multiplier + lower % span`` in uint32 arithmetic that wraps mod
    2**32, then ``minval + offset % span`` in int32.  ``minval`` and
    ``maxval`` are ints or integer tensors that broadcast against the
    words."""
    dev = higher.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    out_of_range = hi > _I32_MAX
    lo = torch.clamp(lo, _I32_MIN, _I32_MAX)
    hi = torch.clamp(hi, _I32_MIN, _I32_MAX)
    span = (hi - lo) & MASK
    span = torch.where(hi <= lo, 1, span)
    span = torch.where(out_of_range & (hi > lo), (span + 1) & MASK, span)
    mult = _urem(torch.full_like(span, 1 << 16), span)
    # mult <= 2**16, so mult**2 <= 2**32 and, masked, wraps to 0 above 2**16
    mult = _urem((mult * mult) & MASK, span)
    # mult < span <= 2**16 where it is not 0: the product stays below 2**32
    offset = ((_urem(higher, span) * mult) & MASK) + _urem(lower, span)
    offset = _urem(offset & MASK, span)
    out = (lo + offset + 2 ** 31) & MASK      # int32 addition, wrapping
    return (out - 2 ** 31).to(torch.int32)


def randint(key, shape: Sequence[int], minval, maxval,
            device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32, bit for
    bit: the key splits in two, each half draws 32 bits per element
    (:func:`random_bits`), and :func:`bits_to_randint` maps them into
    ``[minval, maxval)``."""
    halves = split(key)
    bits = random_bits(halves, shape, device)   # [..., 2, *shape]
    lead = halves.dim() - 2
    return bits_to_randint(bits.select(lead, 0), bits.select(lead, 1),
                           minval, maxval)
