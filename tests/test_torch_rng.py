"""repro_torch.rng: threefry-2x32 bit for bit against jax.random.

Both packages run on the CPU; keys and shapes come from fixed numbers, and
every comparison is on the raw uint32 words or float bits.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert, rng

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 2**31 - 1, 123456789]


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _port(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    assert np.array_equal(_port(rng.prng_key(seed)),
                          _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 5, 4096, 2**32 - 1])
def test_fold_in_bitwise(seed, data):
    want = _words(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = _port(rng.fold_in(rng.prng_key(seed), data))
    assert np.array_equal(got, want)


def test_fold_in_vector_of_data():
    key = jax.random.PRNGKey(3)
    data = np.array([0, 3, 8, 1 << 20], np.int64)
    want = np.stack([_words(jax.random.fold_in(key, int(d))) for d in data])
    got = _port(rng.fold_in(rng.prng_key(3), torch.from_numpy(data)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bitwise(seed, num):
    want = _words(jax.random.split(jax.random.PRNGKey(seed), num))
    got = _port(rng.split(rng.prng_key(seed), num))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (4, 2, 9), (64, 100)])
def test_uniform_bitwise(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = np.asarray(jax.random.uniform(key, shape))
    got = rng.uniform(convert.key_from_array(jax.random.key_data(key)), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_uniform_batched_keys_match_vmap():
    """A stack of keys draws like ``vmap(uniform)`` — the walk engine's
    per-step draw (``walks.round_uniforms``)."""
    base = jax.random.PRNGKey(5)
    keys = jax.vmap(lambda t: jax.random.split(jax.random.fold_in(base, t)))(
        np.arange(3, 7))
    want = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (4, 6))))(keys)
    pkeys = rng.split(rng.fold_in(rng.prng_key(5), torch.arange(3, 7)))
    got = rng.uniform(pkeys, (4, 6))
    assert tuple(got.shape) == (4, 2, 4, 6)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))


def test_key_from_array_rejects_bad_shape():
    with pytest.raises(ValueError):
        convert.key_from_array(np.zeros(3, np.uint32))
