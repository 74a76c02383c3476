"""The sparse route's two combines held to the reference's contract, on
the CPU.

The sparse route combines a batch's frontier with the index either by a
dense ``[Q, n]`` scatter or through ``index_combine_sparse``; the
reference picks one by the batch's closed width
(``uses_scatter_combine``, ``src/repro/core/query.py``), and so does the
port.  The reference's contract between them is its
``tests/test_serving.py::test_scatter_combine_matches_sparse_combine``:
on rmat(11) with a random index, 48 vertices answered both ways give the
same indices and values within ``rtol=1e-6``.  Here both packages run
that case: each package's two combines against each other, and the
port's against the reference's.  ``tests/test_torch_cuda.py`` holds the
card's ``index_combine_sparse`` kernel to the scatter combine the same
way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import PPRIndex as JIndex
from repro.core.query import BatchQueryEngine as JEngine
from repro.core.query import QueryConfig as JConfig
from repro.graphs import synthetic as jsyn
from repro_torch import convert
from repro_torch.core.query import BatchQueryEngine, QueryConfig
from repro_torch.graphs import synthetic as tsyn

torch.set_num_threads(1)

QKW = dict(mode="powerwalk", t_iterations=2, top_k=32, frontier_k=128,
           frontier_path="sparse")
PATHS = ("scatter", "sparse")


def _random_index(n: int, l: int, seed: int) -> JIndex:
    """The reference test's index: uniform values normalised and sorted
    down each row, uniform columns."""
    kv, ki = jax.random.split(jax.random.PRNGKey(seed))
    vals = jax.random.uniform(kv, (n, l), jnp.float32)
    vals = jnp.sort(vals / vals.sum(axis=1, keepdims=True), axis=1)[:, ::-1]
    idxs = jax.random.randint(ki, (n, l), 0, n, jnp.int32)
    return JIndex(values=vals, indices=idxs, l=l, n=n)


@pytest.fixture(scope="module")
def answers():
    """Each package's answers to 48 vertices with each combine."""
    jg = jsyn.rmat(11, avg_deg=8.0, seed=2)
    tg = tsyn.rmat(11, avg_deg=8.0, seed=2, device="cpu")
    jidx = _random_index(jg.n, 16, seed=4)
    tidx = convert.index_from_arrays(jidx.values, jidx.indices, device="cpu")
    out = {}
    for path in PATHS:
        v, i = JEngine(jg, jidx, JConfig(combine_path=path, **QKW)) \
            .query_topk_async(jnp.arange(48, dtype=jnp.int32))
        out["reference", path] = (np.asarray(v), np.asarray(i))
        eng = BatchQueryEngine(tg, tidx, QueryConfig(combine_path=path,
                                                     **QKW), device="cpu")
        assert eng.uses_scatter_combine(48) == (path == "scatter")
        v, i = eng.query_topk_async(torch.arange(48, dtype=torch.int32))
        out["port", path] = (v.numpy(), i.numpy())
    return out


def _contract(a, b):
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_scatter_combine_matches_sparse_combine(answers, package):
    """Within a package: the indices equal, the values within 1e-6."""
    _contract(answers[package, "scatter"], answers[package, "sparse"])


@pytest.mark.parametrize("path", PATHS)
def test_port_combine_matches_reference_combine(answers, path):
    """The port's combine against the reference's same combine: the
    indices equal, the values within 1e-6."""
    _contract(answers["port", path], answers["reference", path])
