"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips where there is no GPU.  The
checks themselves live in ``chip_smoke.py`` (phases 2a and 4), so the smoke
run and these tests hold the kernels to the same inputs.  The file imports
neither JAX nor ``conftest`` helpers, so on a machine with a card and no
JAX it runs on its own:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Synthetic inputs are dyadic (masses ``j / 1024``, power-of-two degrees at
``c = 0.5``), so every f32 sum is exact in any order and the kernels must
agree with the plain versions bit for bit, indices included.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.graphs import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import walk_step as walk_k

_spec = importlib.util.spec_from_file_location(
    "chip_smoke",
    os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_walk_step_kernel_bitwise_on_card(cuda):
    """The wrapper launches the kernel once, with one source per row."""
    r = np.random.default_rng(0)
    tg = tsyn.erdos_renyi(4096, 5.0, seed=3, device=cuda)
    rows, w = 1000, 100
    args = [torch.from_numpy(x).to(cuda) for x in (
        r.integers(0, tg.n, (rows, w)).astype(np.int32),
        r.integers(0, tg.n, (rows, 1)).astype(np.int32),
        r.random((rows, w)).astype(np.float32))]
    args += [tg.row_ptr, tg.out_deg, tg.col_idx]
    tops.reset_launch_counts()
    got = tops.walk_step(*args)
    assert tops.launch_counts()["walk_step"] == 1
    assert torch.equal(got, walk_k.walk_step_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(chip_smoke.SYNTHETIC_CHECKS))
def test_kernel_bit_equal_on_card(cuda, kernel):
    assert chip_smoke.SYNTHETIC_CHECKS[kernel](torch, np, cuda)


@pytest.mark.cuda
def test_build_and_query_on_card_match_the_cpu(cuda):
    """The whole slice on the card against its plain CPU path: the index
    bit for bit, the answers within 1e-5 L1."""
    index_equal, l1 = chip_smoke.check_small_reference(torch, np, cuda)
    assert index_equal
    assert l1 <= 1e-5
