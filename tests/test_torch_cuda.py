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
    bit for bit, the answers of the sparse and the dense route within 1e-5
    L1."""
    index_equal, l1, l1_dense = chip_smoke.check_small_reference(
        torch, np, cuda)
    assert index_equal
    assert l1 <= 1e-5
    assert l1_dense <= 1e-5


@pytest.mark.cuda
def test_dense_push_and_combine_launch_their_kernels(cuda):
    """On CUDA tensors the dense wrappers launch their kernels, once per
    call, and agree with the plain versions on the CPU."""
    r = np.random.default_rng(1)
    g = tsyn.rmat(10, avg_deg=6.0, seed=2, device=cuda)
    f = r.random((5, g.n)).astype(np.float32)
    vals = r.random((g.n + 3, 8)).astype(np.float32)
    idx = r.integers(0, g.n, (g.n + 3, 8)).astype(np.int32)
    tops.reset_launch_counts()
    push = tops.ell_push(torch.from_numpy(f).to(cuda), g.ell())
    comb = tops.index_combine(*(torch.from_numpy(x).to(cuda)
                                for x in (f, f, vals, idx)))
    counts = tops.launch_counts()
    assert counts["ell_spmm"] == 1 and counts["index_combine"] == 1
    want = tops.ell_push(torch.from_numpy(f), g.to("cpu").ell())
    assert torch.allclose(push.cpu(), want, rtol=1e-5, atol=1e-6)
    want = tops.index_combine(*(torch.from_numpy(x)
                                for x in (f, f, vals, idx)))
    assert torch.allclose(comb.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_distributed_engine_on_card_matches_the_cpu(cuda):
    """The sharded build bit for bit, the sparse tile step within 1e-5 L1
    of the plain CPU path, the dense exchange within 1e-4 L1 of the sparse
    one at covering widths."""
    build_equal, l1, l1_exchange = chip_smoke.check_small_distributed(
        torch, np, cuda)
    assert build_equal
    assert l1 <= 1e-5
    assert l1_exchange <= 1e-4


@pytest.mark.cuda
def test_tile_step_launches_the_push_once_per_shard_and_iteration(cuda):
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, make_verd_tile_step)
    from repro_torch.core.index import build_index
    from repro_torch.core.verd import resolve_degree_cap
    from repro_torch.distributed import ShardMesh
    from repro_torch import rng

    g = tsyn.rmat(10, avg_deg=6.0, seed=2, device=cuda)
    index, _ = build_index(g, r=16, l=16, key=rng.prng_key(1), device=cuda)
    cfg = DistConfig(n=g.n, ep=4, q_tile=8, t_iterations=3, index_l=16,
                     top_k=20, degree_cap=resolve_degree_cap(g))
    step = make_verd_tile_step(cfg, ShardMesh(1, 4, device=cuda))
    slabs = build_sharded_graph(g, cfg, device=cuda)
    shape = (4, g.n // 4, 16)
    sources = torch.arange(0, 64, 8, dtype=torch.int32, device=cuda)
    tops.reset_launch_counts()
    v, _ = step(slabs, sources, index.values.reshape(shape),
                index.indices.reshape(shape))
    assert tops.launch_counts()["sharded_frontier_push"] == 3 * 4
    assert bool(torch.isfinite(v).all()) and bool((v >= 0).all())


@pytest.mark.cuda
def test_dlrm_on_card_matches_the_cpu(cuda):
    """DLRM RM2's reduced config in f32, card against the plain CPU path
    from the same parameters: logits within 1e-5 of their largest."""
    assert chip_smoke.check_small_dlrm(torch, np, cuda) <= 1e-5


@pytest.mark.cuda
def test_dlrm_forward_launches_embedding_bag_once(cuda):
    """One ``embedding_bag`` launch per forward, and at bf16 the card's
    lookup is bit-equal to the CPU's (each row one rounding of itself)."""
    from repro_torch.configs import dlrm_rm2
    from repro_torch.launch import steps
    from repro_torch.models.recsys import embedding as temb

    bundle = steps.build("dlrm-rm2", "serve_p99", reduced=True, device=cuda,
                         config_overrides=dict(compute_dtype=torch.bfloat16))
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    tops.reset_launch_counts()
    out = bundle.step_fn(params, batch)
    assert tops.launch_counts()["embedding_bag"] == 1
    assert out.shape == (32,) and bool(torch.isfinite(out).all())
    emb_cfg = dlrm_rm2.reduced().embedding
    got = temb.lookup(emb_cfg, params["embedding"], batch["sparse_ids"],
                      torch.bfloat16)
    want = temb.lookup(emb_cfg, chip_smoke.tree_to(params["embedding"], "cpu"),
                       batch["sparse_ids"].cpu(), torch.bfloat16)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_montecarlo_on_card_matches_the_cpu(cuda):
    """The Monte-Carlo path at rmat(14), card against the plain CPU path,
    bit for bit: the legacy build, the dense and sparse MCFP and MCEP
    estimates, mcfp-mode answers at four dispatch keys and randint."""
    equal = chip_smoke.check_small_montecarlo(torch, np, cuda)
    assert all(equal.values()), equal


@pytest.mark.cuda
def test_mcfp_mode_answers_identical_across_pipeline_depths(cuda):
    """mcfp answers fold each dispatch's sequence number into the key and
    count walks with exact integer sums: rmat(14) served at pipeline
    depths 1 and 4 gives the same bytes."""
    from repro_torch.core.query import QueryConfig
    from repro_torch.serving import PPRService, ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    g = tsyn.rmat(14, avg_deg=10.0, seed=3, device=cuda)
    work = np.random.default_rng(2).integers(0, g.n, 256).tolist()
    runs = []
    for depth in (1, 4):
        svc = PPRService(g, None, ServiceConfig(
            query=QueryConfig(mode="mcfp", r_online=200, top_k=50),
            batching=BatchingConfig(max_batch=64, max_wait_s=60.0),
            pipeline=PipelineConfig(depth=depth)), device=cuda)
        answers, _ = svc.run_closed_loop(work)
        by_id = sorted(answers, key=lambda a: a.request_id)
        runs.append([np.stack([getattr(a, k) for a in by_id])
                     for k in ("top_scores", "top_vertices")])
    for a, b in zip(*runs):
        assert a.tobytes() == b.tobytes()


@pytest.mark.cuda
def test_dense_route_answers_identical_across_pipeline_depths(cuda):
    """The dense route's kernels sum every entry in a fixed order, so
    rmat(14) served at pipeline depths 1 and 4 gives the same bytes (the
    reference's contract, ``tests/test_serving.py``)."""
    from repro_torch import rng
    from repro_torch.core.index import build_index
    from repro_torch.core.query import QueryConfig
    from repro_torch.serving import PPRService, ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    g = tsyn.rmat(14, avg_deg=10.0, seed=3, device=cuda)
    index, _ = build_index(g, r=32, l=64, key=rng.prng_key(5),
                           source_batch=1024, device=cuda)
    work = np.random.default_rng(2).integers(0, g.n, 600).tolist()
    runs = []
    for depth in (1, 4):
        svc = PPRService(g, index, ServiceConfig(
            query=QueryConfig(t_iterations=2, top_k=50),
            batching=BatchingConfig(max_batch=64),
            pipeline=PipelineConfig(depth=depth)), device=cuda)
        assert svc.frontier_path == "dense"
        tops.reset_launch_counts()
        answers, _ = svc.run_closed_loop(work)
        assert tops.launch_counts()["index_combine"] > 0
        by_id = sorted(answers, key=lambda a: a.request_id)
        runs.append([np.stack([getattr(a, k) for a in by_id])
                     for k in ("top_scores", "top_vertices")])
    for a, b in zip(*runs):
        assert a.tobytes() == b.tobytes()


@pytest.mark.cuda
def test_sparse_route_answers_identical_across_pipeline_depths(cuda):
    """With ``combine_path="sparse"`` the sparse route's final combine is
    ``index_combine_sparse`` (at rmat(14) and Q <= 64 the default is the
    scatter), which sums every column in candidate order with no float
    atomics: rmat(14) served at pipeline depths 1 and 4 gives the same
    bytes."""
    from repro_torch import rng
    from repro_torch.core.index import build_index
    from repro_torch.core.query import QueryConfig
    from repro_torch.serving import PPRService, ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    g = tsyn.rmat(14, avg_deg=10.0, seed=3, device=cuda)
    index, _ = build_index(g, r=32, l=64, key=rng.prng_key(5),
                           source_batch=1024, device=cuda)
    work = np.random.default_rng(2).integers(0, g.n, 600).tolist()
    runs = []
    for depth in (1, 4):
        svc = PPRService(g, index, ServiceConfig(
            query=QueryConfig(t_iterations=2, top_k=50, hub_split_degree=64,
                              combine_path="sparse"),
            batching=BatchingConfig(max_batch=64),
            pipeline=PipelineConfig(depth=depth)), device=cuda)
        assert svc.frontier_path == "sparse"
        tops.reset_launch_counts()
        answers, _ = svc.run_closed_loop(work)
        assert tops.launch_counts()["index_combine_sparse"] > 0
        by_id = sorted(answers, key=lambda a: a.request_id)
        runs.append([np.stack([getattr(a, k) for a in by_id])
                     for k in ("top_scores", "top_vertices")])
    for a, b in zip(*runs):
        assert a.tobytes() == b.tobytes()


@pytest.mark.cuda
def test_combine_plan_fits_two_hash_blocks_an_sm(cuda):
    """The plan reads a hash block's shared memory from the kernel: the
    main path's block leaves room for two an SM (228 KB, 1 KB of it
    reserved a block), and a k_out the hash path does not take goes the
    sort path."""
    from repro_torch.kernels import index_combine as comb_k

    plan = comb_k.combine_plan(257, 256, 256, 50)
    assert plan.path == "hash" and plan.parts == 12
    assert 2 * (plan.smem + 1024) <= 233472
    assert comb_k.combine_plan(257, 256, 256, 2048).path == "sort"


@pytest.fixture(scope="module")
def maintenance_checks():
    """``chip_smoke.check_small_maintenance`` once for the module (each
    check builds rmat(14) indexes on the card and on the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written kernels)")
    return chip_smoke.check_small_maintenance(torch, np, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("check", [
    "repair vs rebuild, card", "repair, card vs CPU",
    "sharded repair vs rebuild, card", "sharded repair, card vs CPU"])
def test_repair_on_card_bit_equal(maintenance_checks, check):
    """rmat(14): the repaired index and filters on the card equal the
    card's rebuild on the mutated graph and the CPU's repair, single
    device and on a stacked 2 x 2 mesh."""
    assert maintenance_checks[check]


@pytest.mark.cuda
def test_checkpointed_build_resumed_on_card_bit_equal(maintenance_checks):
    """rmat(14): a build crashed at chunk 5 of 16 and resumed on the card
    equals an uninterrupted one: index, filters, kept and dropped totals."""
    assert maintenance_checks["checkpointed build resumed on the card"]


@pytest.mark.cuda
@pytest.mark.parametrize("check", sorted(chip_smoke.CAPTURE_CHECKS))
def test_captured_query_on_card(cuda, check):
    """The captured CUDA graphs at rmat(14): the same bytes as the eager
    query at every padded width of ``max_batch=256`` on both routes, in
    the ``mcfp`` mode and with seed sets of 4; one graph per width
    whatever the input's spelling; launch counts that grow by a graph's
    kernels on each replay; and a service through graphs that answers,
    after ``apply_updates``, like a fresh service on the new index."""
    assert chip_smoke.CAPTURE_CHECKS[check](torch, np, cuda)
