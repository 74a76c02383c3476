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
    assert chip_smoke.check_small_recsys(torch, np, cuda, "dlrm-rm2") <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", chip_smoke.ZOO)
def test_zoo_on_card_matches_the_cpu(cuda, arch):
    """DCN-v2's, SASRec's and MIND's reduced configs in f32, card against
    the plain CPU path from the same parameters (``serve_p99`` and
    ``retrieval_cand``): outputs within 1e-5 of their largest."""
    assert chip_smoke.check_small_recsys(torch, np, cuda, arch) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", chip_smoke.ZOO)
@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_zoo_forward_launches_embedding_bag_as_stated(cuda, arch, shape):
    """Every gather of a forward is one ``embedding_bag`` launch on the
    card: ``chip_smoke.ZOO_LOOKUPS`` of them, the count phase 3g gates
    on."""
    from repro_torch.launch import steps

    bundle = steps.build(arch, shape, reduced=True, device=cuda)
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    tops.reset_launch_counts()
    out = bundle.step_fn(params, batch)
    kind = "rec_retrieval" if shape == "retrieval_cand" else "rec_serve"
    assert tops.launch_counts()["embedding_bag"] == chip_smoke.ZOO_LOOKUPS[
        (arch, kind)]
    assert bool(torch.isfinite(out).all())


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
def test_lm_on_card_matches_the_cpu(cuda):
    """smollm-135m's reduced config in f32 (G = 1, and G = 3 with 6 heads
    over 2 KV heads), card against the plain CPU path from the same
    parameters: the prefill's logits and 8 decode steps' logits and
    caches within 1e-5 of their largest."""
    assert chip_smoke.check_small_lm(torch, np, cuda) <= 1e-5


@pytest.mark.cuda
def test_large_lms_and_moe_on_card_match_the_cpu(cuda):
    """The four large LMs' reduced configs in f32, card against the plain
    CPU path: prefill and 4 decode steps (bf16 and int8 caches); dbrx's
    and grok's ``_moe_ffn`` with slots dropped (routing equal) and their
    stacked 2 x 2 ``_moe_ffn_shardmap``; within 1e-5 of their largest."""
    assert chip_smoke.check_small_moe(torch, np, cuda) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(chip_smoke.BIG_LMS))
@pytest.mark.parametrize("shape,kind", [("prefill_32k", "lm_prefill"),
                                        ("decode_32k", "lm_decode")])
def test_large_lm_step_launches_embedding_bag_as_stated(cuda, arch, shape,
                                                        kind):
    """A large LM's reduced prefill forward and decode step each make one
    ``embedding_bag`` launch (``chip_smoke.LM_LOOKUPS``, phase 3p's
    gate); a MoE prefill twice gives the same bytes."""
    from repro_torch.launch import steps

    bundle = steps.build(arch, shape, reduced=True, device=cuda)
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    args = (params, bundle.make_cache(), batch) if bundle.make_cache \
        else (params, batch)
    tops.reset_launch_counts()
    out = bundle.step_fn(*args)
    out = out[0] if bundle.make_cache else out
    assert tops.launch_counts()["embedding_bag"] == chip_smoke.LM_LOOKUPS[
        (arch, kind)]
    assert bool(torch.isfinite(out).all())
    if not bundle.make_cache:
        assert torch.equal(out, bundle.step_fn(params, batch))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kind", [("prefill_32k", "lm_prefill"),
                                        ("decode_32k", "lm_decode")])
def test_lm_step_launches_embedding_bag_as_stated(cuda, shape, kind):
    """A prefill forward and a decode step each make one ``embedding_bag``
    launch on the card (``chip_smoke.LM_LOOKUPS``, the count phase 3k
    gates on)."""
    from repro_torch.launch import steps

    bundle = steps.build(chip_smoke.LM_ARCH, shape, reduced=True,
                         device=cuda)
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    args = (params, bundle.make_cache(), batch) if bundle.make_cache \
        else (params, batch)
    tops.reset_launch_counts()
    out = bundle.step_fn(*args)
    out = out[0] if bundle.make_cache else out
    assert tops.launch_counts()["embedding_bag"] == chip_smoke.LM_LOOKUPS[
        (chip_smoke.LM_ARCH, kind)]
    assert out.shape == (2, 1, 512) and bool(torch.isfinite(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(chip_smoke.TRAIN_CELLS))
def test_train_step_on_card_matches_the_cpu(cuda, arch):
    """One reduced train step in f32, card against the plain CPU path: the
    loss, every gradient and the updated parameters (the lookups' backward
    on the ``embedding_bag_backward`` kernel)."""
    ok, res = chip_smoke.check_small_train(torch, np, cuda, arch)
    assert ok, res


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(chip_smoke.TRAIN_CELLS))
def test_train_step_launches_the_backward_as_stated(cuda, arch):
    """A reduced train step launches ``TRAIN_LOOKUPS`` lookups on the card
    and as many launches of their backward kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.training import train_loop

    shape = chip_smoke.TRAIN_CELLS[arch]
    bundle = steps.build(arch, shape, reduced=True, device=cuda)
    params = bundle.init_fn(0)
    state = train_loop.init_state(bundle.opt_cfg, params)
    batch = bundle.make_batch(torch.Generator(device=cuda).manual_seed(1))
    tops.reset_launch_counts()
    bundle.step_fn(params, state, batch)
    torch.cuda.synchronize()
    n = chip_smoke.TRAIN_LOOKUPS[(arch, get_arch(arch).shape(shape).kind)]
    counts = tops.launch_counts()
    assert counts["embedding_bag"] == counts["embedding_bag_backward"] == n


def _gcn_reduced(cuda, shape):
    from repro_torch.launch import steps
    from repro_torch.training import train_loop

    bundle = steps.build(chip_smoke.GNN_ARCH, shape, reduced=True,
                         device=cuda)
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator(device=cuda).manual_seed(1))
    return bundle, params, train_loop.init_state(bundle.opt_cfg, params), \
        batch


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.GNN_CELLS)
def test_gcn_step_on_card_matches_the_cpu(cuda, shape):
    """One reduced gcn-cora step in f32, card against the plain CPU path:
    every aggregation on ``embedding_bag``, its gradient on the backward
    kernel."""
    ok, res = chip_smoke.check_small_gnn(torch, np, cuda, shape)
    assert ok, res


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.GNN_CELLS)
def test_gcn_step_twice_gives_the_same_bytes(cuda, shape):
    """No float atomics on the path: two steps from one state agree."""
    bundle, params, _, batch = _gcn_reduced(cuda, shape)
    assert chip_smoke.gnn_step_twice(torch, bundle, params, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.GNN_CELLS)
def test_gcn_step_launches_as_stated(cuda, shape):
    """A reduced gcn-cora step launches ``GNN_LOOKUPS`` aggregations and
    backward launches."""
    from repro_torch.configs import get_arch

    bundle, params, state, batch = _gcn_reduced(cuda, shape)
    tops.reset_launch_counts()
    bundle.step_fn(params, state, batch)
    torch.cuda.synchronize()
    counts = tops.launch_counts()
    kind = get_arch(chip_smoke.GNN_ARCH).shape(shape).kind
    assert (counts["embedding_bag"], counts["embedding_bag_backward"]) == \
        chip_smoke.GNN_LOOKUPS[kind]


@pytest.mark.cuda
def test_embedding_bag_backward_launches_and_matches_plain(cuda):
    """The wrapper routes a CUDA gradient to the kernel (one launch), which
    matches the plain version bit for bit, duplicates included."""
    from repro_torch.kernels import embedding_bag as bag_k

    r = np.random.default_rng(2)
    ids = torch.from_numpy(r.integers(-50, 60, (4000, 3)).astype(
        np.int32)).to(cuda)
    mask = torch.from_numpy(r.random((4000, 3)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(r.standard_normal((4000, 64)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    tops.reset_launch_counts()
    got = tops.embedding_bag_backward(ids, mask, g, 50,
                                      row_dtype=torch.bfloat16)
    assert tops.launch_counts()["embedding_bag_backward"] == 1
    want = bag_k.embedding_bag_backward_plain(ids, mask, g, 50,
                                              row_dtype=torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("vocab,d", [(26_000_000, 64), (1_000_000, 50),
                                     (49_152, 576), (5_000, 16)])
def test_embedding_bag_backward_plan_on_card(cuda, vocab, d):
    """The plan the wrapper launches with: a grid the card holds at once
    (its own occupancy), tiles that cover the table, and a bf16 gradient
    at a tile's edges written through a NaN-filled ``out`` as the plain
    version writes it."""
    from repro_torch.kernels import embedding_bag as bag_k

    g = torch.zeros((8, d), dtype=torch.bfloat16, device=cuda)
    plan = bag_k.cuda_backward_plan(g, vocab)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.blocks <= sms * 8
    assert (plan.tiles - 1) * plan.rows_per_tile < vocab
    assert vocab <= plan.tiles * plan.rows_per_tile
    if vocab > 10**5:
        return
    edge = plan.rows_per_tile
    ids = torch.tensor([[edge - 1], [edge], [edge], [edge - 1], [vocab],
                        [0], [vocab - 1], [edge]], dtype=torch.int32,
                       device=cuda)
    g = torch.arange(8 * d, dtype=torch.float32, device=cuda).reshape(
        8, d).div_(64.0).to(torch.bfloat16)
    out = torch.full((vocab, d), float("nan"), device=cuda)
    got = bag_k.embedding_bag_backward_cuda(ids, None, g, vocab,
                                            row_dtype=torch.bfloat16,
                                            out=out)
    want = bag_k.embedding_bag_backward_plain(ids.cpu(), None, g.cpu(),
                                              vocab,
                                              row_dtype=torch.bfloat16)
    assert got is out
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


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
def test_scatter_combine_matches_sparse_combine_on_card(cuda):
    """The reference's contract between the sparse route's two combines
    (``tests/test_serving.py::test_scatter_combine_matches_sparse_combine``)
    on the card: rmat(11), a random index of 16 entries a row (uniform
    values normalised and sorted down each row, uniform columns), 48
    vertices answered through the CUDA ``index_combine_sparse`` and
    through the scatter combine: the indices equal, the values within
    1e-6."""
    from repro_torch.core.index import PPRIndex
    from repro_torch.core.query import BatchQueryEngine, QueryConfig

    tg = tsyn.rmat(11, avg_deg=8.0, seed=2, device=cuda)
    r = np.random.default_rng(4)
    vals = r.random((tg.n, 16)).astype(np.float32)
    vals = -np.sort(-(vals / vals.sum(axis=1, keepdims=True)), axis=1)
    index = PPRIndex(
        values=torch.from_numpy(vals).to(cuda),
        indices=torch.from_numpy(r.integers(0, tg.n, (tg.n, 16)).astype(
            np.int32)).to(cuda), l=16, n=tg.n)
    got = {}
    for path in ("scatter", "sparse"):
        eng = BatchQueryEngine(tg, index, QueryConfig(
            mode="powerwalk", t_iterations=2, top_k=32, frontier_k=128,
            frontier_path="sparse", combine_path=path), device=cuda)
        tops.reset_launch_counts()
        v, i = eng.query_topk_async(torch.arange(48, dtype=torch.int32,
                                                 device=cuda))
        torch.cuda.synchronize()
        launched = tops.launch_counts()["index_combine_sparse"]
        assert (launched > 0) == (path == "sparse"), (path, launched)
        got[path] = (v.cpu().numpy(), i.cpu().numpy())
    np.testing.assert_array_equal(got["scatter"][1], got["sparse"][1])
    np.testing.assert_allclose(got["scatter"][0], got["sparse"][0],
                               rtol=1e-6, atol=1e-7)


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


# -- the contract auditor's card half (chip_smoke phase 3n) ------------------

@pytest.fixture(scope="module")
def audit_main_graph():
    """rmat(14) and an index of L = 64: hbm-residency's main graph here
    (phase 3n passes 3b's rmat(20))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch import rng
    from repro_torch.core.index import build_index

    g = tsyn.rmat(14, avg_deg=10.0, seed=0, device="cuda")
    index, _ = build_index(g, r=4, l=64, key=rng.prng_key(0),
                           source_batch=4096, device="cuda")
    return g, index


@pytest.mark.cuda
def test_contract_auditor_passes_on_card(cuda, audit_main_graph):
    """Every rule PASS with a target audited and none SKIP: the traced
    rules on the CUDA path, retrace-guard on real captures, hbm-residency
    on the built libraries and the launches' operands."""
    from repro_torch.analysis import rules

    results = rules.run_rules(device="cuda", main_graph=audit_main_graph)
    assert chip_smoke.contract_audit_failures(results, rules.RULES) == []
    assert [r.rule for r in results] == list(rules.RULES)


@pytest.mark.cuda
def test_static_shared_bytes_read_from_the_libraries(cuda):
    """cuobjdump reads each kernel's static shared memory: the shared-
    memory folds hold pw::Smem (32 KB of keys), walk_step none."""
    from repro_torch.analysis import trace
    from repro_torch.kernels import build

    build.build(["walk_step", "frontier_push"])
    walk = trace.static_smem_bytes(build.library_path("walk_step"))
    push = trace.static_smem_bytes(build.library_path("frontier_push"))
    assert walk == {"walk_step_kernel": 0}
    assert push["frontier_push_kernel"] >= 32 * 1024


@pytest.mark.cuda
def test_sparse_tile_step_answers_identical_across_runs(cuda):
    """The stacked sparse tile step three times on the same tiles: the
    same bytes (its dedups sum without float atomics,
    ``frontier.merge_duplicates``' ``ordered``; the atomic
    ``scatter_add_`` there made the answers differ between runs)."""
    from repro_torch import rng
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, make_verd_tile_step)
    from repro_torch.core.index import build_index
    from repro_torch.core.verd import resolve_degree_cap
    from repro_torch.distributed import ShardMesh

    g = tsyn.rmat(14, avg_deg=10.0, seed=0, device=cuda)
    index, _ = build_index(g, r=32, l=64, key=rng.prng_key(0),
                           source_batch=4096, device=cuda)
    cfg = DistConfig(n=g.n, ep=4, q_tile=256, t_iterations=2, index_l=64,
                     top_k=50, degree_cap=resolve_degree_cap(g),
                     hub_split_degree=64)
    step = make_verd_tile_step(cfg, ShardMesh(1, 4, device=cuda))
    slabs = build_sharded_graph(g, cfg, device=cuda)
    shape = (4, g.n // 4, 64)
    work = torch.as_tensor(np.random.default_rng(1).integers(0, g.n, 1024),
                           dtype=torch.int32, device=cuda)
    runs = [[step(slabs, work[j:j + 256], index.values.reshape(shape),
                  index.indices.reshape(shape)) for j in range(0, 1024, 256)]
            for _ in range(3)]
    for first, *later in zip(*runs):
        for v, i in later:
            assert torch.equal(first[0].view(torch.int32), v.view(torch.int32))
            assert torch.equal(first[1], i)


@pytest.mark.cuda
@pytest.mark.parametrize("compress_k", [0, 64])
def test_dense_tile_step_answers_identical_across_runs(cuda, compress_k):
    """The stacked dense-exchange tile step (the slab oracle, and its
    per-owner top-``compress_k`` wire) three times on the same tiles at
    rmat(14): the same bytes.  Its local push and its index combine sum
    many contributions into one column; an ``index_add_`` there adds them
    by CUDA atomics in no fixed order."""
    import warnings

    from repro_torch import rng
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, make_verd_tile_step)
    from repro_torch.core.index import build_index
    from repro_torch.core.verd import resolve_degree_cap
    from repro_torch.distributed import ShardMesh

    g = tsyn.rmat(14, avg_deg=10.0, seed=0, device=cuda)
    index, _ = build_index(g, r=32, l=64, key=rng.prng_key(0),
                           source_batch=4096, device=cuda)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = DistConfig(n=g.n, ep=4, q_tile=256, t_iterations=2,
                         index_l=64, top_k=50,
                         degree_cap=resolve_degree_cap(g), exchange="dense",
                         compress_k=compress_k)
    step = make_verd_tile_step(cfg, ShardMesh(1, 4, device=cuda))
    slabs = build_sharded_graph(g, cfg, device=cuda)
    shape = (4, g.n // 4, 64)
    work = torch.as_tensor(np.random.default_rng(1).integers(0, g.n, 1024),
                           dtype=torch.int32, device=cuda)
    runs = [[step(slabs, work[j:j + 256], index.values.reshape(shape),
                  index.indices.reshape(shape)) for j in range(0, 1024, 256)]
            for _ in range(3)]
    for first, *later in zip(*runs):
        for v, i in later:
            assert torch.equal(first[0].view(torch.int32), v.view(torch.int32))
            assert torch.equal(first[1], i)


@pytest.mark.cuda
def test_rank_service_on_card_matches_the_stacked_mesh(cuda, tmp_path):
    """Four gloo ranks on the card at rmat(12) (``tests/torch_rank_serving_
    worker.py``, no JAX): the rank service's answers in every case, the
    rank repair, the service's updates and rollback, the checkpointed
    build crashed and resumed both ways, and a service booted from it,
    each the same bytes as the stacked ``ShardMesh``'s or the one-device
    service's on the card.  The dense route's ``powerwalk`` answers are
    held within 1e-5 L1 on densified rows: the rank leader's combine
    builds its transposed view over the gathered rows, where a column of
    more than ``COLUMN_SEGMENT`` entries may split elsewhere."""
    import torch_rank_serving_worker as worker
    from repro_torch.core.updates import apply_updates
    from repro_torch.serving import PPRService
    from repro_torch.testing import FaultPlan, InjectedFault

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), np.asarray(b, np.float32).view(
                np.uint32)
        return a.shape == b.shape and np.array_equal(a, b)

    def block(x, r, ep):
        x = x.cpu().numpy()
        ns = x.shape[0] // ep
        return x[r % ep * ns:(r % ep + 1) * ns]

    def densified(scores, vertices):
        out = np.zeros((len(scores), 1 << worker.N_LOG2))
        np.add.at(out, (np.arange(len(scores))[:, None], vertices), scores)
        return out

    with pytest.raises(InjectedFault):
        worker.stacked_checkpoint(
            tmp_path / "stacked_crash", device=cuda,
            fault_plan=FaultPlan(raise_at_chunks=(worker.CRASH_CHUNK,)))
    got, _ = worker.run_ranks(tmp_path, device="cuda:0", timeout_s=300.0,
                              join_timeout_s=600.0)
    leader = got[0]
    m, _ = worker.stacked_maintainer(cuda)
    for label, (query, _, script) in worker.SERVICE_CASES.items():
        want = worker.run_script(worker.stacked_service(m.index, label,
                                                        cuda), script)
        mine = {k: leader[f"serve14/{label}/{k}"] for k in want}
        if (query.get("mode", "powerwalk") == "powerwalk" and str(
                leader[f"serve14/{label}/frontier_path"]) == "dense"):
            l1 = np.abs(densified(mine.pop("scores"), mine.pop("vertices"))
                        - densified(want["scores"], want["vertices"]))
            assert float(l1.sum(axis=1).max()) <= 1e-5, label
        for k, v in mine.items():
            assert same(v, want[k]), (label, k)
    g = worker.graph(cuda)
    first, _ = worker.edge_batches(g)
    _, m1, report = apply_updates(m, g, **first)
    svc = PPRService(g, None, worker.service_config(*worker.UPDATE_CASE),
                     clock=worker.still, device=cuda, maintainer=m)
    want = {"before": worker.run_script(svc, "cache")}
    svc.apply_updates(**first)
    want["after"] = worker.run_script(svc, "cache")
    for name, arrays in want.items():
        for k, v in arrays.items():
            assert same(leader[f"service_update/{name}/{k}"], v), (name, k)
    svc = PPRService(g, None, worker.service_config(
        *worker.FPPR_UPDATE_CASE), clock=worker.still, device=cuda,
        maintainer=m)
    items = worker.repaired_requests(svc.apply_updates(**first))
    for k, v in worker.answers_arrays(svc.run_closed_loop(items)[0],
                                      svc.answer_k).items():
        assert same(leader[f"fppr_update/{k}"], v), k
    cm, _ = worker.stacked_checkpoint(tmp_path / "stacked_full",
                                         device=cuda)
    for r, out in enumerate(got):
        for k, v in worker.report_arrays(report).items():
            assert same(out[f"repair/report/{k}"], v), (r, k)
        assert same(out["repair/values"], block(m1.index.values, r, 4)), r
        assert same(out["repair/touch"], block(m1.touch.bits, r, 4)), r
        assert same(out["service_update/final/values"],
                    block(m1.index.values, r, 4)), r
        for tag in ("full", "crash/resumed", "stacked_crash/resumed"):
            assert same(out[f"ckpt/{tag}/values"],
                        block(cm.index.values, r, 2)), (r, tag)
            assert same(out[f"ckpt/{tag}/touch"],
                        block(cm.touch.bits, r, 2)), (r, tag)
    assert str(leader["service_update/failed"]) == "yes"


@pytest.mark.cuda
def test_rank_mesh_on_card_matches_the_stacked_mesh(cuda, tmp_path):
    """Four gloo ranks on the card at rmat(12) (``tests/torch_rank_mesh_
    worker.py``, no JAX): the 1 x 4 build's rows and its sparse tile
    step's answers from them, and the 2 x 2 build's rows, each rank's bit
    for bit the stacked ``ShardMesh``'s of its shard."""
    import torch_rank_mesh_worker as worker

    got, _ = worker.run_ranks(tmp_path, ["card"], device="cuda:0",
                              timeout_s=300.0, join_timeout_s=600.0)
    want = worker.stacked_card(cuda)
    n = want["rows14"].n
    for r, out in enumerate(got):
        d, m = divmod(r, 2)
        for name, shards, shard in (("rows14", 4, r), ("rows22", 2, m)):
            rows = slice(shard * n // shards, (shard + 1) * n // shards)
            for part in ("values", "indices"):
                assert np.array_equal(
                    out[f"card/{name}_{part}"],
                    getattr(want[name], part)[rows].cpu().numpy()), (r, name)
        assert np.array_equal(out["card/tile_values"].view(np.uint32),
                              want["tile_values"].view(np.uint32)), r
        assert np.array_equal(out["card/tile_indices"],
                              want["tile_indices"]), r


@pytest.mark.cuda
def test_fp8_moment_update_on_card_matches_cpu(cuda):
    """AdamW with fp8 ``mu`` and bf16 ``nu`` on the card: the moments the
    CPU's bytes (PyTorch does no arithmetic in fp8: each update reads the
    moment as f32 and writes it back through ``optimizer.cast_moment``),
    the parameters within 1e-6 relative or 1e-9 absolute (the schedule's
    ``cos`` and the bias corrections' ``pow`` on the card differ from the
    CPU's by an ulp, in a step of ``lr`` = 3e-6), and the cast itself at fp8's edges (448, the 464 tie, what
    rounds past it to NaN of its sign, subnormals)."""
    from repro_torch.training import optimizer as topt

    edges = torch.tensor([0.0, 2.0 ** -10, 3 * 2.0 ** -10, 447.0, 448.0,
                          464.0, 465.0, 1e30, float("inf"), -float("inf"),
                          float("nan"), -465.0, 1.0625, 1.1875])
    want = topt.cast_moment(edges, torch.float8_e4m3fn).view(torch.uint8)
    got = topt.cast_moment(edges.to(cuda), torch.float8_e4m3fn)
    assert torch.equal(got.view(torch.uint8).cpu(), want)
    cfg = topt.AdamWConfig(mu_dtype=torch.float8_e4m3fn,
                           nu_dtype=torch.bfloat16, b1=0.0, grad_clip=1e30)
    rng = np.random.default_rng(11)
    p = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32))}
    g = {"w": torch.from_numpy((rng.standard_normal((64, 48)) * np.exp2(
        rng.uniform(-12, 10, (64, 48)))).astype(np.float32))}
    outs = []
    for dev in ("cpu", cuda):
        q = {"w": p["w"].to(dev, copy=True)}       # updated in place
        st = topt.init(cfg, q)
        q, st, m = topt.update(cfg, {"w": g["w"].to(dev)}, st, q)
        outs.append((q["w"].cpu(), st.mu["w"].view(torch.uint8).cpu(),
                     st.nu["w"].view(torch.int16).cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-6,
                               atol=1e-9)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert torch.equal(a, b)
    assert bool((outs[0][1] & 0x7F == 0x7F).any())     # some mu past 448


@pytest.fixture(scope="module")
def card_rank_train(tmp_path_factory):
    """Four gloo ranks on the card (``tests/torch_rank_train_worker.py``,
    no JAX), every case of ``launch.ranks.CASES`` through
    ``launch.ranks.train_case`` on each mesh it splits on: the ranks'
    outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written kernels)")
    import torch_rank_train_worker as worker

    got, _ = worker.run_ranks(tmp_path_factory.mktemp("rank_train_card"),
                              device="cuda:0", timeout_s=300.0,
                              join_timeout_s=600.0)
    return got


def _rank_cases_match_stacked(got, labels, cuda):
    """Each rank's outputs of ``labels`` equal to the stacked mesh's on the
    card for its shard, bit for bit."""
    import torch_rank_train_worker as worker
    from repro_torch.distributed import ShardMesh, sharding
    from repro_torch.launch import ranks
    from repro_torch.models import transformer as tfm

    for label in labels:
        cfg = worker.config(label)
        for shape in worker.meshes(label):
            mesh = ShardMesh(*shape, device="cpu")
            specs = dict(ranks.leaf_paths(tfm.param_specs(cfg, mesh)))
            want = worker.stacked(label, shape, device=cuda)
            for r, out in enumerate(got):
                d, m = divmod(r, shape[1])
                for k, v in want.items():
                    if k.endswith("@dtype"):
                        continue
                    head, _, name = k.partition("/")
                    spec = specs.get(name) if head in (
                        "grad", "grad3", "param", "mu", "nu") else None
                    if spec is not None and not sharding.is_replicated(spec):
                        v = sharding.shard(torch.from_numpy(v), spec,
                                           mesh)[d, m].numpy()
                    assert np.array_equal(
                        out[f"{label}/{shape[0]}x{shape[1]}/{k}"], v), (
                            label, shape, r, k)


@pytest.mark.cuda
def test_rank_train_on_card_matches_the_stacked_mesh(cuda, card_rank_train):
    """The reduced dbrx and grok on 2 x 2 and 1 x 4 rank meshes on the
    card: every output the stacked mesh's on the card, bit for bit."""
    _rank_cases_match_stacked(card_rank_train, ("dbrx_cf1", "grok"), cuda)


@pytest.mark.cuda
def test_rank_dense_train_on_card_matches_the_stacked_mesh(cuda,
                                                           card_rank_train):
    """The dense reduced qwen (2 x 2 and 1 x 4) and command-r (2 x 2) in
    the 2-D layout on the card, through ``launch.ranks.train_case``:
    forward, loss, decode, gradients, a two-microbatch step and the
    parameters' digest the stacked mesh's on the card, bit for bit."""
    _rank_cases_match_stacked(card_rank_train, ("qwen", "command_r"), cuda)
