"""The rank side of ``tests/test_torch_rank_serving.py``: a PPR service,
its checkpointed build and its repair one model shard a process
(``RankMesh`` over gloo ranks on the CPU), each rank writing what it got to
``rank{r}.npz``, and the same on the stacked ``ShardMesh`` or one device
for the tests to hold them against.  Imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch import rng
from repro_torch.core import index as tindex
from repro_torch.core import updates as tupdates
from repro_torch.core.query import QueryConfig
from repro_torch.distributed import RankMesh, ShardMesh
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving import CacheConfig, PPRService, ServiceConfig
from repro_torch.serving.batching import BatchingConfig
from repro_torch.serving.engine import serve_follower
from repro_torch.serving.pipeline import PipelineConfig
from repro_torch.testing import FaultPlan, InjectedFault

N_LOG2 = 12                    # rmat(12): 4,096 vertices
KEY = 3
# the served index: 1 x 4 ranks of 1,024 rows, 4 chunks each
BUILD = dict(r=16, l=16, source_batch=256, touch_bits=2048)
# the checkpointed build on 2 x 2 ranks: 8 chunks of 256 a shard
CKPT = dict(r=8, l=8, source_batch=256, touch_bits=64, checkpoint_every=2,
            checkpoint_keep=16)
CRASH_CHUNK = 4                # a crash after the commit of step 2
QKW = dict(t_iterations=2, top_k=16, hub_split_degree=16, frontier_k=64,
           frontier_path="sparse")
# label -> (query keywords, pipeline depth, script)
SERVICE_CASES = {
    "scatter_d4": (dict(combine_path="scatter"), 4, "closed"),
    "sparse_d1": (dict(combine_path="sparse"), 1, "closed"),
    "sparse_d4_seeds": (dict(combine_path="sparse", max_seeds=3), 4,
                        "seeds"),
    "scatter_d1_seeds": (dict(combine_path="scatter", max_seeds=3), 1,
                         "seeds"),
    "cache_d2": (dict(combine_path="sparse"), 2, "cache"),
    "shed_d4": (dict(combine_path="scatter"), 4, "shed"),
}
PAIR_CASES = ("scatter_d4", "sparse_d4_seeds")   # also on 1 x 2 ranks
UPDATE_CASE = (dict(combine_path="sparse"), 2, "cache")
REFUSED_MODES = ("fppr", "mcfp", "pi", "verd")
CLI = dict(n_log2=8, r=4, l=8, source_batch=32, requests=16, q_tile=8,
           serve_n=16)


def graph(device="cpu"):
    return tsyn.rmat(N_LOG2, avg_deg=8.0, seed=0, device=device)


def work(seeds: bool):
    """16 requests: vertices, or every third a weighted seed set."""
    r = np.random.default_rng(5)
    out = []
    for j in range(16):
        if seeds and j % 3 == 2:
            out.append(dict(seeds=r.integers(0, 1 << N_LOG2, 3).tolist(),
                            weights=(r.random(3) + 0.1).tolist()))
        else:
            out.append(int(r.integers(0, 1 << N_LOG2)))
    return out


def edge_batches(g):
    """Two update batches.  The first inserts edges and deletes edges the
    graph has, all out of vertices no edge enters, so few rows' walks pass
    them and the repair resamples some chunks, not all; the second
    inserts fresh edges."""
    src = g.src.cpu().numpy()
    dst = g.col_idx.cpu().numpy()
    unreached = np.bincount(dst, minlength=g.n) == 0
    r = np.random.default_rng(9)
    pick = r.choice(np.flatnonzero(unreached[src]), 3, replace=False)
    first = dict(inserts=np.stack([r.choice(np.flatnonzero(unreached), 4),
                                   r.integers(0, g.n, 4)], axis=1),
                 deletes=np.stack([src[pick], dst[pick]], axis=1))
    second = dict(inserts=r.integers(0, g.n, (3, 2)), deletes=None)
    return first, second


def still():
    """A clock that stands still: only ``max_batch`` or a forced poll
    closes a batch, whatever the host's load."""
    return 0.0


def service_config(query: dict, depth: int, script: str) -> ServiceConfig:
    batching = (BatchingConfig(max_batch=8, max_queue_depth=2,
                               max_wait_s=60.0) if script == "shed"
                else BatchingConfig(max_batch=8))
    return ServiceConfig(
        query=QueryConfig(**dict(QKW, **query)), batching=batching,
        pipeline=PipelineConfig(depth=depth),
        cache=CacheConfig(capacity=64 if script == "cache" else 0))


def answers_arrays(answers, k: int) -> dict:
    """Answers in request order: scores and vertices (``[N, k]``, a shed
    request's row zero), and the cached and rejected flags."""
    answers = sorted(answers, key=lambda a: a.request_id)
    scores = np.zeros((len(answers), k), np.float32)
    verts = np.zeros((len(answers), k), np.int64)
    for i, a in enumerate(answers):
        scores[i, :a.top_scores.size] = a.top_scores
        verts[i, :a.top_vertices.size] = a.top_vertices
    return dict(scores=scores, vertices=verts,
                cached=np.array([a.cached for a in answers]),
                rejected=np.array([a.rejected for a in answers]))


def run_script(svc, script: str) -> dict:
    """The requests of ``script`` through ``svc``: its answers' arrays."""
    k = svc.answer_k
    if script == "shed":
        ids = [svc.submit(v) for v in range(4)]
        out = svc.poll(force=True)
        ids += [svc.submit(v) for v in range(10, 14)]
        out += svc.poll(force=True)
        assert sorted(a.request_id for a in out) == ids
        return answers_arrays(out, k)
    items = work(script == "seeds")
    out, _ = svc.run_closed_loop(items)
    if script == "cache":
        again, _ = svc.run_closed_loop(items)
        svc.invalidate([items[0]])
        svc.submit(items[0])
        out += again + svc.poll(force=True)
    return answers_arrays(out, k)


def service_snapshot(svc) -> dict:
    s = svc.snapshot_stats()
    return dict(index_sharded=np.array(s["index_sharded"]),
                index_rows=np.array(s["index_rows"]),
                shed=np.array(s["shed"]),
                cache_served=np.array(s["cache_served"]),
                graphs_captured=np.array(s["graphs_captured"]),
                exchange_rows=np.array(s.get("exchange_rows", 0)),
                exchange_rows_crossed=np.array(
                    s.get("exchange_rows_crossed", 0)),
                exchange_bytes=np.array(s.get("exchange_bytes_crossed", 0)))


def report_arrays(report: dict) -> dict:
    """The repair report's fields the stacked one must share (not its
    times)."""
    return {k: np.asarray(v) for k, v in report.items()
            if k not in ("capture_s", "graphs_captured")}


def maintainer_arrays(m) -> dict:
    return dict(values=m.index.values, indices=m.index.indices,
                touch=m.touch.bits, n_shard=torch.tensor(m.index.n_shard))


# -- the ranks ----------------------------------------------------------------

def _serve(mesh, index, g, cases, dev, out, prefix):
    """Every case of ``cases`` as a rank service over ``mesh``."""
    for label in cases:
        cfg = service_config(*SERVICE_CASES[label])
        if index.is_leader:
            svc = PPRService(g, index, cfg, clock=still, device=dev,
                             mesh=mesh)
            got = run_script(svc, SERVICE_CASES[label][2])
            got.update(service_snapshot(svc))
            svc.close()
        else:
            res = serve_follower(g, index, mesh)
            got = dict(row_requests=np.array(res["row_requests"]))
        got["shard_rows"] = np.array(index.values.shape[0])
        out.update({f"{prefix}/{label}/{k}": v for k, v in got.items()})


def _updates(mesh, m, g, dev, out, rank):
    """The direct rank repair of the first batch, then a rank service with
    the maintainer: serve, the first batch, serve, the second batch (which
    fails on rank 2: every rank must roll back), serve."""
    first, second = edge_batches(g)
    _, m1, report = tupdates.apply_updates(m, g, **first)
    out.update({f"repair/{k}": v for k, v in maintainer_arrays(m1).items()})
    out.update({f"repair/report/{k}": v
                for k, v in report_arrays(report).items()})
    if rank == 2:                   # the second batch fails here
        real = tupdates.apply_edge_updates
        calls = []

        def failing(*a, **kw):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("rank 2's repair fails on purpose")
            return real(*a, **kw)

        tupdates.apply_edge_updates = failing
    cfg = service_config(*UPDATE_CASE)
    if m.index.is_leader:
        svc = PPRService(g, None, cfg, clock=still, device=dev, mesh=mesh,
                         maintainer=m)
        got = {"before": run_script(svc, "cache")}
        report = svc.apply_updates(**first)
        got["after"] = run_script(svc, "cache")
        try:
            svc.apply_updates(**second)
            failed = "no"
        except RuntimeError as e:
            failed = "yes" if "shard(s) [2]" in str(e) else str(e)
        got["rolled_back"] = run_script(svc, "cache")
        svc.close()
        for name, arrays in got.items():
            out.update({f"service_update/{name}/{k}": v
                        for k, v in arrays.items()})
        out.update({f"service_update/report/{k}": v
                    for k, v in report_arrays(report).items()})
        out["service_update/failed"] = np.array(failed)
        out["service_update/rollbacks"] = np.array(
            svc.stats["update_rollbacks"])
        final = svc.maintainer
    else:
        res = serve_follower(g, None, mesh, maintainer=m)
        out["service_update/rollbacks"] = np.array(res["update_rollbacks"])
        final = res["maintainer"]
    out.update({f"service_update/final/{k}": v
                for k, v in maintainer_arrays(final).items()})
    if rank == 2:
        tupdates.apply_edge_updates = real


def _checkpoints(mesh, g, out_dir, rank, out):
    """The checkpointed maintainable build on 2 x 2 ranks: uninterrupted,
    crashed and resumed, resumed from the stacked mesh's crash, crashed
    for the stacked mesh to resume, and crashed mid-commit."""
    key = rng.prng_key(KEY)

    def build(name, **kw):
        return tupdates.build_maintainable_index(
            g, key=key, mesh=mesh, checkpoint_dir=os.path.join(out_dir, name),
            **{**CKPT, **kw})

    def keep(prefix, m, stats):
        out.update({f"{prefix}/{k}": v
                    for k, v in maintainer_arrays(m).items()})
        for k in ("kept_mass", "dropped_mass", "resumed_at_chunk",
                  "checkpoint_commits", "row_offset"):
            if k in stats:
                out[f"{prefix}/{k}"] = np.array(stats[k])

    keep("ckpt/full", *build("full"))
    for name in ("crash", "rank_crash"):
        try:
            build(name, fault_plan=FaultPlan(raise_at_chunks=(CRASH_CHUNK,)))
            out[f"ckpt/{name}/raised"] = np.array(False)
        except InjectedFault:
            out[f"ckpt/{name}/raised"] = np.array(True)
    keep("ckpt/crash/resumed", *build("crash", resume=True))
    keep("ckpt/stacked_crash/resumed", *build("stacked_crash", resume=True))
    try:
        build("mid_commit", fault_plan=FaultPlan(raise_mid_commit=(2,)))
        raised = "none"
    except InjectedFault:
        raised = "injected"
    except RuntimeError as e:
        raised = "peer" if "commit of step 2" in str(e) else str(e)
    out["ckpt/mid_commit/raised"] = np.array(raised)
    index, _ = tindex.load_index_checkpoint(
        os.path.join(out_dir, "full"), mesh=mesh)
    out["ckpt/loaded/values"] = index.values.cpu().numpy()
    out["ckpt/loaded/row_offset"] = np.array(index.row_offset)


def _boot(mesh, g, out_dir, dev, out):
    """A 1 x 4 rank service booted from the 2 x 2 ranks' complete
    maintainable step: serve, the first update batch, serve."""
    ckpt = os.path.join(out_dir, "full")
    cfg = service_config(*UPDATE_CASE)
    first, _ = edge_batches(g)
    if mesh.local_model[0] == 0:
        svc = PPRService.from_checkpoint(g, ckpt, cfg, clock=still,
                                         device=dev, mesh=mesh)
        got = {"before": run_script(svc, "cache")}
        svc.apply_updates(**first)
        got["after"] = run_script(svc, "cache")
        svc.close()
        for name, arrays in got.items():
            out.update({f"boot/{name}/{k}": v for k, v in arrays.items()})
        index = svc.engine.index
    else:
        index = serve_follower(g, None, mesh, checkpoint_dir=ckpt)["index"]
    out["boot/shard_rows"] = np.array(index.values.shape[0])


def _refusals(mesh14, g, index14, index22, dev):
    """What a rank service refuses: ``True`` where it raised as it must."""
    out = {}

    def refused(name, call, match):
        try:
            call()
            out[name] = False
        except ValueError as e:
            out[name] = match in str(e)

    base = dict(QKW)
    for mode in REFUSED_MODES:
        refused(mode, lambda: PPRService(g, index14, ServiceConfig(
            query=QueryConfig(**dict(base, mode=mode))), device=dev,
            mesh=mesh14), "ROADMAP")
    refused("dense_route", lambda: PPRService(g, index14, ServiceConfig(
        query=QueryConfig(**dict(base, frontier_path="dense"))),
        device=dev, mesh=mesh14), "ROADMAP")
    refused("data_mesh", lambda: PPRService(g, index22, ServiceConfig(
        query=QueryConfig(**base)), device=dev), "ROADMAP")
    if index14.is_leader:
        refused("role", lambda: serve_follower(g, index14, mesh14), "leads")
    else:
        refused("role", lambda: PPRService(g, index14, ServiceConfig(
            query=QueryConfig(**base)), device=dev, mesh=mesh14),
            "model shard 0")
    return {k: np.array(v) for k, v in out.items()}


def rank_main(rank, world, out_dir, device, timeout_s):
    """One rank: join the group through a ``file://`` store in
    ``out_dir``, run every scenario and write ``rank{rank}.npz``."""
    from repro_torch.launch import ranks as ranks_cli
    from repro_torch.launch.mesh import make_rank_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    mesh14 = make_rank_mesh(
        1, world, backend="gloo", device=dev, timeout_s=timeout_s, rank=rank,
        world_size=world,
        init_method="file://" + os.path.join(out_dir, "store"))
    mesh22 = RankMesh(2, 2, dev, timeout_s=timeout_s)
    mesh12 = (RankMesh(1, 2, dev, ranks=range(2), timeout_s=timeout_s)
              if rank < 2 else None)
    g = graph(dev)
    out = {}
    m14, _ = tupdates.build_maintainable_index(
        g, key=rng.prng_key(KEY), mesh=mesh14, **BUILD)
    out.update({f"build/{k}": v for k, v in maintainer_arrays(m14).items()})
    out["build/row_offset"] = np.array(m14.index.row_offset)
    _serve(mesh14, m14.index, g, SERVICE_CASES, dev, out, "serve14")
    if mesh12 is not None:
        m12, _ = tupdates.build_maintainable_index(
            g, key=rng.prng_key(KEY), mesh=mesh12, **BUILD)
        _serve(mesh12, m12.index, g, PAIR_CASES, dev, out, "serve12")
    _updates(mesh14, m14, g, dev, out, rank)
    _checkpoints(mesh22, g, out_dir, rank, out)
    _boot(mesh14, g, out_dir, dev, out)
    index22, _ = tindex.load_index_checkpoint(
        os.path.join(out_dir, "full"), mesh=mesh22)
    out.update({f"refusals/{k}": v for k, v in _refusals(
        mesh14, g, m14.index, index22, dev).items()})
    served = ranks_cli.run(mesh14, **CLI)[-1]
    if served is not None:
        out["cli/digest"] = np.array(
            ranks_cli.service_answers_digest(served[0]))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
                for k, v in out.items()})
    torch.distributed.destroy_process_group()


def run_ranks(out_dir, *, world=4, device="cpu", timeout_s=60.0,
              join_timeout_s=120.0):
    """Spawn ``world`` ranks of :func:`rank_main`; returns each rank's
    outputs and the seconds the ranks took."""
    from repro_torch.launch.ranks import spawn

    seconds = spawn(rank_main, world,
                    (world, str(out_dir), str(device), timeout_s),
                    join_timeout_s=join_timeout_s)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)], seconds


# -- the stacked mesh ---------------------------------------------------------

def stacked_maintainer(device="cpu", shape=(1, 4), **kw):
    return tupdates.build_maintainable_index(
        graph(device), key=rng.prng_key(KEY),
        mesh=ShardMesh(*shape, device=device), **(kw or BUILD))


def stacked_service(index, label, device="cpu", **kw):
    return PPRService(graph(device), index,
                      service_config(*SERVICE_CASES[label]), clock=still,
                      device=device, **kw)


def stacked_checkpoint(path, device="cpu", **kw):
    """The 2 x 2 stacked mesh's checkpointed maintainable build."""
    return tupdates.build_maintainable_index(
        graph(device), key=rng.prng_key(KEY),
        mesh=ShardMesh(2, 2, device=device), checkpoint_dir=str(path),
        **{**CKPT, **kw})
