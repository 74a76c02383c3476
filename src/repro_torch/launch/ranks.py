"""Run the distributed engine one shard a process, on a ``RankMesh``.

:func:`spawn` starts ``world`` processes of one function (``spawn`` start
method, so nothing of the caller's CUDA state is forked) and waits for them
within a deadline: a rank that raises or dies ends the others and raises
here; a run past the deadline is killed and raises ``TimeoutError``, so a
hung collective never hangs the caller.

Run as a module under ``torchrun``, each rank joins the mesh
(``launch.mesh.make_rank_mesh``), builds its model shard of the index on
an ``rmat`` graph (``core.index.build_index_sharded``) and answers tiles of
requests with the sparse tile step from the rows it built::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.ranks \\
        --device cpu --data 1 --model 4 --n-log2 12

Rank 0 prints the build's totals, each rank's build seconds, the tiles'
ms and a digest of the answers, which every rank must share.  With
``--serve N`` the first data replica's ranks then serve ``N`` requests
through ``PPRService`` over the rows they built (a ``1 x model`` mesh: rank
0 leads, the others run ``serving.engine.serve_follower``), and rank 0
prints the service's qps, p50 / p99 and its answers' digest.  With
``--stacked`` (no ``torchrun``) one process runs the same on a stacked
``ShardMesh`` (its service on the assembled index) and prints the digests
the ranks' must equal.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Callable, Optional


def spawn(fn: Callable, world: int, args: tuple = (), *,
          join_timeout_s: float = 300.0) -> float:
    """``fn(rank, *args)`` in ``world`` spawned processes; returns the
    seconds they took.  Raises the first failure (``torch.multiprocessing``'s
    ``ProcessRaisedException`` or ``ProcessExitedException``, the other
    ranks terminated) or ``TimeoutError`` after ``join_timeout_s``."""
    import torch.multiprocessing as mp

    t0 = time.monotonic()
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() - t0 > join_timeout_s:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{join_timeout_s:.0f} s: killed")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return time.monotonic() - t0


def answers_digest(tiles) -> str:
    """sha256 of every tile's ``(values, indices)`` bytes, in order."""
    h = hashlib.sha256()
    for v, i in tiles:
        h.update(v.cpu().numpy().tobytes())
        h.update(i.cpu().numpy().tobytes())
    return h.hexdigest()


def service_answers_digest(answers) -> str:
    """sha256 of the answers' ``(top_scores, top_vertices)`` bytes in
    request order."""
    h = hashlib.sha256()
    for a in sorted(answers, key=lambda a: a.request_id):
        h.update(a.top_scores.tobytes())
        h.update(a.top_vertices.tobytes())
    return h.hexdigest()


def service_config(max_batch: int):
    """The service ``--serve`` runs: 3c's query on the sparse route."""
    from repro_torch.core.query import QueryConfig
    from repro_torch.serving import ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    return ServiceConfig(
        query=QueryConfig(t_iterations=2, top_k=50, hub_split_degree=64,
                          frontier_path="sparse"),
        batching=BatchingConfig(max_batch=max_batch, max_wait_s=0.05),
        pipeline=PipelineConfig(depth=4))


def serve(mesh, g, index, requests: int, max_batch: int, seed: int = 0):
    """``requests`` of :func:`run`'s requests served through
    ``PPRService`` over ``index``: on a ``ShardMesh`` one service on the
    assembled index; on a ``RankMesh`` the first data replica's ranks as a
    ``1 x model`` rank service (the others return ``None`` at once), the
    leader returning ``(answers, stats)`` and a follower ``None``."""
    import numpy as np

    from repro_torch.distributed import RankMesh
    from repro_torch.serving import PPRService
    from repro_torch.serving.engine import serve_follower

    work = np.random.default_rng(seed + 1).integers(
        0, g.n, requests).tolist()
    cfg = service_config(max_batch)
    if not isinstance(mesh, RankMesh):
        return PPRService(g, index, cfg, device=mesh.device) \
            .run_closed_loop(work)
    if mesh.local_data[0] != 0:
        return None
    sm = mesh if mesh.data == 1 else RankMesh(
        1, mesh.model, mesh.device, ranks=mesh.ranks[:mesh.model])
    if not index.is_leader:
        serve_follower(g, index, sm)
        return None
    svc = PPRService(g, index, cfg, device=mesh.device, mesh=sm)
    try:
        return svc.run_closed_loop(work)
    finally:
        svc.close()


def run(mesh, *, n_log2: int, r: int, l: int, source_batch: int,
        requests: int, q_tile: int, seed: int = 0, serve_n: int = 0):
    """This rank's share of the build and of ``requests`` answered in
    tiles of ``q_tile`` on ``mesh``: ``(index, stats, build_s, tiles,
    tiles_s, served)``, the index the rank's own rows; ``served`` is
    :func:`serve`'s of ``serve_n`` requests in batches of ``q_tile``
    (``None`` without)."""
    import numpy as np
    import torch

    from repro_torch import rng
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, make_verd_tile_step)
    from repro_torch.core.index import build_index_sharded
    from repro_torch.core.verd import resolve_degree_cap
    from repro_torch.graphs import synthetic

    dev = mesh.device
    g = synthetic.rmat(n_log2, avg_deg=10.0, seed=seed, device=dev)
    t0 = time.perf_counter()
    index, stats = build_index_sharded(
        g, r=r, l=l, key=rng.prng_key(seed), mesh=mesh,
        source_batch=source_batch, respawn=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    cfg = DistConfig(n=stats["n_pad"], ep=mesh.model, q_tile=q_tile,
                     t_iterations=2, index_l=l, top_k=50,
                     degree_cap=resolve_degree_cap(g))
    slabs = build_sharded_graph(g, cfg, device=dev, shards=mesh.local_model)
    step = make_verd_tile_step(cfg, mesh)
    work = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, g.n, requests), dtype=torch.int32, device=dev)
    shape = (len(mesh.local_model), -1, index.l)    # the local shards' rows
    iv, ii = index.values.reshape(shape), index.indices.reshape(shape)
    t0 = time.perf_counter()
    tiles = [step(slabs, work[j:j + q_tile], iv, ii)
             for j in range(0, requests, q_tile)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tiles_s = time.perf_counter() - t0
    served = (serve(mesh, g, index, serve_n, q_tile, seed) if serve_n
              else None)
    return index, stats, build_s, tiles, tiles_s, served


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="default cuda:{LOCAL_RANK}; cpu runs the plain path")
    p.add_argument("--backend", default=None, help="nccl or gloo")
    p.add_argument("--data", type=int, default=1)
    p.add_argument("--model", type=int, default=4)
    p.add_argument("--n-log2", type=int, default=12)
    # no option a prefix of torchrun's own (--r, --l): it would take them
    p.add_argument("--walks", type=int, default=16, help="r a source")
    p.add_argument("--index-l", type=int, default=32, help="l a row")
    p.add_argument("--source-batch", type=int, default=256)
    p.add_argument("--requests", type=int, default=1024)
    p.add_argument("--q-tile", type=int, default=256)
    p.add_argument("--serve", type=int, default=0, metavar="N",
                   help="then serve N requests through PPRService")
    p.add_argument("--stacked", action="store_true",
                   help="one process, the shards stacked (ShardMesh)")
    args = p.parse_args(argv)
    sizes = dict(n_log2=args.n_log2, r=args.walks, l=args.index_l,
                 source_batch=args.source_batch, requests=args.requests,
                 q_tile=args.q_tile, serve_n=args.serve)

    import torch.distributed as dist

    from repro_torch.distributed import ShardMesh
    from repro_torch.launch.mesh import make_rank_mesh

    if args.stacked:
        mesh = ShardMesh(args.data, args.model, device=args.device or "cuda")
        _, stats, build_s, tiles, tiles_s, served = run(mesh, **sizes)
        print(json.dumps(dict(stacked=[args.data, args.model],
                              build_s=round(build_s, 3),
                              digest=answers_digest(tiles))))
        print(f"{len(tiles)} tiles of {args.q_tile}: "
              f"{1e3 * tiles_s / len(tiles):.3f} ms a tile")
        if served is not None:
            print_service(served, "stacked")
        return 0

    mesh = make_rank_mesh(args.data, args.model, backend=args.backend,
                          device=args.device)
    _, stats, build_s, tiles, tiles_s, served = run(mesh, **sizes)
    mine = dict(rank=dist.get_rank(), shard=[mesh.local_data[0],
                                             mesh.local_model[0]],
                build_s=round(build_s, 3), digest=answers_digest(tiles))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if dist.get_rank() == 0:
        print(json.dumps({k: stats[k] for k in (
            "n", "n_pad", "shards", "r_splits", "kept_mass",
            "dropped_mass")}))
        for rec in every:
            print(json.dumps(rec))
        print(f"{len(tiles)} tiles of {args.q_tile}: "
              f"{1e3 * tiles_s / len(tiles):.3f} ms a tile on rank 0; "
              f"answers the same bytes on every rank: "
              f"{len({rec['digest'] for rec in every}) == 1}")
        if served is not None:
            print_service(served, f"1 x {args.model} ranks")
    dist.destroy_process_group()
    return 0


def print_service(served, what: str) -> None:
    """One JSON line of a ``--serve`` run: its qps, p50 / p99 (ms) and
    the answers' digest."""
    answers, stats = served
    print(json.dumps(dict(service=what, served=len(answers),
                          qps=round(stats["qps"], 1),
                          p50_ms=round(1e3 * stats["latency_p50"], 3),
                          p99_ms=round(1e3 * stats["latency_p99"], 3),
                          service_digest=service_answers_digest(answers))))


if __name__ == "__main__":
    raise SystemExit(main())
