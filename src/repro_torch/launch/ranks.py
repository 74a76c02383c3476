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
prints the service's qps, p50 / p99 and its answers' digest; ``--mode``
and ``--frontier-path`` pick the service's mode and route (default
``powerwalk`` on the sparse route)::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.ranks \\
        --device cpu --model 4 --n-log2 10 --serve 64 --mode fppr

With ``--stacked`` (no ``torchrun``) one process runs the same on a
stacked ``ShardMesh`` (its service on the assembled index) and prints the
digests the ranks' must equal.

With ``--train ARCH`` the ranks take one LM train step instead
(:func:`train_once`): each holds its blocks of every leaf in the
reference's 2-D layout (``sharding.rank_param_specs``: tensor parallel
over ``model``, FSDP over ``data``) and its data shard's rows of each
microbatch, under the published config's train rules (microbatches, fp8
``mu``, bf16 ``nu`` and accumulator above 6e10 parameters), and rank 0
prints one JSON line of the loss, ``grad_norm``, the step's seconds and
tokens/s, each rank's peak device memory beside its prediction, and a
digest of the assembled parameters (:func:`params_digest`), which
``--stacked`` prints for the same step on a stacked mesh.  On the card
rank 0 first traces a rank's step on meta
(``launch.dryrun.trace_rank_cell``) and the ranks stop unless the
prediction is within ``launch.dryrun.PEAK_LIMIT``.  ``--reduced`` takes
the smoke config, ``--layers N`` cuts the published one's depth,
``--batch B`` the shape's batch, ``--steps N`` takes N steps on one
batch (the first is cold; the last is timed)::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.ranks \
        --device cpu --data 2 --model 2 --train dbrx-132b --reduced
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.ranks \
        --data 2 --model 2 --train command-r-plus-104b --layers 2 --batch 8
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


def service_config(max_batch: int, mode: str = "powerwalk",
                   frontier_path: str = "sparse"):
    """The service ``--serve`` runs: 3c's query in ``mode`` on
    ``frontier_path`` (by default ``powerwalk`` on the sparse route)."""
    from repro_torch.core.query import QueryConfig
    from repro_torch.serving import ServiceConfig
    from repro_torch.serving.batching import BatchingConfig
    from repro_torch.serving.pipeline import PipelineConfig

    return ServiceConfig(
        query=QueryConfig(mode=mode, t_iterations=2, top_k=50,
                          hub_split_degree=64, frontier_path=frontier_path),
        batching=BatchingConfig(max_batch=max_batch, max_wait_s=0.05),
        pipeline=PipelineConfig(depth=4))


def serve(mesh, g, index, requests: int, max_batch: int, seed: int = 0,
          **query):
    """``requests`` of :func:`run`'s requests served through
    ``PPRService`` over ``index`` (``query``: :func:`service_config`'s
    mode and route): on a ``ShardMesh`` one service on the
    assembled index; on a ``RankMesh`` the first data replica's ranks as a
    ``1 x model`` rank service (the others return ``None`` at once), the
    leader returning ``(answers, stats)`` and a follower ``None``."""
    import numpy as np

    from repro_torch.distributed import RankMesh
    from repro_torch.serving import PPRService
    from repro_torch.serving.engine import serve_follower

    work = np.random.default_rng(seed + 1).integers(
        0, g.n, requests).tolist()
    cfg = service_config(max_batch, **query)
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
        requests: int, q_tile: int, seed: int = 0, serve_n: int = 0,
        mode: str = "powerwalk", frontier_path: str = "sparse"):
    """This rank's share of the build and of ``requests`` answered in
    tiles of ``q_tile`` on ``mesh``: ``(index, stats, build_s, tiles,
    tiles_s, served)``, the index the rank's own rows; ``served`` is
    :func:`serve`'s of ``serve_n`` requests in batches of ``q_tile`` in
    ``mode`` on ``frontier_path`` (``None`` without)."""
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
    served = (serve(mesh, g, index, serve_n, q_tile, seed, mode=mode,
                    frontier_path=frontier_path) if serve_n else None)
    return index, stats, build_s, tiles, tiles_s, served


def _bytes(t) -> bytes:
    import torch

    return t.detach().contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()


def params_digest(params, mesh, specs) -> str:
    """sha256 of the assembled parameters without assembling them: in
    flatten order, a replicated leaf's bytes, a sharded leaf's distinct
    blocks' (under ``specs``) own sha256 in shard order (a rank hashes its
    block and the digests are gathered; a stacked mesh hashes the blocks
    of its whole leaves).  The same on every rank, and equal to the
    stacked mesh's where the blocks are."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.tree import tree_leaves

    rank = sharding.is_rank_mesh(mesh)
    h = hashlib.sha256()
    for x, spec in zip(tree_leaves(params), sharding._spec_leaves(specs)):
        if sharding.is_replicated(spec):
            h.update(_bytes(x))
            continue
        if rank:
            mine = torch.frombuffer(bytearray(hashlib.sha256(
                _bytes(x)).digest()), dtype=torch.uint8).to(mesh.device)
            every = [bytes(b.cpu().numpy()) for b in mesh.gather_blocks(
                mine[None], ("data", "model"), dst=None)]
        else:
            blocks = sharding.shard(x, spec, mesh)
            every = [hashlib.sha256(_bytes(blocks[d, m])).digest()
                     for d in range(mesh.data) for m in range(mesh.model)]
        for d, m in sharding.distinct_blocks(spec, mesh):
            h.update(every[d * mesh.model + m])
    return h.hexdigest()


def train_bundle(mesh, arch: str, *, shape: str = "train_4k",
                 reduced: bool = False, layers: Optional[int] = None,
                 batch: Optional[int] = None, overrides=None):
    """The LM train cell ``arch`` x ``shape`` on ``mesh`` under the
    published config's train rules: the smoke config (``reduced``) or the
    published one with ``layers`` layers, ``batch`` rows in place of the
    shape's where given, ``overrides`` replacing config fields."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps

    spec = get_arch(arch)
    if batch is not None:
        cut = dataclasses.replace(spec.shape(shape), global_batch=batch)
        spec = dataclasses.replace(spec, shapes=tuple(
            cut if s.name == shape else s for s in spec.shapes))
    over = dict(overrides or {})
    if layers is not None:
        over["n_layers"] = layers
    return steps.build(spec, shape, reduced=reduced, device=mesh.device,
                       config_overrides=over or None, published_rules=True,
                       mesh=mesh)


def train_once(mesh, arch: str, *, seed: int = 0, steps: int = 1, **cut):
    """``steps`` train steps of :func:`train_bundle`'s cell on ``mesh``
    (each rank its blocks) on one batch, from parameters and a batch drawn
    from ``seed``: returns ``(metrics, params, opt_state, seconds,
    specs)``, the last step's metrics as floats (``loss``, ``grad_norm``,
    ``lr``) with each step's seconds and loss, the microbatches and moment
    dtypes, ``seconds`` the last step's, ``specs`` the parameters'
    layout."""
    import torch

    from repro_torch.training import train_loop

    bundle = train_bundle(mesh, arch, **cut)
    params = bundle.init_fn(seed)
    state = train_loop.init_state(bundle.opt_cfg, params)
    batch = bundle.make_batch(torch.Generator().manual_seed(seed + 1))
    dev = mesh.device
    times, losses = [], []
    for _ in range(steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, metrics = bundle.step_fn(params, state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    seconds = times[-1]
    out = {k: float(v) for k, v in metrics.items()}
    if steps > 1:
        out.update(steps_s=[round(t, 3) for t in times], losses=losses)
    out.update(mu=str(bundle.opt_cfg.mu_dt).replace("torch.", ""),
               nu=str(bundle.opt_cfg.nu_dt).replace("torch.", ""),
               microbatches=bundle.microbatches,
               tokens=int(batch["tokens"].numel()))
    return out, params, state, seconds, bundle.param_specs


# the rank train check (:func:`train_case`): label -> (arch, MoEConfig
# overrides or None for a dense LM, config overrides) of a smoke config;
# dbrx at capacity 1.0 (slots drop) with remat, grok's two experts split
# in two (ep_split 2, one virtual expert a rank on 1 x 4); qwen (4 heads,
# QKV biases) with remat, command-r (6 heads over 2 kv heads: 2 x 2 only)
# with its loss in chunks of 8 positions
CASES = {
    "dbrx_cf1": ("dbrx-132b", dict(capacity_factor=1.0), dict(remat=True)),
    "grok": ("grok-1-314b", {}, {}),
    "qwen": ("qwen1.5-32b", None, dict(remat=True)),
    "command_r": ("command-r-plus-104b", None, dict(loss_chunk=8)),
}
CASE_MESHES = ((2, 2), (1, 4))     # each case runs on those it splits on
CASE_BATCH = (4, 32)               # rows, positions: two microbatches of 2
CASE_DECODE = ((2, 3), (1, 2))     # (batch, steps): split over data, not
CASE_MICROBATCHES = 2


def case_config(label: str):
    """The smoke config of :data:`CASES`' ``label``."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch, moe_over, over = CASES[label]
    cfg = get_arch(arch).reduced
    if moe_over is not None:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **moe_over))
    return dataclasses.replace(cfg, **over)


def case_meshes(label: str):
    """The ``(data, model)`` shapes of :data:`CASE_MESHES` the case's layout
    splits on (command-r's 6 heads do not split over 4)."""
    from repro_torch.distributed import ShardMesh
    from repro_torch.models import transformer as tfm

    cfg, out = case_config(label), []
    for shape in CASE_MESHES:
        try:
            tfm._mesh_check(cfg, ShardMesh(*shape, device="cpu"))
        except ValueError:
            continue
        out.append(shape)
    return tuple(out)


def leaf_paths(tree, prefix: str = ""):
    """``(path, leaf)`` of a tree of dicts in flatten order
    (``layers/w_gate``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def train_case(label: str, mesh, *, seed: int = 0):
    """Everything a check holds the LM of :data:`CASES`' ``label`` on
    ``mesh`` to the stacked mesh by.  The parameters are drawn whole from
    ``seed`` (a rank keeps its blocks, ``sharding.rank_param_specs``), a
    :data:`CASE_BATCH` batch and :data:`CASE_DECODE`'s tokens from numpy's
    generator 5.  Returns ``({name: tensor}, {leaf path: spec})``:
    ``forward`` of the batch's first two rows (``h``, ``aux``);
    ``loss_fn``'s value, parts and gradients (``grad/<path>``), and its
    gradients at 3 tokens, which do not split over ``data`` (``grad3/``);
    each ``decode_step``'s logits (``decode/<batch>/<step>``); and one
    ``make_train_step(mesh=)`` step of :data:`CASE_MICROBATCHES` from a
    copy of the parameters under the large LMs' published rules (fp8
    ``mu``, bf16 ``nu`` and accumulator; ``b1`` 0.5 and a clip that does
    not bind keep most of ``mu`` above fp8's least subnormal): its
    ``step_loss``, ``grad_norm``, ``param/``, ``mu/`` and ``nu/``."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_map

    cfg = case_config(label)
    dev = mesh.device
    whole = tfm.init(cfg, seed, device=dev)
    specs = sharding.rank_param_specs(whole, cfg, mesh)
    params = sharding.rank_blocks(whole, specs, mesh)
    del whole
    r = np.random.default_rng(5)
    b, s = CASE_BATCH
    toks = r.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[1, 20:] = 0.0
    batch = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        tokens=toks, labels=np.roll(toks, -1, axis=1), mask=mask).items()}
    out = {}
    out["h"], out["aux"] = tfm.forward(cfg, params, batch["tokens"][:2],
                                       mesh=mesh)
    loss_fn = functools.partial(tfm.loss_fn, cfg, mesh=mesh)
    grads_of = train_loop.value_and_grad(loss_fn)
    out["loss"], parts, grads = grads_of(params, batch)
    out.update(ce=parts["ce"], loss_aux=parts["aux"])
    out.update({f"grad/{k}": v for k, v in leaf_paths(grads)})
    _, _, grads = grads_of(params, {k: v[:1, :3] for k, v in batch.items()})
    out.update({f"grad3/{k}": v for k, v in leaf_paths(grads)})
    for bsz, n in CASE_DECODE:
        toks = torch.from_numpy(r.integers(0, cfg.vocab, (n, bsz, 1)).astype(
            np.int32)).to(dev)
        cache = tfm.init_cache(cfg, bsz, 8, torch.float32, device=dev)
        for i in range(n):
            out[f"decode/{bsz}/{i}"], cache = tfm.decode_step(
                cfg, params, cache, toks[i], mesh=mesh)
    opt = dataclasses.replace(
        steps.SMOKE_OPT, mu_dtype=torch.float8_e4m3fn,
        nu_dtype=torch.bfloat16, b1=0.5, grad_clip=1e3)
    step = train_loop.make_train_step(
        loss_fn, opt, microbatches=CASE_MICROBATCHES,
        accum_dtype=torch.bfloat16, mesh=mesh, specs=specs)
    p = tree_map(lambda x: x.detach().clone(), params)
    p, state, metrics = step(p, train_loop.init_state(opt, p), batch)
    out.update(step_loss=metrics["loss"], grad_norm=metrics["grad_norm"])
    for kind, tree in (("param", p), ("mu", state.mu), ("nu", state.nu)):
        out.update({f"{kind}/{k}": v for k, v in leaf_paths(tree)})
    out["digest"] = torch.tensor(list(bytes.fromhex(
        params_digest(p, mesh, specs))), dtype=torch.uint8)
    return out, dict(leaf_paths(specs))


def parser() -> argparse.ArgumentParser:
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
    p.add_argument("--mode", default="powerwalk",
                   choices=["powerwalk", "verd", "fppr", "mcfp", "pi"],
                   help="the --serve service's mode")
    p.add_argument("--frontier-path", default="sparse",
                   choices=["auto", "dense", "sparse"],
                   help="the --serve service's route")
    p.add_argument("--stacked", action="store_true",
                   help="one process, the shards stacked (ShardMesh)")
    p.add_argument("--train", default=None, metavar="ARCH",
                   help="one LM train step of ARCH instead, each rank its "
                        "blocks of the 2-D layout and its rows")
    p.add_argument("--shape", default="train_4k", help="--train's shape")
    cut = p.add_mutually_exclusive_group()
    cut.add_argument("--reduced", action="store_true",
                     help="--train the smoke config")
    cut.add_argument("--layers", type=int, default=None,
                     help="--train the published config at N layers")
    p.add_argument("--batch", type=int, default=None,
                   help="--train B rows in place of the shape's")
    p.add_argument("--steps", type=int, default=1,
                   help="--train: steps on one batch (the last timed)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: Optional[list] = None) -> int:
    args = parser().parse_args(argv)
    if args.train:
        return main_train(args)
    sizes = dict(n_log2=args.n_log2, r=args.walks, l=args.index_l,
                 source_batch=args.source_batch, requests=args.requests,
                 q_tile=args.q_tile, serve_n=args.serve, mode=args.mode,
                 frontier_path=args.frontier_path)

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


def predict_peak(args) -> float:
    """One rank's predicted peak device bytes for ``--train``'s step: the
    step traced on meta for shard ``(0, 0)`` of the mesh
    (``launch.dryrun.trace_rank_cell``), its arguments and the live bytes
    at its peak."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis as roof

    cost, _ = dryrun.trace_rank_cell(
        args.train, args.shape, args.data, args.model, batch=args.batch,
        reduced=args.reduced, config_overrides=(
            None if args.layers is None else dict(n_layers=args.layers)))
    terms = roof.roofline_from_counts(cost, hw=roof.HW)
    return float(roof.fit_check(terms, roof.HW)[1])


def train_mesh(args):
    """``--train``'s mesh: a stacked ``ShardMesh`` under ``--stacked``, else
    this process's rank of a ``RankMesh``."""
    from repro_torch.distributed import ShardMesh
    from repro_torch.launch.mesh import make_rank_mesh

    if args.stacked:
        return ShardMesh(args.data, args.model, device=args.device or "cuda")
    return make_rank_mesh(args.data, args.model, backend=args.backend,
                          device=args.device)


def train_cut(args) -> dict:
    """:func:`train_once`'s keywords from ``--train``'s options."""
    return dict(shape=args.shape, reduced=args.reduced, layers=args.layers,
                batch=args.batch, seed=args.seed, steps=args.steps)


def gate_peak(args, mesh) -> Optional[float]:
    """Ranks on cards: rank 0 predicts a rank's peak (:func:`predict_peak`)
    and prints it, and every rank stops where it is above
    ``launch.dryrun.PEAK_LIMIT``.  Returns the prediction in bytes (None
    on the CPU or a stacked mesh)."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    if mesh.device.type != "cuda" or args.stacked:
        return None
    verdict = [None]
    if dist.get_rank() == 0:
        t0 = time.perf_counter()
        verdict = [(predict_peak(args), time.perf_counter() - t0)]
    dist.broadcast_object_list(verdict, src=0)
    predicted, seconds = verdict[0]
    if dist.get_rank() == 0:
        print(json.dumps(dict(predicted_peak_gb=round(predicted / 1e9, 3),
                              limit_gb=dryrun.PEAK_LIMIT / 1e9,
                              traced_s=round(seconds, 3))), flush=True)
    if predicted > dryrun.PEAK_LIMIT:
        dist.destroy_process_group()
        raise SystemExit(f"the predicted peak {predicted / 1e9:.2f} GB a "
                         f"rank is above {dryrun.PEAK_LIMIT / 1e9:.0f} GB")
    return predicted


def report_train(args, mesh, run, predicted: Optional[float]) -> None:
    """Rank 0's (or the stacked mesh's) JSON line of :func:`train_once`'s
    ``run``: the metrics, the last step's seconds and tokens/s, on cards
    each rank's peak device memory beside ``predicted``, and the
    parameters' digest (:func:`params_digest`, a collective: every rank
    calls this)."""
    import torch
    import torch.distributed as dist

    metrics, params, _, seconds, specs = run
    digest = params_digest(params, mesh, specs)
    metrics = dict(metrics, step_s=round(seconds, 3),
                   tokens_s=round(metrics["tokens"] / seconds, 1))
    if mesh.device.type == "cuda":
        peaks = [torch.cuda.max_memory_allocated(mesh.device) / 1e9]
        if not args.stacked:
            peaks = [None] * dist.get_world_size()
            dist.all_gather_object(
                peaks, torch.cuda.max_memory_allocated(mesh.device) / 1e9)
        metrics.update(peak_gb=[round(x, 3) for x in peaks],
                       predicted_peak_gb=(None if predicted is None
                                          else round(predicted / 1e9, 3)))
    if args.stacked or dist.get_rank() == 0:
        cut = train_cut(args)
        print(json.dumps(dict(
            train=args.train, mesh=[args.data, args.model],
            ranks=not args.stacked, **{
                k: v for k, v in cut.items() if v is not None
                and v is not False and (k, v) != ("steps", 1)},
            **metrics, params_digest=digest)), flush=True)


def main_train(args) -> int:
    """``--train``: the step on the rank mesh (or ``--stacked``), gated on
    cards by :func:`gate_peak`, then :func:`report_train`'s line."""
    import torch.distributed as dist

    mesh = train_mesh(args)
    predicted = gate_peak(args, mesh)
    report_train(args, mesh, train_once(mesh, args.train, **train_cut(args)),
                 predicted)
    if not args.stacked:
        dist.barrier()
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
