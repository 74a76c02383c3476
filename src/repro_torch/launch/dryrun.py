"""Dry-run: trace every (arch x shape) cell and the paper's PPR engine
cells on the ``meta`` device, and set their cost against the card.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell on 256 or 512 forced host devices and reads the
compiled program.  The port has no program to read: it builds each cell's
full-size :class:`~repro_torch.launch.steps.StepBundle` on ``meta``, makes
the parameters with ``init_fn`` (float leaves cast to bf16 for serving),
the batch from ``batch_spec`` and the cache with ``make_cache``, all on
meta (nothing is allocated), and runs ``step_fn`` once under a
:class:`~repro_torch.roofline.cost.CostCounter`, which charges every aten
op by the reference's traffic rules and tracks the live bytes.  The record
holds the per-device FLOPs, HBM bytes, collective bytes, the memory
analysis, the three roofline terms against the H100 and whether the cell
fits the card.

The model cells run on **one card** (``mesh_tag`` ``card``).  Each LM
record also holds, under ``mesh_16x16``, the bytes one device of the
16 x 16 production mesh holds of the cell's parameters (and, for
``train_4k``, of its optimizer state) laid out by
``distributed/sharding.py``'s specs, the reference's ``in_shardings``.
The PPR engine cells run on the production meshes (``launch/mesh.py``:
16 x 16, and 32 x 16 for two pods), stacked on meta.  ``--workers N``
traces the model cells in N processes, the slowest first (a 64-layer
``train_4k`` takes a minute or two on the host).

Data-dependent shapes: a GCN cell's bag width is the widest in-degree of
its edges, which a meta tensor cannot give; the dry-run draws the cell's
batch on the CPU from the cell's seed and lays out the bags at its widths
(``models.gcn.host_twins``).  The walk-counts step folds its key on the
host: the dry-run passes a real CPU key and meta tensors for the rest.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all --workers 8 --out results/dryrun
    python -m repro_torch.launch.dryrun --ppr --mesh both --out results/dryrun
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.configs import all_cells, get_arch
from repro_torch.device import OnMeta as _OnMeta
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.models import gcn as gcn_mod
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.cost import CostCounter
from repro_torch.training import train_loop
from repro_torch.tree import tree_map

META = torch.device("meta")
SEED = 0          # parameters; a GCN batch is drawn from SEED + 1
# the most one card's peak may be predicted at before a step traced on
# meta is run on an 80 GB card
PEAK_LIMIT = 75e9


def _serve_params(params, dtype=torch.bfloat16):
    """Serving holds bf16 weights (no optimizer): cast float leaves."""
    if dtype is None:
        return params
    return tree_map(lambda t: t.to(dtype)
                    if torch.is_floating_point(t) else t, params)


def _meta_batch(spec) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(shape, dtype=dt, device=META)
            for k, (shape, dt) in spec.items()}


def _gcn_twins(arch, shape_name: str, batch, *, reduced: bool = False):
    """``(meta, cpu)`` pairs of the cell's integer batch arrays, the CPU
    side drawn from ``SEED + 1`` by the cell's own ``make_batch``."""
    cpu = steps_mod.build(arch, shape_name, reduced=reduced, device="cpu")
    drawn = cpu.make_batch(torch.Generator().manual_seed(SEED + 1))
    return [(batch[k], v) for k, v in drawn.items()
            if not torch.is_floating_point(v)]


def mesh_bytes(arch, params, opt_state=None) -> dict:
    """The bytes one device of the 16 x 16 production mesh holds of
    ``params`` (and ``opt_state``) under ``sharding``'s specs."""
    mesh = make_production_mesh()
    pspecs = sharding.param_specs(arch.family, params, arch.config)
    out = dict(shape=dict(mesh.shape), param_bytes=sharding.per_device_bytes(
        params, pspecs, mesh))
    if opt_state is not None:
        out["opt_bytes"] = sharding.per_device_bytes(
            opt_state, sharding.opt_state_specs(pspecs), mesh)
    return out


def trace_cell(arch_id: str, shape_name: str, *, reduced: bool = False,
               batch: Optional[int] = None,
               serve_dtype: Optional[torch.dtype] = torch.bfloat16,
               config_overrides: Optional[dict] = None
               ) -> Tuple[Any, dict]:
    """One model cell on meta: ``(Cost, ctx)``, the cost of one step on
    one card.  ``batch`` replaces the shape's global batch,
    ``config_overrides`` model-config fields (a depth cut: an LM train
    cell keeps the published config's rules) and ``serve_dtype=None``
    keeps a serving cell's parameters as ``init_fn`` makes them (f32): a
    run as the card's phases make it, set beside its measurement."""
    arch = get_arch(arch_id)
    if batch is not None:
        shape = dataclasses.replace(arch.shape(shape_name),
                                    global_batch=batch)
        arch = dataclasses.replace(arch, shapes=tuple(
            shape if s.name == shape_name else s for s in arch.shapes))
    bundle = steps_mod.build(arch, shape_name, reduced=reduced, device=META,
                             config_overrides=config_overrides)
    with _OnMeta():
        params = bundle.init_fn(SEED)
    batch = _meta_batch(bundle.batch_spec)
    if bundle.kind == "train":
        with _OnMeta():
            opt_state = train_loop.init_state(bundle.opt_cfg, params)
        args = (params, opt_state, batch)
    elif bundle.make_cache is not None:
        with _OnMeta():
            cache = bundle.make_cache()
        args = (_serve_params(params, serve_dtype), cache, batch)
    else:
        args = (_serve_params(params, serve_dtype), batch)
    twins = (_gcn_twins(arch, shape_name, batch, reduced=reduced)
             if arch.family == "gnn" else [])
    counter = CostCounter()
    counter.arguments(args)
    with gcn_mod.host_twins(twins), counter:
        out = bundle.step_fn(*args)
    cost = counter.result(out)
    ctx = dict(arch=arch_id, shape=shape_name, kind=bundle.kind,
               model_flops=bundle.model_flops_per_step,
               mesh=describe(ShardMesh(1, 1, device=META)),
               global_batch=arch.shape(shape_name).global_batch)
    if arch.family == "lm":
        ctx["mesh_16x16"] = mesh_bytes(
            arch, args[0], args[1] if bundle.kind == "train" else None)
    return cost, ctx


def trace_rank_cell(arch_id: str, shape_name: str, data: int, model: int,
                    *, shard=(0, 0), reduced: bool = False,
                    batch: Optional[int] = None,
                    config_overrides: Optional[dict] = None
                    ) -> Tuple[Any, dict]:
    """One LM train cell's step as one rank of a ``data x model`` rank
    mesh runs it (shard ``shard``), on meta: ``(Cost, ctx)``.  The rank
    is a :class:`~repro_torch.distributed.mesh.MetaRankMesh`, so the
    parameters and moments are its blocks of the 2-D layout
    (``sharding.rank_param_specs``), the gathers and reduce-scatters
    allocate what a rank's do, and the cost's memory is one card's of
    the mesh: the gate of a run on ``data * model`` cards.  ``batch``,
    ``reduced`` and ``config_overrides`` cut the cell as
    :func:`trace_cell`'s do, the published rules kept."""
    from repro_torch.distributed.mesh import MetaRankMesh

    arch = get_arch(arch_id)
    if batch is not None:
        shape = dataclasses.replace(arch.shape(shape_name),
                                    global_batch=batch)
        arch = dataclasses.replace(arch, shapes=tuple(
            shape if s.name == shape_name else s for s in arch.shapes))
    mesh = MetaRankMesh(data, model, shard)
    bundle = steps_mod.build(arch, shape_name, reduced=reduced, device=META,
                             config_overrides=config_overrides,
                             published_rules=True, mesh=mesh)
    with _OnMeta():
        params = bundle.init_fn(SEED)
        opt_state = train_loop.init_state(bundle.opt_cfg, params)
    args = (params, opt_state, _meta_batch(bundle.batch_spec))
    counter = CostCounter()
    counter.arguments(args)
    with counter:
        out = bundle.step_fn(*args)
    cost = counter.result(out)
    ctx = dict(arch=arch_id, shape=shape_name, kind=bundle.kind,
               model_flops=bundle.model_flops_per_step / (data * model),
               mesh=dict(shape={"data": data, "model": model},
                         n_devices=data * model, shard=list(shard)),
               global_batch=arch.shape(shape_name).global_batch)
    return cost, ctx


def _record(cost, ctx, hw: roof.Hardware, t0: float, mesh_tag: str) -> dict:
    terms = roof.roofline_from_counts(
        cost, hw=hw, model_flops_total=ctx["model_flops"],
        n_devices=ctx["mesh"]["n_devices"])
    fits, used = roof.fit_check(terms, hw)
    return dict(ok=True, seconds=round(time.monotonic() - t0, 1), **ctx,
                mesh_tag=mesh_tag, roofline=terms.as_dict(), hbm_used=used,
                hbm_fits=fits, hardware=hw.as_dict())


def _write(rec: dict, out_dir: Optional[str], stem: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{stem}.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)


def _failed(t0, arch, shape, mesh_tag, e) -> dict:
    return dict(ok=False, seconds=round(time.monotonic() - t0, 1),
                arch=arch, shape=shape, mesh_tag=mesh_tag,
                error=f"{type(e).__name__}: {e}",
                traceback=traceback.format_exc()[-2000:])


def run_cell(arch_id, shape_name, out_dir=None, mesh_tag="card", *,
             hw: roof.Hardware = roof.HW) -> dict:
    t0 = time.monotonic()
    try:
        cost, ctx = trace_cell(arch_id, shape_name)
        rec = _record(cost, ctx, hw, t0, mesh_tag)
    except Exception as e:  # recorded, not raised: the sweep must finish
        rec = _failed(t0, arch_id, shape_name, mesh_tag, e)
    _write(rec, out_dir, f"{arch_id}__{shape_name}__{mesh_tag}")
    status = "OK " if rec.get("ok") else "FAIL"
    if rec.get("ok"):
        r = rec["roofline"]
        extra = (f"dom={r['dominant']} comp={r['compute_s']:.3e}s "
                 f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
                 f"hbm={rec['hbm_used']/1e9:.1f}GB fits={rec['hbm_fits']}")
    else:
        extra = rec["error"][:160]
    print(f"[{status}] {arch_id:22s} {shape_name:14s} {mesh_tag:8s} "
          f"{rec['seconds']:7.1f}s  {extra}", flush=True)
    return rec


def cost_rank(cell) -> tuple:
    """A sort key of model cells, the slowest to trace first: training
    (three passes a layer, microbatched), then the LMs' prefill, each by
    parameter count."""
    spec = get_arch(cell[0])
    kind = spec.shape(cell[1]).kind
    n = spec.config.param_count() if spec.family == "lm" else 0
    return (kind != "lm_train", kind != "lm_prefill", -n)


def run_jobs(jobs, workers: int = 1) -> list:
    """``fn(*args, **kwargs)`` of each ``(fn, args, kwargs)`` job (module
    functions, such as :func:`run_cell` or :func:`trace_cell`), submitted
    in the given order to ``workers`` spawned processes (each imports torch
    anew; nothing of a caller's CUDA state is forked), or run here with
    ``workers <= 1``.  Returns each job's result, or the exception it
    raised, in the jobs' order."""
    def guarded(fn, args, kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - returned to the caller
            return e
    if workers <= 1:
        return [guarded(*job) for job in jobs]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        futures = [ex.submit(fn, *args, **kwargs) for fn, args, kwargs in jobs]
        return [f.exception() or f.result() for f in futures]


def run_cells(cells, out_dir=None, mesh_tag="card", *,
              hw: roof.Hardware = roof.HW, workers: int = 1) -> List[dict]:
    """:func:`run_cell` over ``cells``, their records in ``cells``' order;
    with ``workers > 1`` in that many processes, the slowest first."""
    order = sorted(range(len(cells)), key=lambda i: cost_rank(cells[i]))
    recs = run_jobs([(run_cell, (*cells[i], out_dir, mesh_tag), dict(hw=hw))
                     for i in order], workers)
    return [recs[order.index(i)] for i in range(len(cells))]


# ---------------------------------------------------------------------------
# The paper's own workload: distributed PPR engine cells
# ---------------------------------------------------------------------------

# (name, n, m, q_tile, index_l, exchange/widths, walks)
PPR_CELLS = {
    # twitter-2010: 41.65M vertices / 1.47B edges; sparse-frontier wire
    # format (the default): degree_cap caps each slot's gather budget and
    # hub splitting keeps every gather axis at 256
    "ppr_verd_twitter": dict(n=41_652_240, m=1_468_365_182, q_tile=8,
                             index_l=256, frontier_k=4096, wire_k=4096,
                             degree_cap=4096, hub_split_degree=256),
    # legacy dense-slab exchange (the oracle path, for roofline comparison)
    "ppr_verd_twitter_dense": dict(n=41_652_240, m=1_468_365_182, q_tile=4,
                                   index_l=256, exchange="dense"),
    # uk-union: 133.6M vertices / 5.51B edges
    "ppr_verd_ukunion": dict(n=133_633_040, m=5_507_679_822, q_tile=2,
                             index_l=48, frontier_k=2048, wire_k=2048,
                             degree_cap=2048, hub_split_degree=256),
    # MCFP offline indexing step on twitter (graph replicated: 6.2 GB)
    "ppr_walk_twitter": dict(n=41_652_240, m=1_468_365_182, q_tile=32,
                             walks=True),
}


def ppr_config(spec: dict, mesh: ShardMesh):
    from repro_torch.core import distributed_engine as de

    ep = mesh.model
    n = ((spec["n"] + ep - 1) // ep) * ep
    return de.DistConfig(
        n=n, ep=ep, q_tile=spec["q_tile"], t_iterations=2,
        index_l=spec.get("index_l", 0),
        exchange=spec.get("exchange", "sparse"),
        frontier_k=spec.get("frontier_k", 0),
        wire_k=spec.get("wire_k", 0),
        degree_cap=spec.get("degree_cap", 0),
        hub_split_degree=spec.get("hub_split_degree", 0),
        wire_dtype=spec.get("wire_dtype", torch.bfloat16),
    )


def trace_ppr_cell(name: str, mesh: ShardMesh, *,
                   spec: Optional[dict] = None) -> Tuple[Any, dict]:
    """One PPR engine cell on the stacked ``mesh``: ``(per-device Cost,
    ctx)``.  The VERD tile stacks the ``model`` shards (every data replica
    serves the same tile, whose sources it shares, as the reference's
    replicated ``P()`` input), so its per-device cost is the total over
    ``mesh.model``.  The walk counts give every data replica the same
    shapes, so one replica is traced, on a ``1 x model`` mesh, and its
    total over ``mesh.model`` is the per-device cost; each replica's walks
    are advanced once for its ``model`` shards, where each of the
    reference's devices advances them, so that part is a lower bound.  The
    graph and the key are replicated: every device holds them whole."""
    from repro_torch.core import distributed_engine as de

    spec = PPR_CELLS[name] if spec is None else spec
    cfg = ppr_config(spec, mesh)
    dev = mesh.device
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    i32 = torch.int32
    counter = CostCounter()
    if spec.get("walks"):
        w = 1 << 16                             # one data replica's walks
        traced = ShardMesh(data=1, model=mesh.model, device=dev)
        step = de.make_walk_counts_step(cfg, traced, max_steps=64)
        graph = (e((spec["n"] + 1,), i32),      # row_ptr (replicated)
                 e((spec["m"],), i32),          # col_idx
                 e((spec["n"],), i32),          # out_deg
                 )
        walks = (e((w,), i32),                  # walk sources
                 e((w,), i32))                  # walk count rows
        args = graph + walks + (rng.prng_key(SEED),)   # the key: host
        counter.arguments(graph, replicated=True)
        counter.arguments(walks)
        # the reference's global walks and nominal flop count
        model_flops = 8.0 * w * mesh.data * 64
    else:
        traced = mesh
        m_shard = (spec["m"] + cfg.ep - 1) // cfg.ep
        m_shard = ((m_shard + 1023) // 1024) * 1024
        slabs = de.ShardedGraph.specs(cfg, m_shard, device=dev)
        step = de.make_verd_tile_step(cfg, mesh)
        sources = e((cfg.q_tile,), i32)
        index = (e((cfg.ep, cfg.n_shard, cfg.index_l), torch.bfloat16),
                 e((cfg.ep, cfg.n_shard, cfg.index_l), i32))
        args = (slabs, sources) + index
        counter.arguments(sources, replicated=True)
        counter.arguments((slabs, index))
        model_flops = (cfg.t_iterations * 2.0 * spec["m"] * cfg.q_tile
                       + 2.0 * cfg.q_tile * cfg.n * cfg.index_l)
    with counter:
        out = step(*args)
    cost = counter.result(out).per_device(mesh.model)
    ctx = dict(arch="powerwalk-engine", shape=name, kind="serve",
               model_flops=model_flops, mesh=describe(mesh),
               traced_mesh=describe(traced))
    return cost, ctx


def run_ppr_cell(name, mesh, out_dir=None, mesh_tag="pod", *,
                 hw: roof.Hardware = roof.HW) -> dict:
    t0 = time.monotonic()
    try:
        cost, ctx = trace_ppr_cell(name, mesh)
        rec = _record(cost, ctx, hw, t0, mesh_tag)
    except Exception as e:
        rec = _failed(t0, "powerwalk-engine", name, mesh_tag, e)
    _write(rec, out_dir, f"powerwalk__{name}__{mesh_tag}")
    status = "OK " if rec.get("ok") else "FAIL"
    extra = (rec["error"][:160] if not rec.get("ok") else
             f"dom={rec['roofline']['dominant']} "
             f"coll={rec['roofline']['collective_s']:.3e}s "
             f"hbm={rec['hbm_used']/1e9:.1f}GB fits={rec['hbm_fits']}")
    print(f"[{status}] powerwalk-engine       {name:22s} {mesh_tag:8s} "
          f"{rec['seconds']:7.1f}s  {extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod", help="the PPR cells' meshes")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ppr", action="store_true",
                    help="run the PowerWalk engine cells")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes tracing the model cells")
    args = ap.parse_args(argv)

    n_fail = 0
    if args.ppr:
        meshes = []
        if args.mesh in ("pod", "both"):
            meshes.append(("pod", make_production_mesh(multi_pod=False)))
        if args.mesh in ("multipod", "both"):
            meshes.append(("multipod", make_production_mesh(multi_pod=True)))
        for mesh_tag, mesh in meshes:
            for name in PPR_CELLS:
                rec = run_ppr_cell(name, mesh, args.out, mesh_tag)
                n_fail += 0 if rec.get("ok") else 1
        print(f"done; failures: {n_fail}", flush=True)
        raise SystemExit(1 if n_fail else 0)

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    recs = run_cells(cells, args.out, "card", workers=args.workers)
    n_fail += sum(0 if rec.get("ok") else 1 for rec in recs)
    print(f"done; failures: {n_fail}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
