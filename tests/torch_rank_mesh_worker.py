"""The rank side of ``tests/test_torch_rank_mesh.py`` (and of the card's
rank-mesh test in ``tests/test_torch_cuda.py``): scenarios that run one
shard a process on a ``RankMesh`` and write what each rank got to
``rank{r}.npz``, and the same computations on the stacked ``ShardMesh``
for the tests to hold them against.  Imports no JAX: the reference's
inputs reach the ranks through ``inputs.npz``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from repro_torch import convert, rng
from repro_torch.core import distributed_engine as tde
from repro_torch.core import index as tindex
from repro_torch.distributed import RankMesh, ShardMesh
from repro_torch.graphs import synthetic as tsyn

N_PAD = 128          # the tile graph: erdos_renyi(120) padded
SOURCES = np.array([0, 3, 7, 11, 19, 23, 31, 42], np.int32)
TRUNCATED = dict(frontier_k=4, wire_k=4, combine_wire_k=8)
# (label, exchange and widths) of the 1 x 4 tile-step scenarios
TILE_CASES = {
    "covering_hub0": dict(frontier_k=N_PAD),
    "covering_hub3": dict(frontier_k=N_PAD, hub_split_degree=3),
    "truncated_hub0": dict(TRUNCATED),
    "truncated_hub3": dict(TRUNCATED, hub_split_degree=3),
    "dense": dict(exchange="dense", edge_chunk=100),
    "dense_compress_k": dict(exchange="dense", compress_k=8),
}
# (label, mesh, graph n, build arguments) of the build scenarios
BUILD_CASES = {
    f"{mesh[0]}x{mesh[1]}_{name}": (mesh, n, kw)
    for mesh in ((2, 2), (1, 4))
    for name, n, kw in (
        ("respawn", 64, dict(r=64, l=6, respawn=True, touch_bits=0,
                             source_batch=16)),
        ("schedule_touch", 64, dict(r=32, l=8, respawn=False,
                                    touch_bits=32, source_batch=16)),
        ("pads_touch", 60, dict(r=32, l=8, respawn=True, touch_bits=32,
                                source_batch=8)),
    )
}
WALK_Q, WALK_W = 8, 48       # the walk-counts step: rows, walks
MESHES = ((2, 2), (1, 4), (4, 1))


def build_graph(n, device="cpu"):
    """``tests/test_torch_distributed.py``'s build graph (n = 64), or its
    n = 60 graph that pads to 64."""
    return tsyn.erdos_renyi(n, 4.0, seed=21 if n == 64 else 11,
                            device=device)


def tile_config(inputs, **case):
    return tde.DistConfig(n=N_PAD, ep=4, q_tile=len(SOURCES), t_iterations=2,
                          index_l=int(inputs["index_l"]), top_k=N_PAD,
                          degree_cap=int(inputs["degree_cap"]), **case)


def collective_blocks(data, model):
    """Per-shard blocks ``[data, model, ...]`` from a seed."""
    r = np.random.default_rng(100 + 10 * data + model)
    return dict(
        x=r.random((data, model, 3, 5)).astype(np.float32),
        ix=r.integers(-9, 9, (data, model, 3, 2)).astype(np.int32),
        to_model=r.random((data, model, 3, model, 2)).astype(np.float32),
        to_data=r.random((data, model, 3, data, 2)).astype(np.float32),
        blk=r.random((data, model, 2, 3)).astype(np.float32),
    )


def _t(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


# -- the ranks ----------------------------------------------------------------

def _collectives(mesh, dev):
    d, m = mesh.local_data[0], mesh.local_model[0]
    b = collective_blocks(mesh.data, mesh.model)
    x = _t(b["x"][d, m], dev)[None]
    out = {}
    for axes in ("model", "data", ("data", "model")):
        tag = "+".join((axes,) if isinstance(axes, str) else axes)
        out[f"psum/{tag}"] = mesh.psum(x, axes)
        out[f"all_gather/{tag}"] = mesh.all_gather(x, axes)
        out[f"all_gather_int/{tag}"] = mesh.all_gather(
            _t(b["ix"][d, m], dev)[None], axes)
    out["all_to_all/model"] = mesh.all_to_all(
        _t(b["to_model"][d, m], dev)[None], "model")
    out["all_to_all_bf16/model"] = mesh.all_to_all(
        _t(b["to_model"][d, m], dev)[None].to(torch.bfloat16),
        "model").float()
    out["all_to_all/data"] = mesh.all_to_all(
        _t(b["to_data"][d, m], dev)[None], "data")
    blk = _t(b["blk"][d, m], dev)[None, None]
    for axis in ("data", "model"):
        out[f"psum_axis/{axis}"] = mesh.psum_axis(blk, axis)
        out[f"pmean_axis/{axis}"] = mesh.pmean_axis(blk, axis)
        for dim in (0, 1):
            out[f"all_gather_axis/{axis}/{dim}"] = mesh.all_gather_axis(
                blk, axis, dim)
    return out


def _tile_steps(mesh, inputs, dev):
    g = tsyn.erdos_renyi(120, 4.0, seed=3, device=dev)
    out = {}
    for label, case in TILE_CASES.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cfg = tile_config(inputs, **case)
        out[f"{label}/deprecation"] = torch.tensor(any(
            issubclass(w.category, DeprecationWarning)
            and "compress_k" in str(w.message) for w in caught))
        slabs = tde.build_sharded_graph(g, cfg, device=dev,
                                        shards=mesh.local_model)
        iv, ii = convert.sharded_index_from_arrays(
            inputs["index_values"], inputs["index_indices"], 4, device=dev,
            shards=mesh.local_model)
        v, i = tde.make_verd_tile_step(cfg, mesh)(
            slabs, _t(SOURCES, dev), iv, ii)
        out[f"{label}/values"], out[f"{label}/indices"] = v, i
    return out


def walk_inputs():
    r = np.random.default_rng(4)
    sources = r.integers(0, 64, WALK_W).astype(np.int32)
    rows = (np.arange(WALK_W) % WALK_Q).astype(np.int32)
    return sources, rows


def _walk_counts(mesh, dev):
    g = build_graph(64, dev)
    sources, rows = walk_inputs()
    w = WALK_W // mesh.data
    d = mesh.local_data[0]
    cfg = tde.DistConfig(n=64, ep=mesh.model, q_tile=WALK_Q)
    fp, moves = tde.make_walk_counts_step(cfg, mesh)(
        g.row_ptr, g.col_idx, g.out_deg, _t(sources[d * w:(d + 1) * w], dev),
        _t(rows[d * w:(d + 1) * w], dev), rng.prng_key(7))
    return {"fp": fp, "moves": moves}


def _sparse_walk_counts(mesh, dev):
    g = build_graph(64, dev)
    cfg = tde.DistConfig(n=64, ep=mesh.model)
    got = tde.make_sparse_walk_counts_step(cfg, mesh, r=32, l=12)(
        g.row_ptr, g.col_idx, g.out_deg,
        torch.arange(8, dtype=torch.int32, device=dev), rng.prng_key(3))
    return dict(zip(("fp_v", "fp_i", "moves", "walks", "dropped"), got))


def _build(mesh, n, kw, dev):
    index, stats = tindex.build_index_sharded(
        build_graph(n, dev), key=rng.prng_key(3), mesh=mesh, **kw)
    out = dict(values=index.values, indices=index.indices,
               kept=torch.tensor(stats["kept_mass"], dtype=torch.float64),
               dropped=torch.tensor(stats["dropped_mass"],
                                    dtype=torch.float64),
               row_offset=torch.tensor(stats["row_offset"]))
    if kw["touch_bits"]:
        out["touch"] = stats["touch"]
    return out


def _refusals(meshes, dev):
    """What a RankMesh refuses, each ``True`` where it raised as it must:
    a mesh of the wrong size or on ``meta``, and what a rank-sharded index
    does not serve yet (ROADMAP.md, queue 1): the dense route, the modes
    but ``powerwalk``, and a service mesh with data replicas."""
    from repro_torch.core.query import QueryConfig
    from repro_torch.serving import PPRService, ServiceConfig

    g = build_graph(64, dev)
    index14, _ = tindex.build_index_sharded(
        g, r=4, l=4, key=rng.prng_key(0), mesh=meshes[(1, 4)],
        source_batch=16)
    index22, _ = tindex.build_index_sharded(
        g, r=4, l=4, key=rng.prng_key(0), mesh=meshes[(2, 2)],
        source_batch=16)

    def service(index, **query):
        return lambda: PPRService(g, index, ServiceConfig(query=QueryConfig(
            **dict(dict(top_k=8, frontier_path="sparse"), **query))),
            device=dev)

    out = {}
    for name, call, match in (
        ("size", lambda: RankMesh(3, 1, dev), "3 ranks"),
        ("meta", lambda: RankMesh(2, 2, "meta"), "meta"),
        ("dense_route", service(index14, frontier_path="dense"), "ROADMAP"),
        ("fppr", service(index14, mode="fppr"), "ROADMAP"),
        ("mcfp", service(index14, mode="mcfp"), "ROADMAP"),
        ("pi", service(index14, mode="pi"), "ROADMAP"),
        ("verd", service(index14, mode="verd"), "ROADMAP"),
        ("data_mesh", service(index22), "ROADMAP"),
    ):
        try:
            call()
            out[name] = False
        except ValueError as e:
            out[name] = match in str(e)
    return {k: torch.tensor(v) for k, v in out.items()}


CARD = dict(n_log2=12, r=32, l=32, source_batch=256, requests=512,
            q_tile=128)


def _card(meshes, dev):
    """The card's check at rmat(12): the 1 x 4 build and tile steps over
    the rows it built (``launch.ranks.run``), and the 2 x 2 build."""
    from repro_torch.launch.ranks import run

    index, _, _, tiles, _ = run(meshes[(1, 4)], **CARD)
    out = dict(tile_values=torch.cat([v for v, _ in tiles]),
               tile_indices=torch.cat([i for _, i in tiles]),
               rows14_values=index.values, rows14_indices=index.indices)
    index, _ = tindex.build_index_sharded(
        tsyn.rmat(CARD["n_log2"], avg_deg=10.0, seed=0, device=dev),
        r=CARD["r"], l=CARD["l"], key=rng.prng_key(0), mesh=meshes[(2, 2)],
        source_batch=CARD["source_batch"], respawn=True)
    out.update(rows22_values=index.values, rows22_indices=index.indices)
    return out


def stacked_card(device):
    """:func:`_card` on stacked meshes: the 1 x 4 rows and tiles and the
    2 x 2 rows, whole."""
    from repro_torch.core.verd import resolve_degree_cap

    g = tsyn.rmat(CARD["n_log2"], avg_deg=10.0, seed=0, device=device)
    out = {}
    for shape in ((1, 4), (2, 2)):
        index, stats = tindex.build_index_sharded(
            g, r=CARD["r"], l=CARD["l"], key=rng.prng_key(0),
            mesh=ShardMesh(*shape, device=device),
            source_batch=CARD["source_batch"], respawn=True)
        out[shape] = index
    index = out[(1, 4)]
    cfg = tde.DistConfig(n=index.n, ep=4, q_tile=CARD["q_tile"],
                         t_iterations=2, index_l=CARD["l"], top_k=50,
                         degree_cap=resolve_degree_cap(g))
    slabs = tde.build_sharded_graph(g, cfg, device=device)
    step = tde.make_verd_tile_step(cfg, ShardMesh(1, 4, device=device))
    work = torch.as_tensor(np.random.default_rng(1).integers(
        0, g.n, CARD["requests"]), dtype=torch.int32, device=device)
    shape = (4, index.n // 4, CARD["l"])
    tiles = [step(slabs, work[j:j + CARD["q_tile"]],
                  index.values.reshape(shape), index.indices.reshape(shape))
             for j in range(0, CARD["requests"], CARD["q_tile"])]
    return dict(tile_values=torch.cat([v for v, _ in tiles]).cpu().numpy(),
                tile_indices=torch.cat([i for _, i in tiles]).cpu().numpy(),
                rows14=out[(1, 4)], rows22=out[(2, 2)])


def rank_main(rank, world, out_dir, scenarios, device, timeout_s):
    """One rank: join the group through a ``file://`` store in
    ``out_dir``, run ``scenarios`` and write ``rank{rank}.npz``."""
    from repro_torch.launch.mesh import make_rank_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    meshes = {(1, world): make_rank_mesh(
        1, world, backend="gloo", device=dev, timeout_s=timeout_s, rank=rank,
        world_size=world,
        init_method="file://" + os.path.join(out_dir, "store"))}
    meshes.update({shape: RankMesh(*shape, device=dev, timeout_s=timeout_s)
                   for shape in MESHES
                   if shape[0] * shape[1] == world and shape not in meshes})
    inputs = (dict(np.load(os.path.join(out_dir, "inputs.npz")))
              if os.path.exists(os.path.join(out_dir, "inputs.npz"))
              else {})
    out = {}

    def keep(prefix, results):
        for k, v in results.items():
            out[f"{prefix}/{k}"] = v.detach().cpu().numpy()

    for scenario in scenarios:
        if scenario == "fail":     # a rank that raises mid-step
            if rank == 2:
                raise RuntimeError("rank 2 fails on purpose")
            _tile_steps(meshes[(1, 4)], inputs, dev)
        elif scenario == "collectives":
            for shape in ((2, 2), (1, 4)):
                keep(f"collectives/{shape[0]}x{shape[1]}",
                     _collectives(meshes[shape], dev))
            if rank < 2:           # a mesh over part of the world
                keep("collectives/1x2", _collectives(RankMesh(
                    1, 2, dev, ranks=range(2), timeout_s=timeout_s), dev))
        elif scenario == "tile":
            keep("tile", _tile_steps(meshes[(1, 4)], inputs, dev))
        elif scenario == "walk_counts":
            keep("walk_counts", _walk_counts(meshes[(2, 2)], dev))
        elif scenario == "sparse_walk_counts":
            for shape in ((2, 2), (4, 1)):
                keep(f"sparse_walk_counts/{shape[0]}x{shape[1]}",
                     _sparse_walk_counts(meshes[shape], dev))
        elif scenario == "build":
            for label, (shape, n, kw) in BUILD_CASES.items():
                keep(f"build/{label}", _build(meshes[shape], n, kw, dev))
        elif scenario == "refusals":
            keep("refusals", _refusals(meshes, dev))
        elif scenario == "card":
            keep("card", _card(meshes, dev))
        else:
            raise ValueError(f"unknown scenario {scenario!r}")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def run_ranks(out_dir, scenarios, *, world=4, device="cpu", timeout_s=120.0,
              join_timeout_s=300.0):
    """Spawn ``world`` ranks of :func:`rank_main`; returns each rank's
    outputs and the seconds the ranks took."""
    from repro_torch.launch.ranks import spawn

    seconds = spawn(rank_main, world,
                    (world, str(out_dir), list(scenarios), str(device),
                     timeout_s), join_timeout_s=join_timeout_s)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)], seconds


# -- the stacked mesh ---------------------------------------------------------

def stacked_collectives(data, model, device="cpu"):
    """What ``ShardMesh(data, model)`` gives shard ``(d, m)`` for
    :func:`_collectives`' calls: ``{(d, m): {name: array}}``."""
    mesh = ShardMesh(data, model, device=device)
    b = {k: _t(v, device) for k, v in collective_blocks(data, model).items()}
    out = {(d, m): {} for d in range(data) for m in range(model)}
    groups = {"model": lambda d, m: [(d, j) for j in range(model)],
              "data": lambda d, m: [(i, m) for i in range(data)],
              "data+model": lambda d, m: [(i, j) for i in range(data)
                                          for j in range(model)]}
    for (d, m), res in out.items():
        for tag, members in groups.items():
            axes = tuple(tag.split("+"))
            shards = members(d, m)
            pos = shards.index((d, m))
            x = torch.stack([b["x"][s] for s in shards])
            res[f"psum/{tag}"] = mesh.psum(x, axes)
            res[f"all_gather/{tag}"] = mesh.all_gather(x, axes)
            res[f"all_gather_int/{tag}"] = mesh.all_gather(
                torch.stack([b["ix"][s] for s in shards]), axes)
            if tag == "model":
                sent = torch.stack([b["to_model"][s] for s in shards])
                mine = slice(pos, pos + 1)
                res["all_to_all/model"] = mesh.all_to_all(sent, "model")[mine]
                res["all_to_all_bf16/model"] = mesh.all_to_all(
                    sent.to(torch.bfloat16), "model")[mine].float()
            if tag == "data":
                sent = torch.stack([b["to_data"][s] for s in shards])
                res["all_to_all/data"] = mesh.all_to_all(
                    sent, "data")[pos:pos + 1]
        mine = (slice(d, d + 1), slice(m, m + 1))
        for axis in ("data", "model"):
            res[f"psum_axis/{axis}"] = mesh.psum_axis(b["blk"], axis)[mine]
            res[f"pmean_axis/{axis}"] = mesh.pmean_axis(b["blk"],
                                                        axis)[mine]
            for dim in (0, 1):
                res[f"all_gather_axis/{axis}/{dim}"] = mesh.all_gather_axis(
                    b["blk"], axis, dim)[mine]
    return {k: {n: v.cpu().numpy() for n, v in r.items()}
            for k, r in out.items()}


def stacked_tile(inputs, label, device="cpu"):
    g = tsyn.erdos_renyi(120, 4.0, seed=3, device=device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cfg = tile_config(inputs, **TILE_CASES[label])
    slabs = tde.build_sharded_graph(g, cfg, device=device)
    iv, ii = convert.sharded_index_from_arrays(
        inputs["index_values"], inputs["index_indices"], 4, device=device)
    v, i = tde.make_verd_tile_step(cfg, ShardMesh(1, 4, device=device))(
        slabs, _t(SOURCES, device), iv, ii)
    return v.cpu().numpy(), i.cpu().numpy()


def stacked_walk_counts(device="cpu"):
    g = build_graph(64, device)
    sources, rows = walk_inputs()
    cfg = tde.DistConfig(n=64, ep=2, q_tile=WALK_Q)
    fp, moves = tde.make_walk_counts_step(cfg, ShardMesh(2, 2, device=device))(
        g.row_ptr, g.col_idx, g.out_deg, _t(sources, device),
        _t(rows, device), rng.prng_key(7))
    return fp.cpu().numpy(), moves.cpu().numpy()


def stacked_sparse_walk_counts(shape, device="cpu"):
    g = build_graph(64, device)
    cfg = tde.DistConfig(n=64, ep=shape[1])
    got = tde.make_sparse_walk_counts_step(
        cfg, ShardMesh(*shape, device=device), r=32, l=12)(
        g.row_ptr, g.col_idx, g.out_deg,
        torch.arange(8, dtype=torch.int32, device=device), rng.prng_key(3))
    return [x.cpu().numpy() for x in got]


def stacked_build(label, device="cpu"):
    shape, n, kw = BUILD_CASES[label]
    index, stats = tindex.build_index_sharded(
        build_graph(n, device), key=rng.prng_key(3),
        mesh=ShardMesh(*shape, device=device), **kw)
    return index, stats
