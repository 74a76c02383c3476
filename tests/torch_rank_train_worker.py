"""The rank side of ``tests/test_torch_rank_train.py``: the reduced large
LMs (``launch.ranks.CASES``: the MoE dbrx and grok, the dense qwen and
command-r) one shard a process on a ``RankMesh`` in the reference's 2-D
layout (their forward, loss, decode, gradients and one train step), and
one train step of smollm-135m with its leaves whole and its rows over
data, each rank writing what it got to ``rank{r}.npz``, and the same
computations on the stacked ``ShardMesh`` for the tests to hold them
against.  Imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.distributed import RankMesh, ShardMesh
from repro_torch.launch import ranks
from repro_torch.tree import tree_leaves

CASES = ranks.CASES
SEED = 0
HOLDS = "qwen"          # the case whose init_fn blocks are recorded
# a small LM (``lm_is_small``): its leaves whole, its rows over data
SMALL = "smollm-135m"


def config(label):
    return ranks.case_config(label)


def meshes(label):
    """The mesh shapes the case runs on."""
    return ranks.case_meshes(label)


def run_case(label, mesh):
    """``launch.ranks.train_case`` of ``label`` on ``mesh``: everything the
    tests compare (a rank's blocks on a rank, the whole on a stacked
    mesh)."""
    return ranks.train_case(label, mesh, seed=SEED)[0]


def _digest_tensor(hexdigest: str) -> torch.Tensor:
    return torch.tensor(list(bytes.fromhex(hexdigest)), dtype=torch.uint8)


def train_once(mesh, label):
    """``launch.ranks.train_once`` of the case's arch, or of :data:`SMALL`
    (its smoke config under the published rules, through
    ``steps.build(mesh=)``): the metrics and the parameters' digest."""
    arch, moe_over, over = CASES.get(label, (label, None, {}))
    over = dict(over)
    if moe_over is not None:
        over["moe"] = config(label).moe
    metrics, params, _, _, specs = ranks.train_once(
        mesh, arch, reduced=True, seed=SEED, overrides=over or None)
    out = {k: torch.tensor(v) for k, v in metrics.items()
           if isinstance(v, float)}
    out["digest"] = _digest_tensor(ranks.params_digest(params, mesh, specs))
    return out


def holds(mesh, label=HOLDS):
    """What a rank holds after ``steps.build(mesh=)``'s ``init_fn``: each
    leaf's shape (``shape/<path>``) and the bytes of them all."""
    arch, _, over = CASES[label]
    bundle = ranks.train_bundle(mesh, arch, reduced=True, overrides=over)
    params = bundle.init_fn(SEED)
    out = {f"shape/{k}": torch.tensor(v.shape)
           for k, v in ranks.leaf_paths(params)}
    out["bytes"] = torch.tensor(sum(x.numel() * x.element_size()
                                    for x in tree_leaves(params)))
    return out


def as_numpy(results):
    """Floats as f32 arrays (bf16 and fp8 exactly), with each tensor's
    dtype beside it."""
    out = {}
    for k, v in results.items():
        v = v.detach().cpu()
        out[k] = v.float().numpy() if v.is_floating_point() else v.numpy()
        out[f"{k}@dtype"] = np.array(str(v.dtype))
    return out


def rank_main(rank, world, out_dir, device, timeout_s):
    """One rank: join the group through a ``file://`` store in
    ``out_dir``, run every case on every mesh and write
    ``rank{rank}.npz``."""
    from repro_torch.launch.mesh import make_rank_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    mesh_of = {(1, world): make_rank_mesh(
        1, world, backend="gloo", device=dev, timeout_s=timeout_s, rank=rank,
        world_size=world,
        init_method="file://" + os.path.join(out_dir, "store"))}
    mesh_of[(2, 2)] = RankMesh(2, 2, device=dev, timeout_s=timeout_s)
    out = {}
    for label in CASES:
        for shape in meshes(label):
            res = run_case(label, mesh_of[shape])
            for k, v in as_numpy(res).items():
                out[f"{label}/{shape[0]}x{shape[1]}/{k}"] = v
    for label in (*CASES, SMALL):
        for k, v in as_numpy(train_once(mesh_of[(2, 2)], label)).items():
            out[f"{label}/train_once/{k}"] = v
    for shape, mesh in mesh_of.items():
        for k, v in as_numpy(holds(mesh)).items():
            out[f"holds/{shape[0]}x{shape[1]}/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def run_ranks(out_dir, *, world=4, device="cpu", timeout_s=120.0,
              join_timeout_s=300.0):
    """Spawn ``world`` ranks of :func:`rank_main`; returns each rank's
    outputs and the seconds the ranks took."""
    from repro_torch.launch.ranks import spawn

    seconds = spawn(rank_main, world, (world, str(out_dir), str(device),
                                        timeout_s),
                    join_timeout_s=join_timeout_s)
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(world)], seconds


def stacked(label, shape, device="cpu"):
    """:func:`run_case` on the stacked ``ShardMesh`` of ``shape``, every
    output whole."""
    return as_numpy(run_case(label, ShardMesh(*shape, device=device)))


def stacked_train_once(label, shape=(2, 2), device="cpu"):
    """:func:`train_once` on the stacked ``ShardMesh``."""
    return as_numpy(train_once(ShardMesh(*shape, device=device), label))
