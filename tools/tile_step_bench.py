#!/usr/bin/env python3
"""The distributed engine's sparse tile step as ``chip_smoke.py`` phase 3f
runs it, or its dense-exchange oracle, on one CUDA GPU, for one source
tree.

    python3 tools/tile_step_bench.py [--tree DIR] [--passes 3]
        [--exchange sparse|dense] [--requests N]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
copy of another commit unpacked under ``build/`` is timed by the same
script in the same call: parent, change, change, parent, one process each.
Builds that tree's kernels, ``rmat(20, avg_deg=10, seed=0)``, its index
(r = 100, l = 256, source batch 4,096, key 0) and 3f's configuration
(4 stacked model shards, tiles of 256, t = 2, top 50, ``hub_split_degree``
64), then answers the first ``--requests`` of 3c's 16,384 requests in
tiles of 256 ``--passes`` times.  ``--exchange dense`` runs the dense
oracle instead.  Prints the card's name and power limit, the ms a tile
of each pass (host clock ending in a synchronize), the peak device
memory the tiles allocated above what the graph and the index hold, and
whether every pass gave the same bytes as the first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    p.add_argument("--passes", type=int, default=3)
    p.add_argument("--exchange", choices=("sparse", "dense"),
                   default="sparse")
    p.add_argument("--requests", type=int, default=16384)
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))

    import numpy as np
    import torch

    from repro_torch import rng
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, make_verd_tile_step)
    from repro_torch.core.index import build_index
    from repro_torch.distributed import ShardMesh
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("tile_step_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0], flush=True)
    build.build()
    dev = "cuda"
    g = synthetic.rmat(20, avg_deg=10.0, seed=0, device=dev)
    index, _ = build_index(g, r=100, l=256, key=rng.prng_key(0),
                           source_batch=4096, device=dev)
    cfg = DistConfig(n=g.n, ep=4, q_tile=256, t_iterations=2, index_l=256,
                     top_k=50, degree_cap=int(g.out_deg.max()),
                     hub_split_degree=64, exchange=args.exchange)
    slabs = build_sharded_graph(g, cfg, device=dev)
    step = make_verd_tile_step(cfg, ShardMesh(1, 4, device=dev))
    work = torch.as_tensor(np.random.default_rng(1).integers(
        0, g.n, 16384)[:args.requests], dtype=torch.int32, device=dev)
    shape = (4, g.n // 4, 256)
    iv, ii = index.values.reshape(shape), index.indices.reshape(shape)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms, answers = [], []
    for _ in range(args.passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiles = [step(slabs, work[j:j + 256], iv, ii)
                 for j in range(0, work.shape[0], 256)]
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / len(tiles))
        answers.append(torch.cat([torch.cat([v.view(torch.int32), i], 1)
                                  for v, i in tiles]))
    print(json.dumps(dict(
        tree=args.tree, exchange=args.exchange,
        ms_a_tile=[round(x, 3) for x in ms],
        peak_gb_above_inputs=(torch.cuda.max_memory_allocated() - held)
        / 1e9,
        passes_same_bytes=all(torch.equal(answers[0], a)
                              for a in answers[1:]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
