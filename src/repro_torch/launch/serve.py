"""PPR serving launcher (the paper's online phase as a process).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--n-log2 11] [--r 100] [--t 2] [--queries 2000] \
        [--mode powerwalk|verd|fppr|mcfp|pi] [--device cuda|cpu]

Builds the index on the device (for the modes that read one: powerwalk
and fppr), starts the batched service, runs a closed-loop workload and
prints Table-3-style latency/throughput.  Graphs below 2**14 vertices, and
hub-heavy graphs at the default ``--hub-split-degree 0`` (the reference's
``QueryConfig`` default), serve on the dense route; ``--hub-split-degree
64`` routes rmat's hub-heavy graphs sparse.  ``--mode mcfp`` answers with
no index, from ``QueryConfig.r_online`` walks a query.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch import rng
from repro_torch.core.index import build_index
from repro_torch.core.query import QueryConfig
from repro_torch.graphs import synthetic
from repro_torch.serving import PPRService, ServiceConfig
from repro_torch.serving.batching import BatchingConfig


def build_parser() -> argparse.ArgumentParser:
    """The launcher's options; the defaults serve as the reference's
    launcher does (``QueryConfig``'s own ``hub_split_degree=0``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-log2", type=int, default=11)
    ap.add_argument("--r", type=int, default=100)
    ap.add_argument("--t", type=int, default=2)
    ap.add_argument("--mode", default="powerwalk",
                    choices=["powerwalk", "verd", "fppr", "mcfp", "pi"])
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--top-k", type=int, default=50)
    ap.add_argument("--hub-split-degree", type=int,
                    default=QueryConfig.hub_split_degree)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    g = synthetic.rmat(args.n_log2, avg_deg=10.0, seed=0, device=args.device)
    print(f"graph n={g.n} m={g.m}; building index R={args.r}")
    index = None
    if args.mode in ("powerwalk", "fppr"):
        index, stats = build_index(
            g, r=args.r, l=max(32, int(args.r / 0.15)), key=rng.prng_key(0),
            source_batch=512, device=args.device)
        print(f"index: {stats['nbytes'] >> 20} MiB "
              f"(dropped {stats['drop_fraction']:.3f})")
    svc = PPRService(
        g, index,
        ServiceConfig(
            query=QueryConfig(mode=args.mode, t_iterations=args.t,
                              top_k=args.top_k,
                              hub_split_degree=args.hub_split_degree),
            batching=BatchingConfig(max_batch=args.max_batch),
        ),
        device=args.device,
    )
    workload = np.random.default_rng(0).integers(0, g.n, size=args.queries)
    _, stats = svc.run_closed_loop(workload)
    print(f"mode={args.mode} route={stats['frontier_path']}: "
          f"{stats['served']:.0f} queries "
          f"{stats['wall_s']:.2f}s  {stats['qps']:.0f} q/s  "
          f"mean_latency {stats['mean_latency'] * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
