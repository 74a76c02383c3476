#!/usr/bin/env python3
"""Phase split of the sparse ``index_combine`` on one CUDA GPU, at the
sparse main path's own inputs.

    python3 tools/combine_phases.py [--paths sort,hash] [--reps 10]

Builds ``chip_smoke.py``'s main-path graph and index (``rmat(20)``, r =
100, l = 256), serves one sparse batch of 256 requests to capture the
combine's inputs, and prints each row's candidate count w and distinct
positive columns d (max and mean).  Then, for each path of
``csrc/index_combine.cu`` ("sort": one block per row, candidates sorted in
global scratch; "hash": a row over several blocks, merged in shared-memory
tables), it launches a build of the same source with ``-DPW_PHASE_TIMERS``
(made here, beside the plain library; thread 0 of every block reads
``clock64`` after a barrier at the end of each phase) and prints the mean cycles a block spends in each phase, beside the
time of each of ``--reps`` launches of the plain build (CUDA events, one
launch each) and of the timer build.  Prints the card's name, power limit
and SM clock.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = {
    "sort": {0: "live count, s", 1: "gather", 2: "key sort",
             3: "group sums", 4: "compaction", 5: "select", 6: "write"},
    "hash": {8: "live slots", 9: "merge (gather, probe, sum)",
             10: "select (radix, sort, pass merge)"},
}


def smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timer_library(build):
    """``csrc/index_combine.cu`` built with ``-DPW_PHASE_TIMERS``, named
    after the plain library (whose name hashes the sources and flags)."""
    plain = build.library_path("index_combine_sparse")
    path = plain.with_name(plain.stem + "-timers.so")
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-DPW_PHASE_TIMERS", "-o",
             str(tmp), str(build.CSRC / build.SOURCES["index_combine_sparse"])],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc (timers) failed:\n{out.stderr}")
        regs = [ln.strip() for ln in out.stderr.splitlines()
                if "registers" in ln]
        print(f"nvcc index_combine_sparse (timers): {' | '.join(regs)}")
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default="sort,hash")
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("combine_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import rng
    from repro_torch.core.index import build_index
    from repro_torch.core.query import BatchQueryEngine, QueryConfig
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import index_combine as comb_k

    smoke = smoke_module()
    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card:", smi, flush=True)
    t0 = time.perf_counter()
    build.build()
    for name, log in sorted(build.build_log.items()):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"nvcc {name}: {' | '.join(regs)}")
    libs = {"plain build": build.load("index_combine_sparse"),
            "timer build": timer_library(build)}
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    g = synthetic.rmat(smoke.MAIN_N_LOG2, avg_deg=10.0, seed=0, device=dev)
    index, _ = build_index(g, r=smoke.MAIN_R, l=smoke.MAIN_L,
                           key=rng.prng_key(0),
                           source_batch=smoke.MAIN_SOURCE_BATCH, device=dev)
    eng = BatchQueryEngine(g, index, QueryConfig(
        t_iterations=2, top_k=50, hub_split_degree=64), device=dev)
    work = np.random.default_rng(1).integers(0, g.n, 256).astype(np.int32)
    ops.capture_first_launches(True)
    eng.query_topk(torch.from_numpy(work).to(dev))
    args, kwargs = ops.captured_launches()["index_combine_sparse/main"]
    ops.capture_first_launches(False)
    torch.cuda.synchronize()
    print("inputs:", json.dumps({k: list(v.shape) for k, v in zip(
        ("sv", "si", "fv", "fi", "vals", "idx"), args)}), kwargs)
    print("counts:", json.dumps(smoke.combine_counts(torch, args)))
    want = comb_k.index_combine_sparse_plain(*args, **kwargs)

    s_w, k, l = args[0].shape[1], args[2].shape[1], args[4].shape[1]
    for path in a.paths.split(","):
        k_out = kwargs["k_out"]
        plan = comb_k.combine_plan(s_w, k, l, k_out, path=path)
        print(f"-- {path}: {plan}")
        if plan.path == "hash":
            parts = comb_k.row_parts(plan, s_w, (args[2] > 0).sum(dim=1), l)
            print(f"  blocks that work (the rows' parts): {int(parts.sum())} "
                  f"of {plan.parts * args[2].shape[0]} launched")
        results = {}
        for label, lib in libs.items():
            run = lambda: comb_k.launch_sparse(lib, plan, *args, k_out)
            got = run()
            torch.cuda.synchronize()
            agree = float((got[1] == want[1]).float().mean())
            rel = float(((torch.sort(got[0], 1).values
                          - torch.sort(want[0], 1).values).abs()
                         / torch.sort(want[0], 1).values.clamp_min(1e-30))
                        .max())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(a.reps):
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            results[label] = times
            print(f"  {label}: index agreement {agree:.4f}, max value rel "
                  f"diff {rel:.2e}; ms per launch: "
                  + ", ".join(f"{x:.3f}" for x in times))
        lib = libs["timer build"]
        host = (ctypes.c_ulonglong * 18)()
        build.check_launch(lib.pw_phase_timers_reset(), "timers")
        comb_k.launch_sparse(lib, plan, *args, k_out)
        torch.cuda.synchronize()
        build.check_launch(lib.pw_phase_timers_read(host), "timers")
        blocks = host[16] if path == "sort" else host[17]
        units = host[7] if path == "sort" else host[15]
        total = sum(host[i] for i in PHASES[path])
        print(f"  phase split, one launch, {blocks} blocks walking {units} "
              f"{'live slots' if path == 'sort' else 'units'} (mean cycles "
              f"a block; share of the block's total; cycles a unit):")
        for i, name in PHASES[path].items():
            mean = host[i] / max(blocks, 1)
            print(f"    {name:34s} {mean:14.0f}  "
                  f"{100.0 * host[i] / max(total, 1):5.1f}%  "
                  f"{host[i] / max(units, 1):10.1f}")
        print(f"    {'total':34s} {total / max(blocks, 1):14.0f}")
    print("card:", smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
