#!/usr/bin/env python3
"""``embedding_bag_backward`` at the five train cells' own inputs on one
CUDA GPU, for one source tree, with each cell's ms a step.

    python3 tools/embedding_bag_backward_bench.py [--tree DIR] [--cells A,B]
                                                  [--fill-check]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
copy of another commit unpacked under ``build/`` is timed by the same
script in the same call: parent, change, change, parent, one process each.
For each train cell (``chip_smoke.TRAIN_CELLS``: DLRM RM2, DCN-v2, SASRec
and MIND ``train_batch``, smollm-135m ``train_4k`` at B = 8) it runs
``chip_smoke.train_cell`` with that tree's modules: a warm-up step and 3
timed steps (CUDA events), the launch gates, and phase 2b's replay of the
warm-up step's last ``embedding_bag_backward`` launch through the tree's
wrapper: bit-equal to the plain version, a second launch the same bytes,
the kernel time a call (``torch.profiler``), the wrapper call back to back
(CUDA events), the plain version's and ``index_add_``'s times, a memset of
the gradient's bytes, the bound with the whole gradient written and with
the touched rows only.  Every cell's inputs come from the same seeds, so
both trees see the same ids and gradients.  ``--fill-check`` times the
tree's kernel alone (``torch.profiler``) at DLRM's train shape (1,703,936
slots into 26 x 10^6 rows of 64, a bf16 gradient from seed 0) for ids
all outside the table (the zero fill alone), uniform ids already in key
order (the gradient read in order) and uniform ids, beside a memset of
the gradient, in place of the cells.  Prints the card's name and power
limit and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fill_check(smoke, torch):
    """Kernel ms a call at DLRM's train shape for three id sets, and a
    memset of the gradient (CUDA events)."""
    from repro_torch.kernels import embedding_bag as bag_k

    slots, vocab, d = 1_703_936, 26_000_000, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn((slots, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    uniform = torch.randint(0, vocab, (slots, 1), generator=gen,
                            dtype=torch.int32, device="cuda")
    res = {}
    for name, ids in (
            ("no live id", torch.full_like(uniform, vocab + 5)),
            ("uniform, in key order", torch.sort(uniform, dim=0).values),
            ("uniform", uniform)):
        def launches():
            for _ in range(20):
                bag_k.embedding_bag_backward_cuda(
                    ids, None, g, vocab, row_dtype=torch.bfloat16)

        res[name] = sum(ms / n for _, ms, n in smoke.traced_kernels(
            torch, launches, "embedding_bag_backward"))
        print(f"{name}: kernel {res[name]:.4f} ms a call (torch.profiler)")
    out = torch.empty((vocab, d), device="cuda")
    res["memset"] = smoke.cuda_ms(torch, out.zero_, max_reps=20)
    print(f"memset of the [vocab, D] f32 gradient: {res['memset']:.4f} ms")
    return res


def main() -> int:
    smoke = smoke_module()
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--cells", default=",".join(smoke.TRAIN_CELLS))
    ap.add_argument("--fill-check", action="store_true")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("embedding_bag_backward_bench: needs a CUDA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tree {tree}")
    for line in build.build_log.get("embedding_bag_backward",
                                    "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    if opts.fill_check:
        res = fill_check(smoke, torch)
        print(smoke.card_name_and_power_limit())
        print(json.dumps({"tree": tree, "fill_check": res}))
        return 0
    failures = []
    cells = {}
    for arch in opts.cells.split(","):
        counts, replays, step_ms = smoke.train_cell(torch, np, "cuda", arch,
                                                    failures)
        cells[arch] = dict(step_ms=step_ms, launches=counts, replays=replays)
    print(smoke.card_name_and_power_limit())
    print(json.dumps({"tree": tree, "ok": not failures,
                      "failures": failures, "cells": cells}))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
