#!/usr/bin/env python3
"""``embedding_bag`` at DLRM RM2's three serving shapes on one CUDA GPU,
for one source tree.

    python3 tools/embedding_bag_bench.py [--tree DIR] [--mask none|ones]
                                         [--forwards]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
copy of another commit unpacked under ``build/`` is timed by the same
script in the same call: parent, change, change, parent, one process each.
Builds that tree's ``csrc/embedding_bag.cu`` only, the full-width table
(26 x 10^6 rows of 64 f32, ``N(0, 1/64)`` from seed 0, 6.66 GB) and the
lookup ids of ``serve_p99`` (512 x 26 one-slot bags), ``serve_bulk``
(262,144 x 26) and ``retrieval_cand`` (10^6 candidates x 26, fields 1-25
the user's), made as the model's ``lookup`` makes them, bf16 rows to bf16
out.  For each shape: the kernel against the plain version (bit-equal, NaN
rows aside) and a second launch (the same bytes); the kernel time a launch
from ``torch.profiler`` over launches back to back (50 at ``serve_p99``,
20 at the others), and from CUDA events over as many; a memset of the output's bytes (``Tensor.zero_``, CUDA
events), the card's store rate on them; the byte bound
(``chip_smoke.bytes_and_ops``: 4 B a slot of ids, 4 B more with a mask,
each distinct row once, the output once, at 3.35 TB/s) and the share of
it.  ``--mask none`` launches with no mask (a
tree whose wrapper takes ``None``), ``--mask ones`` with the all-ones mask
an earlier ``lookup`` passed.  ``--forwards`` adds the full forward of
``serve_bulk`` (8 timed) and ``retrieval_cand`` (4 timed) through the
tree's ``steps.build`` (CUDA events, one forward in flight).  Prints the
card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {"serve_p99": (512, None), "serve_bulk": (262144, None),
          "retrieval_cand": (1, 10 ** 6)}


def smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_entries(log):
    """``(kernel, registers, spill store bytes)`` of each kernel in nvcc's
    ``-Xptxas -v`` output, the kernel by its mangled template arguments
    (``one_hotILi4ELi16ELb1E13__nv_bfloat16ELb0E``: vec 4, 16 lanes a row,
    bf16 rows, bf16 out, no mask)."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'")[0]
        short = name.split("embedding_bag_")[-1].split("EEv")[0]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out.append((short, int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else 0))
    return out


def lookup_ids(torch, gen, b, candidates, fields=26, vocab=10 ** 6):
    """``[B * fields, 1]`` int32 ids as ``lookup`` flattens them (field
    offsets added); with ``candidates``, one user's row repeated per
    candidate and field 0 the candidate, as ``retrieval_scores`` does."""
    ids = torch.randint(0, vocab, (b, fields), generator=gen,
                        dtype=torch.int32, device="cuda")
    if candidates:
        ids = ids.expand(candidates, fields).clone()
        ids[:, 0] = torch.randint(0, vocab, (candidates,), generator=gen,
                                  dtype=torch.int32, device="cuda")
    offsets = torch.arange(fields, dtype=torch.int32, device="cuda") * vocab
    return (ids + offsets).reshape(-1, 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--mask", choices=("none", "ones"), default="none")
    ap.add_argument("--forwards", action="store_true")
    opts = ap.parse_args()
    smoke = smoke_module()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    if not torch.cuda.is_available():
        print("embedding_bag_bench: needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_bag as bag_k

    build.build(["embedding_bag"])
    print(f"tree {tree}, mask {opts.mask}")
    for kernel, regs, spill in ptxas_entries(
            build.build_log.get("embedding_bag", "")):
        print(f"  ptxas {kernel}: {regs} registers, {spill} B spill stores")
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((26 * 10 ** 6, 64), generator=gen,
                        dtype=torch.float32, device="cuda").mul_(64 ** -0.5)
    kw = dict(row_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    ok = True
    results = {}
    for name, (b, cand) in SHAPES.items():
        ids = lookup_ids(torch, gen, b, cand)
        mask = (None if opts.mask == "none" else
                torch.ones(ids.shape, dtype=torch.float32, device="cuda"))
        args = (ids, mask, table)
        a = bag_k.embedding_bag_cuda(*args, **kw)
        again = bag_k.embedding_bag_cuda(*args, **kw)
        plain = bag_k.embedding_bag_plain(ids, None, table, **kw) if (
            mask is None) else bag_k.embedding_bag_plain(*args, **kw)
        torch.cuda.synchronize()
        equal = smoke.same_bits_or_nan(torch, a, plain)
        same = smoke.bits_equal(torch, a.view(torch.int16),
                                again.view(torch.int16))
        ok &= equal and same
        del a, again, plain
        reps = 50 if b * (cand or 1) < 10 ** 5 else 20
        ev_ms = smoke.cuda_ms(torch, lambda: bag_k.embedding_bag_cuda(
            *args, **kw), budget_ms=1e9, max_reps=reps)
        def launches():  # each output freed before the next launch
            for _ in range(reps):
                bag_k.embedding_bag_cuda(*args, **kw)

        for _ in range(3):
            prof_ms, traced = smoke.traced_launch_ms(torch, launches,
                                                     "embedding_bag")
            if traced:
                break
        # the card's store rate on the same output bytes: a memset
        sink = torch.empty((ids.shape[0], table.shape[1]),
                           dtype=kw["out_dtype"], device="cuda")
        fill_ms = smoke.cuda_ms(torch, sink.zero_, max_reps=reps)
        del sink
        nbytes, _ = smoke.bytes_and_ops(torch, "embedding_bag", args, kw)
        bound = nbytes / smoke.HBM_BYTES_PER_S * 1e3
        kernel_ms = prof_ms or ev_ms
        results[name] = dict(
            rows=ids.shape[0], bit_equal=equal, same_bytes_twice=same,
            profiler_ms=prof_ms, traced=traced, launches=reps,
            events_ms=ev_ms, fill_ms=fill_ms,
            bound_ms=bound,
            bytes=nbytes, share_of_bound=bound / kernel_ms)
        print(f"{name}: {ids.shape[0]} bags; bit-equal {equal}, same bytes "
              f"twice {same}; kernel a launch "
              + (f"{prof_ms:.5f} ms (torch.profiler, {traced} of {reps} "
                 f"launches traced)" if prof_ms else "not traced")
              + f", {ev_ms:.5f} ms (CUDA events, {reps} launches back to "
              f"back); a memset of the output {fill_ms:.5f} ms; bound "
              f"{bound:.5f} ms ({nbytes} B), "
              f"{100 * bound / kernel_ms:.1f}% of it", flush=True)
        del ids, mask, args
    del table
    torch.cuda.empty_cache()
    if opts.forwards:
        from repro_torch.launch import steps

        params = None
        for name, warm, reps in (("serve_bulk", 1, 8),
                                 ("retrieval_cand", 1, 4)):
            bundle = steps.build("dlrm-rm2", name, device="cuda")
            if params is None:
                params = bundle.init_fn(0)
            batch = bundle.make_batch(gen)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ms = []
            for j in range(warm + reps):
                ev0.record()
                out = bundle.step_fn(params, batch)
                ev1.record()
                ev1.synchronize()
                if j >= warm:
                    ms.append(ev0.elapsed_time(ev1))
            ok &= bool(torch.isfinite(out).all())
            ms.sort()
            results[f"forward/{name}"] = dict(ms=ms)
            print(f"forward {name}: {reps} forwards, ms min {ms[0]:.4f} "
                  f"median {ms[len(ms) // 2]:.4f} max {ms[-1]:.4f}",
                  flush=True)
            del batch, out
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"tree": tree, "mask": opts.mask, "ok": ok,
                      "shapes": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
