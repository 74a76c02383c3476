#!/usr/bin/env python3
"""One LM train step on a rank mesh of cards, then the step's lookup
kernels timed at their own inputs.

Run under ``torchrun``, one rank a card, with ``repro_torch.launch.ranks``'
options::

    torchrun --standalone --nproc-per-node 4 tools/rank_train_card.py \\
        --data 2 --model 2 --train command-r-plus-104b --layers 2 --batch 8

Every rank runs what ``launch.ranks``' ``--train`` runs: rank 0 traces a
rank's step on meta and the ranks stop unless its predicted peak is
within ``launch.dryrun.PEAK_LIMIT`` (``ranks.gate_peak``); then the step,
and rank 0's JSON line (loss, ``grad_norm``, ``mu``'s dtype, seconds,
tokens/s, each rank's peak beside the prediction, the parameters'
digest; ``ranks.report_train``).  Rank 0 holds its first
``embedding_bag`` launch (its block of the vocabulary, the tokens outside
it masked) and its first ``embedding_bag_backward`` launch (the block's
gradient) on the host; after the step, its parameters and state freed,
it replays them through ``chip_smoke.replay_all``: each kernel bit-equal
to its plain version, its time beside the plain version's, its bound and
the library call's, one ``replay`` JSON line each.  Prints the card's
name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

LOOKUPS = ("embedding_bag", "embedding_bag_backward")


def smoke_module():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import ranks

    smoke = smoke_module()
    args = ranks.parser().parse_args()
    mesh = ranks.train_mesh(args)
    predicted = ranks.gate_peak(args, mesh)
    lead = not (mesh.local_data[0] or mesh.local_model[0])
    ops.capture_first_launches(lead)
    run = ranks.train_once(mesh, args.train, **ranks.train_cut(args))
    held = {f"{tag.split('/')[0]}/rank_block": (
        tuple(None if x is None else x.detach().cpu() for x in a), kw)
        for tag, (a, kw) in ops.captured_launches().items()
        if tag.split("/")[0] in LOOKUPS}
    ops.capture_first_launches(False)
    ranks.report_train(args, mesh, run, predicted)
    del run
    torch.cuda.empty_cache()
    failures = []
    if lead:
        results = {}
        smoke.replay_all(torch, {
            tag: (tuple(None if x is None else x.to(mesh.device)
                        for x in a), kw)
            for tag, (a, kw) in held.items()}, results, failures)
        print(smoke.card_name_and_power_limit())
        print(json.dumps(dict(replayed=sorted(results),
                              failures=failures)), flush=True)
    if not args.stacked:
        dist.barrier()
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
