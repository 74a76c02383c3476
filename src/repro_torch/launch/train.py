"""Training launcher (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \
        --shape train_batch [--reduced | --full] [--steps 100] \
        [--ckpt-dir DIR] [--ckpt-every 50] [--simulate-failure STEP] \
        [--device cuda]

The restart loop around a train step: checkpoint every ``ckpt_every``
steps (async), watch step times (:class:`~repro_torch.distributed.
elastic.StepTimer`: a persistent straggler is snapshotted at once), and on
a failure restore the last committed checkpoint (``--simulate-failure``
demonstrates the path, printing the elastic plan a 448-device restart
would take).  The batch of step ``s`` comes from a generator seeded with
``10_000 + s``, so a resumed run replays the batches it lost and ends with
the same bytes as an uninterrupted one.  A run resumes from the latest
committed checkpoint under ``--ckpt-dir``.  ``--device`` defaults to
``cuda`` and raises without a GPU; ``--device cpu`` runs the plain
PyTorch path.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable

import torch

from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.distributed.elastic import StepTimer, plan_mesh
from repro_torch.launch import steps as steps_mod
from repro_torch.training import train_loop
from repro_torch.tree import tree_leaves


def run(bundle: steps_mod.StepBundle, *, steps: int, ckpt_dir: str,
        ckpt_every: int = 50, simulate_failure: int = 0,
        log: Callable[[str], None] = print):
    """Train ``bundle`` (a ``kind == "train"`` :class:`StepBundle`) up to
    step ``steps`` with checkpoints under ``ckpt_dir``, resuming from the
    latest one there.  Returns ``(params, opt_state, info)``; ``info``
    holds ``resumed_from``, ``restored_at_failure``, the last ``loss``,
    the step ``seconds``, their ``median`` (the watchdog's) and the
    checkpointer (``ckpt``)."""
    if bundle.kind != "train":
        raise ValueError(f"{bundle.arch_id}/{bundle.shape_name} is a "
                         "serving shape")
    params = bundle.init_fn(0)
    device = tree_leaves(params)[0].device
    opt_state = train_loop.init_state(
        bundle.opt_cfg or steps_mod.SMOKE_OPT, params)
    ckpt = Checkpointer(ckpt_dir)
    timer = StepTimer()
    info = dict(resumed_from=None, restored_at_failure=None, loss=None,
                seconds=[], ckpt=ckpt)

    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        (params, opt_state), extra = ckpt.restore(latest, (params, opt_state))
        start = extra.get("data_step", latest) + 1
        info["resumed_from"] = latest
        log(f"resumed from checkpoint step {latest}")

    step = start
    while step < steps:
        batch = bundle.make_batch(
            torch.Generator(device=device).manual_seed(10_000 + step))
        t0 = time.perf_counter()
        params, opt_state, metrics = bundle.step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step
        seconds = time.perf_counter() - t0
        info["seconds"].append(seconds)
        info["loss"] = loss
        advice = timer.record(seconds)
        if advice == "checkpoint":
            log(f"[watchdog] persistent straggler at step {step}: "
                f"snapshotting")
            ckpt.save(step, (params, opt_state),
                      extra=dict(data_step=step), blocking=True)
        if step % 10 == 0:
            log(f"step {step:5d} loss {loss:.4f}")
        if step % ckpt_every == ckpt_every - 1:
            ckpt.save(step, (params, opt_state),
                      extra=dict(data_step=step), blocking=False)
        if simulate_failure and step == simulate_failure:
            ckpt.wait()
            latest = ckpt.latest_step()
            log(f"[failure injected] restoring from step {latest}; "
                f"elastic plan for 448 devices: "
                f"{plan_mesh(448, prior_data_parallel=16)}")
            if latest is not None:
                (params, opt_state), extra = ckpt.restore(
                    latest, (params, opt_state))
                step = extra["data_step"]
                info["restored_at_failure"] = latest
            simulate_failure = 0  # only once
        step += 1
    ckpt.wait()
    info["median"] = timer.median
    return params, opt_state, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="step at which to simulate a crash + restore")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bundle = steps_mod.build(args.arch, args.shape, reduced=args.reduced,
                             device=args.device)
    if bundle.kind != "train":
        raise SystemExit(f"{args.arch}/{args.shape} is a serving shape")
    _, _, info = run(bundle, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     simulate_failure=args.simulate_failure)
    print(f"done at step {args.steps}; median step time "
          f"{info['median']:.3f}s")
    return info


if __name__ == "__main__":
    main()
