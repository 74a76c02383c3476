"""Fault injection for the crash-safe index build.

A :class:`FaultPlan` is handed to ``build_index(...)`` /
``build_index_sharded(...)`` (the ``fault_plan=`` testing seam) and fires
at the two places a preempted build actually dies:

* **chunk boundaries**: ``chunk_boundary(i)`` is called right before the
  build processes source chunk ``i``; a configured chunk raises
  :class:`InjectedFault` (a clean Python crash: committed checkpoints
  stay, in-memory progress is lost) or SIGKILLs the process outright (no
  ``finally`` blocks, no atexit: preemption);
* **mid-checkpoint-write**: ``pre_commit(step)`` runs inside
  ``Checkpointer.save`` after the step's files are fully written but
  *before* the atomic rename, so a configured step dies leaving exactly
  the ``.tmp`` dir the restore contract must ignore.

Plans are stateless and fire every time a configured point is reached; a
resumed run that must get *past* a fault point is given a fresh plan.
The counterpart of ``repro.testing.faults``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Tuple


class InjectedFault(RuntimeError):
    """Deterministic crash raised by a :class:`FaultPlan`."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Where a build run should die.  All fields are global chunk indices
    (or checkpoint step numbers, which the build keeps equal to the count
    of committed chunks)."""

    raise_at_chunks: Tuple[int, ...] = ()     # InjectedFault before chunk i
    raise_mid_commit: Tuple[int, ...] = ()    # InjectedFault pre-rename of
                                              # checkpoint step s
    kill_at_chunks: Tuple[int, ...] = ()      # SIGKILL before chunk i
    kill_mid_commit: Tuple[int, ...] = ()     # SIGKILL pre-rename of step s

    def chunk_boundary(self, chunk: int) -> None:
        """Called by the build immediately before processing ``chunk``."""
        if chunk in self.kill_at_chunks:
            os.kill(os.getpid(), signal.SIGKILL)
        if chunk in self.raise_at_chunks:
            raise InjectedFault(f"injected fault before chunk {chunk}")

    def pre_commit(self, step: int) -> None:
        """Called by the checkpointer between write-out and atomic rename."""
        if step in self.kill_mid_commit:
            os.kill(os.getpid(), signal.SIGKILL)
        if step in self.raise_mid_commit:
            raise InjectedFault(
                f"injected fault mid-commit of checkpoint step {step}")
