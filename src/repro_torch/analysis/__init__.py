"""Contract auditor: static and traced checks that enforce the performance
and determinism invariants the port rests on (the counterpart of
``repro.analysis``).

Two engines under one rule registry:

* **trace auditor** (:mod:`repro_torch.analysis.trace`) — runs registered
  entry points on tiny synthetic graphs under a recording dispatch mode,
  and reads the kernels' sources and built libraries:
  ``hbm-residency``, ``no-replicated-index``, ``dense-state-bound``,
  ``retrace-guard``.
* **AST lint** (:mod:`repro_torch.analysis.lint`) — parses hot-path
  modules for contracts a recorded run can't see: ``host-sync``,
  ``rng-discipline``, ``bare-time``.

Run with ``python -m repro_torch.analysis [--device cpu]``; suppress an
intentional violation in source with
``# contract: allow(<rule>): <justification>``.  See the README's port
section for the rule catalog and how to register a new entry point.

This package root stays import-light (registry only): kernel modules
import :mod:`repro_torch.analysis.registry` at definition time to register
their entry points, and must not pay for (or cycle into) the rule
implementations, which import the kernels back.
"""

from repro_torch.analysis.registry import (    # noqa: F401
    EntryPoint,
    Finding,
    clear_entry_points,
    entry_points,
    register_entry_point,
)

__all__ = [
    "EntryPoint",
    "Finding",
    "clear_entry_points",
    "entry_points",
    "register_entry_point",
]
