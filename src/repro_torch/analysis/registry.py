"""Entry-point registry for the contract auditor.

This module is deliberately dependency-light (stdlib only): kernel and
core modules import it at definition time to register the entry points
the traced rules audit, and pulling in torch here would make every kernel
import pay for the analyzer.  The heavy work lives in the ``build``
thunks, which run only when a rule executes.

An :class:`EntryPoint` names *one program* a rule audits — e.g. "the
frontier_push kernel on a tiny synthetic graph".  ``build()`` returns a
rule-specific spec dict (see ``analysis/rules.py`` for the schema each
rule expects) or ``{"skip": reason}`` when the check cannot run in this
process (e.g. ``retrace-guard`` on the CPU, where nothing is captured).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation (or suppressed would-be violation)."""

    rule: str
    file: str            # repo-relative path anchor
    line: int            # 1-based; 0 = whole-file / traced-program finding
    message: str
    suppressed: bool = False
    justification: Optional[str] = None

    def anchor(self) -> str:
        return f"{self.file}:{self.line}" if self.line else self.file

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    """A program registered for auditing under one traced rule."""

    name: str      # unique within the rule, e.g. "frontier-push"
    rule: str      # rule id, e.g. "hbm-residency"
    module: str    # repo-relative anchor file for findings
    # lazy spec builder build(device) (may return {"skip": ...})
    build: Callable[..., Dict[str, Any]]


_ENTRY_POINTS: List[EntryPoint] = []


def register_entry_point(
    name: str,
    rule: str,
    module: str,
    build: Callable[..., Dict[str, Any]],
) -> EntryPoint:
    """Register an entry point; idempotent per (rule, name) so module
    reloads (pytest importmode quirks) don't double-register."""
    ep = EntryPoint(name=name, rule=rule, module=module, build=build)
    for i, existing in enumerate(_ENTRY_POINTS):
        if existing.rule == rule and existing.name == name:
            _ENTRY_POINTS[i] = ep
            return ep
    _ENTRY_POINTS.append(ep)
    return ep


def entry_points(rule: Optional[str] = None) -> List[EntryPoint]:
    if rule is None:
        return list(_ENTRY_POINTS)
    return [ep for ep in _ENTRY_POINTS if ep.rule == rule]


def clear_entry_points() -> None:
    """Test hook: reset the registry (fixtures register throwaway entries)."""
    _ENTRY_POINTS.clear()
