"""Findings report: text and JSON renderings of a rule run.

The text report is what ``python -m repro_torch.analysis`` prints; the
JSON form (``--json``) is stable enough for CI annotation (one object per
rule, findings carry repo-relative ``file:line`` anchors and the
suppression justification when present).  The keys are the reference's
(``repro.analysis.report``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence

from repro_torch.analysis.rules import RuleResult


def exit_code(results: Sequence[RuleResult]) -> int:
    """Nonzero iff any rule has an unsuppressed finding.  SKIPs do not fail
    the run (they are environment limits, e.g. ``retrace-guard`` on the
    CPU, where nothing is captured) but are always surfaced in the
    report."""
    return 1 if any(r.unsuppressed for r in results) else 0


def render_text(results: Sequence[RuleResult]) -> str:
    lines: List[str] = ["contract auditor — repro_torch.analysis", ""]
    for r in results:
        n_sup = sum(1 for f in r.findings if f.suppressed)
        head = f"[{r.status}] {r.rule} ({r.kind})"
        if r.audited:
            head += f" — {len(r.audited)} target(s)"
        if n_sup:
            head += f", {n_sup} suppressed"
        lines.append(head)
        for f in r.unsuppressed:
            lines.append(f"    FINDING {f.anchor()}: {f.message}")
        for f in r.findings:
            if f.suppressed:
                lines.append(
                    f"    allowed {f.anchor()}: {f.justification}"
                )
        for s in r.skipped:
            lines.append(f"    skipped {s}")
        for s in r.notes:
            lines.append(f"    note {s}")
    total = sum(len(r.unsuppressed) for r in results)
    lines.append("")
    lines.append(
        f"{total} unsuppressed finding(s) across {len(results)} rule(s)"
    )
    return "\n".join(lines)


def render_json(results: Sequence[RuleResult]) -> str:
    payload: List[Dict[str, Any]] = []
    for r in results:
        payload.append(dict(
            rule=r.rule,
            kind=r.kind,
            status=r.status,
            description=r.description,
            audited=list(r.audited),
            skipped=list(r.skipped),
            findings=[f.to_json() for f in r.findings],
        ))
    return json.dumps(
        dict(results=payload, exit_code=exit_code(results)), indent=2
    )
