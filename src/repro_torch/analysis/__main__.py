"""Contract auditor CLI: ``python -m repro_torch.analysis [--only RULE]
[--json] [--list-rules] [--device cuda|cpu]``.

Exit code is nonzero on any unsuppressed finding.  ``--device`` defaults
to ``cuda`` and raises where there is no GPU, as every entry point of the
port does; ``--device cpu`` runs the traced rules on the plain PyTorch
versions, where ``retrace-guard`` has nothing captured to count and
``hbm-residency`` reads the kernels' sources only.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Run the performance/determinism contract auditor.",
    )
    parser.add_argument(
        "--only", action="append", metavar="RULE",
        help="run only this rule (repeatable); default: all rules",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit the JSON report"
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="list known rules and exit",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="device of the traced rules (default: cuda)",
    )
    args = parser.parse_args(argv)

    from repro_torch.analysis import report as report_mod
    from repro_torch.analysis import rules as rules_mod

    if args.list_rules:
        for name in rules_mod.RULES:
            print(name)
        return 0

    results = rules_mod.run_rules(only=args.only, device=args.device)
    if args.json:
        print(report_mod.render_json(results))
    else:
        print(report_mod.render_text(results))
    return report_mod.exit_code(results)


if __name__ == "__main__":
    sys.exit(main())
