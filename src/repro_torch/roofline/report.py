"""Roofline report: ``results/dryrun/*.json`` -> markdown tables.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir results/dryrun]

The counterpart of ``repro.roofline.report``: the summary, the dry-run
table and a roofline table per mesh.  The model cells run on one card
(``mesh_tag`` ``card``; the port has no sharding policy for them yet), so
their table is headed by the card the records were set against; the PPR
engine cells run on the ``pod`` (16 x 16) and ``multipod`` (32 x 16)
meshes, stacked on the meta device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

MESH_TAGS = ("card", "pod", "multipod")


def load(dir_: str) -> List[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if "mesh_tag" not in r:
            stem = os.path.basename(f)[:-len(".json")]
            r["mesh_tag"] = stem.rsplit("__", 1)[-1]
        out.append(r)
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if x >= scale:
            return f"{x / scale:.2f}{unit}"
    return f"{x:.1e}s"


def hardware_label(recs: List[dict]) -> Optional[str]:
    for r in recs:
        hw = r.get("hardware")
        if hw:
            return f"{hw['name']}, {hw['power_limit_w']:.0f} W"
    return None


def roofline_table(recs: List[dict], mesh_tag: str) -> str:
    rows = [
        "| arch | shape | dominant | compute | memory | collective | "
        "useful-FLOPs | HBM GB | fits |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok") or r["mesh_tag"] != mesh_tag:
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | **{rf['dominant']}** | "
            f"{fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} | "
            f"{fmt_s(rf['collective_s'])} | "
            f"{rf['useful_flops_ratio']:.3f} | "
            f"{r['hbm_used'] / 1e9:.1f} | "
            f"{'yes' if r['hbm_fits'] else 'no*'} |"
        )
    return "\n".join(rows)


def dryrun_table(recs: List[dict]) -> str:
    rows = [
        "| arch | shape | card trace | pod trace | multipod trace | "
        "per-dev FLOPs | per-dev HBM bytes | collective bytes |",
        "|---|---|---|---|---|---|---|---|",
    ]
    by_key: Dict[tuple, dict] = {}
    for r in recs:
        if r.get("ok"):
            by_key[(r["arch"], r["shape"], r["mesh_tag"])] = r
    seen = []
    for (arch, shape, _), r in by_key.items():
        if (arch, shape) in seen:
            continue
        seen.append((arch, shape))
        per = [by_key.get((arch, shape, t)) for t in MESH_TAGS]
        rf = next(p for p in per if p)["roofline"]
        cols = " | ".join(f"ok {p['seconds']}s" if p else "-" for p in per)
        rows.append(
            f"| {arch} | {shape} | {cols} | "
            f"{rf['flops']:.2e} | {rf['hbm_bytes']:.2e} | "
            f"{rf['collective_bytes']:.2e} |"
        )
    return "\n".join(rows)


def summary(recs: List[dict]) -> dict:
    ok = [r for r in recs if r.get("ok")]
    fails = [r for r in recs if not r.get("ok")]
    doms: Dict[str, int] = {}
    for r in ok:
        doms[r["roofline"]["dominant"]] = doms.get(
            r["roofline"]["dominant"], 0) + 1
    return dict(total=len(recs), ok=len(ok), failed=len(fails),
                dominant_counts=doms)


def render(recs: List[dict]) -> str:
    card = hardware_label(recs) or "one card"
    parts = [
        "## Summary\n", json.dumps(summary(recs), indent=1),
        "\n## Dry-run table\n", dryrun_table(recs),
        f"\n## Roofline (model cells on one card: {card}; no sharding "
        "policy yet)\n", roofline_table(recs, "card"),
        "\n## Roofline (single pod, 16x16)\n", roofline_table(recs, "pod"),
        "\n## Roofline (multi-pod, 32x16: the pod axis folded into data)\n",
        roofline_table(recs, "multipod"),
    ]
    return "\n".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    print(render(load(args.dir)))


if __name__ == "__main__":
    main()
