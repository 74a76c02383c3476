"""The contract-rule catalog: what the auditor checks and where.

Traced rules run over *registered entry points* — kernel and core modules
call :func:`repro_torch.analysis.registry.register_entry_point` at import
time with a lazy spec builder ``build(device)``, and importing the modules
in ``_HOOK_MODULES`` below is what populates the registry.  Lint rules run
over explicit module scope lists (the "hot-path allowlist" &c.), resolved
relative to ``src/repro_torch``.  The rule ids and scopes are the
reference's (``repro.analysis.rules``); ``kind`` is ``"trace"`` where the
reference reads a jaxpr.

Spec schemas returned by entry-point ``build(device)`` thunks (any builder
may instead return ``{"skip": reason}``):

    hbm-residency        {"kernel", "fn", "args", "operands", "hbm_shapes",
                          "dynamic_smem"}
    no-replicated-index  {"records", "outputs", "n", "l", "shards"}
    dense-state-bound    {"records", "budget", "floor"}
    retrace-guard        {"cache", "widths", "variants", "call",
                          "captures"?}

``hbm-residency`` is restated for the card: the CSR and the ``[n, L]``
index reach each kernel as the caller's global memory and are only
gathered from; no block's shared memory grows with ``n``, ``nnz`` or
``n * L``; each block's shared memory stays within the card's opt-in
limit.  On any device it reads each kernel's sources
(:func:`~repro_torch.analysis.trace.shared_memory_findings`).  On the card
it also reads each kernel's static shared bytes from the built library,
adds the planners' dynamic bytes (``dynamic_smem(lib, args, kwargs)``) at
the main path's shapes on rmat(12) and on the main graph (rmat(20)),
requires the sums to be equal and within the opt-in limit, and requires
every launch's operands to be the owners' own storage.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import lint
from repro_torch.analysis import trace as tr
from repro_torch.analysis.registry import EntryPoint, Finding, entry_points
from repro_torch.device import resolve_device

# Importing these modules registers the entry points the traced rules
# audit (each module's registration block sits at its bottom).
_HOOK_MODULES = (
    "repro_torch.kernels.frontier_push",
    "repro_torch.kernels.index_combine",
    "repro_torch.kernels.walk_step",
    "repro_torch.core.index",
    "repro_torch.core.query",
    "repro_torch.core.distributed_engine",
)

_SRC = Path(__file__).resolve().parents[1]   # .../src/repro_torch
_ROOT = _SRC.parents[1]                      # the repository

# Hot-path allowlist for the host-sync rule: dispatch and harvest code
# where one stray sync serializes the whole pipeline.  core/capture.py
# holds the capture-and-replay half of the reference's core/query.py
# dispatch.
HOST_SYNC_SCOPE = (
    "serving/pipeline.py",
    "serving/engine.py",
    "core/query.py",
    "core/verd.py",
    "core/walks.py",
    "core/capture.py",
)

# Build/repair code where RNG keys must stay positional for bitwise
# resume and bitwise repair.
RNG_SCOPE = (
    "core/index.py",
    "core/walks.py",
    "core/updates.py",
    "core/distributed_engine.py",
    "distributed/checkpoint.py",
)

# Modules allowed to read wall clocks / global randomness: the load
# generator exists to model wall-clock arrival processes.
BARE_TIME_EXEMPT = ("serving/loadgen.py",)

# hbm-residency on the card: the main path's shapes (the served sparse
# route of QueryConfig(t_iterations=2, top_k=50, hub_split_degree=64) at
# batches of 256, its build chunks, and the tile step on 4 model shards)
# on rmat(12) and on the main graph, rmat(20) unless the caller gives one
AUDIT_N_LOG2 = (12, 20)
MAIN_BATCH = 256
MAIN_EP = 4
MAIN_L = 256
INDEX_R = 4                  # walks a source of the audit's own indexes

# where kernels/build.py's SOURCES lie
_CSRC = _SRC / "kernels" / "csrc"

MainGraph = Tuple[object, object]   # (Graph, PPRIndex) on the device


def load_entry_points() -> None:
    for mod in _HOOK_MODULES:
        importlib.import_module(mod)


@dataclasses.dataclass
class RuleResult:
    rule: str
    kind: str                     # "trace" | "lint"
    description: str
    findings: List[Finding]
    skipped: List[str] = dataclasses.field(default_factory=list)
    audited: List[str] = dataclasses.field(default_factory=list)
    # what a rule measured beside its findings (the text report prints it)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def status(self) -> str:
        if self.unsuppressed:
            return "FAIL"
        if not self.audited and self.skipped:
            return "SKIP"
        return "PASS"


# -- traced rules -------------------------------------------------------------

def _launches_of(kernel: str, fn: Callable[[], object]):
    """Run ``fn`` with the launch counts reset and the kernels' launch
    arguments recorded: ``(fn's result, [(args, kwargs) of each recorded
    variant of kernel's launches])``."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    ops.capture_first_launches(True)
    try:
        out = fn()
        torch.cuda.synchronize()
        captured = ops.captured_launches()
    finally:
        ops.capture_first_launches(False)
    return out, [v for tag, v in sorted(captured.items())
                 if tag.split("/")[0] == kernel]


def _drive_sparse_serve(graph, index, device):
    """The served sparse route's eager query (``frontier_push``,
    ``index_combine_sparse``) on a batch of the main path's width."""
    from repro_torch.core.query import BatchQueryEngine, QueryConfig

    eng = BatchQueryEngine(graph, index, QueryConfig(
        t_iterations=2, top_k=50, hub_split_degree=64,
        frontier_path="sparse", combine_path="sparse"), device=device)
    src = torch.arange(MAIN_BATCH, dtype=torch.int32, device=eng.device)
    eng.query_topk(src % graph.n)
    return {"col_idx": eng.graph.col_idx, "vals": eng.index.values,
            "idx": eng.index.indices}


def _drive_build_chunk(graph, index, device):
    """One chunk of the sparse build (``walk_step``)."""
    from repro_torch import rng
    from repro_torch.core.index import sparse_chunk_estimates

    chunk = torch.arange(MAIN_BATCH, dtype=torch.int32, device=graph.device)
    sparse_chunk_estimates(graph, chunk, rng.prng_key(0), r=INDEX_R,
                           l=index.l, sketch_l=2 * index.l)
    return {"col_idx": graph.col_idx}


def _drive_tile_step(graph, index, device):
    """The distributed sparse-exchange tile step on ``MAIN_EP`` stacked
    model shards (``sharded_frontier_push``); its recorded launches are
    shard 0's."""
    from repro_torch.core.distributed_engine import (
        DistConfig, build_sharded_graph, make_verd_tile_step)
    from repro_torch.distributed import ShardMesh

    cfg = DistConfig(n=graph.n, ep=MAIN_EP, q_tile=MAIN_BATCH,
                     t_iterations=2, index_l=index.l, top_k=50,
                     degree_cap=int(graph.out_deg.max()),
                     hub_split_degree=64)
    slabs = build_sharded_graph(graph, cfg, device=device)
    step = make_verd_tile_step(cfg, ShardMesh(1, MAIN_EP, device=device))
    shape = (MAIN_EP, graph.n // MAIN_EP, index.l)
    src = torch.arange(MAIN_BATCH, dtype=torch.int32, device=graph.device)
    step(slabs, src % graph.n, index.values.reshape(shape),
         index.indices.reshape(shape))
    return {"col_idx": slabs.col_idx[0]}


MAIN_PATH_DRIVES = {
    "walk_step": _drive_build_chunk,
    "frontier_push": _drive_sparse_serve,
    "index_combine_sparse": _drive_sparse_serve,
    "sharded_frontier_push": _drive_tile_step,
}


def _audit_graphs(device, main_graph: Optional[MainGraph]):
    """``[(label, graph, index)]``: rmat(12) and the main graph (built at
    rmat(20) when not given), indexes of the main graph's ``L``."""
    from repro_torch import rng
    from repro_torch.core.index import build_index
    from repro_torch.graphs import synthetic

    out = []
    l = MAIN_L if main_graph is None else main_graph[1].l
    for n_log2 in AUDIT_N_LOG2:
        if main_graph is not None and n_log2 == AUDIT_N_LOG2[-1]:
            g, index = main_graph
        else:
            g = synthetic.rmat(n_log2, avg_deg=10.0, seed=0, device=device)
            index, _ = build_index(g, r=INDEX_R, l=l, key=rng.prng_key(0),
                                   source_batch=4096, device=device)
        out.append((f"n={g.n}", g, index))
    return out


def _optin_bytes(device) -> Optional[int]:
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", None)


def _hbm_on_card(ep: EntryPoint, spec: dict, graphs, device,
                 notes: List[str]) -> List[Finding]:
    from repro_torch.kernels import build

    anchor = ep.module
    kernel = spec["kernel"]
    out: List[Finding] = []

    def finding(message: str) -> None:
        out.append(Finding(rule="hbm-residency", file=anchor, line=0,
                           message=f"{ep.name}: {message}"))

    lib = build.load(kernel)
    static = tr.static_smem_bytes(build.library_path(kernel))
    optin = _optin_bytes(device)
    if not static:
        finding(f"no kernel found in {build.library_path(kernel).name}")
    if optin is None:
        finding("this torch reports no shared-memory opt-in limit")

    def synthetic():
        spec["fn"](*spec["args"])
        return {name: spec["args"][pos]
                for name, pos in spec["operands"].items()}

    # (label, shapes the operands must have, run -> owners, main path)
    runs = [("its synthetic graph", spec["hbm_shapes"], synthetic, False)]
    runs += [(label, (), functools.partial(MAIN_PATH_DRIVES[kernel], g,
                                           index, device), True)
             for label, g, index in graphs]
    totals = {}
    for label, shapes, run, main in runs:
        owners, launches = _launches_of(kernel, run)
        if not launches:
            finding(f"{kernel} was never launched on {label}")
            continue
        for args, _ in launches:
            out.extend(tr.operand_findings(
                args, spec["operands"], owners, label=f"{ep.name} on {label}",
                shapes=shapes, anchor=anchor))
        if main:
            totals[label] = tr.smem_totals(
                static, spec["dynamic_smem"](lib, *launches[0]))
    for label, sizes in totals.items():
        notes.append(f"{ep.name} on {label}: shared bytes a block "
                     + ", ".join(f"{raw} {b} (static {static[raw]})"
                                 for raw, b in sorted(sizes.items()))
                     + f"; opt-in limit {optin}")
    if optin is not None:
        out.extend(tr.smem_findings(totals, optin, name=ep.name,
                                    anchor=anchor))
    return out


def _run_hbm_residency(device, main_graph=None) -> RuleResult:
    res = RuleResult(
        rule="hbm-residency", kind="trace",
        description="the CSR and the [n, L] index reach each kernel as the "
                    "caller's global memory and are only gathered from; no "
                    "block's shared memory grows with n, nnz or n*L; each "
                    "block's shared memory stays within the card's opt-in "
                    "limit",
        findings=[],
    )
    eps = entry_points("hbm-residency")
    graphs = (_audit_graphs(device, main_graph)
              if device.type == "cuda" and eps else [])
    from repro_torch.kernels import build

    for ep in eps:
        spec = ep.build(device)
        if "skip" in spec:
            res.skipped.append(f"{ep.name}: {spec['skip']}")
            continue
        res.findings.extend(tr.shared_memory_findings(
            _CSRC / build.SOURCES[spec["kernel"]],
            operands=spec["operands"], root=_ROOT))
        if device.type == "cuda":
            res.findings.extend(_hbm_on_card(ep, spec, graphs, device,
                                             res.notes))
        res.audited.append(ep.name)
    return res


def _run_no_replicated_index(device, main_graph=None) -> RuleResult:
    res = RuleResult(
        rule="no-replicated-index", kind="trace",
        description="the sharded build's step returns its rows stacked per "
                    "model shard and holds no array >= [n, L] (the index "
                    "must stay model-sharded, never replicated)",
        findings=[],
    )
    for ep in entry_points("no-replicated-index"):
        spec = ep.build(device)
        if "skip" in spec:
            res.skipped.append(f"{ep.name}: {spec['skip']}")
            continue
        res.findings.extend(tr.replicated_index_findings(
            spec["records"], spec["outputs"], n=spec["n"], l=spec["l"],
            shards=spec["shards"], anchor=ep.module,
        ))
        res.audited.append(ep.name)
    return res


def _run_dense_state_bound(device, main_graph=None) -> RuleResult:
    res = RuleResult(
        rule="dense-state-bound", kind="trace",
        description="no f32[rows, n] intermediate in the sparse walk chunk "
                    "and no f32[Q, n] in the sparse query path (budget must "
                    "stay below the dense floor)",
        findings=[],
    )
    for ep in entry_points("dense-state-bound"):
        spec = ep.build(device)
        if "skip" in spec:
            res.skipped.append(f"{ep.name}: {spec['skip']}")
            continue
        res.findings.extend(tr.dense_state_findings(
            spec["records"], budget=spec["budget"], floor=spec["floor"],
            anchor=ep.module,
        ))
        res.audited.append(ep.name)
    return res


def _run_retrace_guard(device, main_graph=None) -> RuleResult:
    res = RuleResult(
        rule="retrace-guard", kind="trace",
        description="the captured serving dispatch holds exactly one CUDA "
                    "graph per bucketed pad width (no dtype or input-"
                    "spelling recaptures)",
        findings=[],
    )
    for ep in entry_points("retrace-guard"):
        spec = ep.build(device)
        if "skip" in spec:
            res.skipped.append(f"{ep.name}: {spec['skip']}")
            continue
        if not spec.get("captures", True):
            res.skipped.append(
                f"{ep.name}: the dispatch runs eagerly on this device and "
                f"captures nothing (CUDA graphs are captured on the card)")
            continue
        cache = spec["cache"]
        widths: Sequence[int] = spec["widths"]
        variants: int = spec.get("variants", 1)
        call: Callable[[int, int], None] = spec["call"]
        cache.clear()
        for width in widths:
            for variant in range(variants):
                call(width, variant)
        n_entries = len(cache)
        if n_entries != len(widths):
            res.findings.append(Finding(
                rule="retrace-guard", file=ep.module, line=0,
                message=f"{ep.name}: {n_entries} captured graphs for "
                        f"{len(widths)} pad-width buckets {list(widths)} "
                        f"x {variants} input spellings — a width or input "
                        f"spelling is recapturing",
            ))
        res.audited.append(ep.name)
    return res


# -- lint rules --------------------------------------------------------------

def _lint_paths(scope: Sequence[str]) -> List[Path]:
    return [_SRC / rel for rel in scope]


def _run_lint_rule(rule: str, description: str,
                   paths: Sequence[Path]) -> RuleResult:
    res = RuleResult(rule=rule, kind="lint", description=description,
                     findings=[])
    for path in paths:
        anchor = "src/repro_torch/" + str(path.relative_to(_SRC))
        if not path.exists():
            res.skipped.append(f"{anchor}: file not found")
            continue
        res.findings.extend(lint.lint_file(path, anchor, [rule]))
        res.audited.append(anchor)
    return res


def _run_host_sync(device=None, main_graph=None) -> RuleResult:
    return _run_lint_rule(
        lint.HOST_SYNC,
        "no host syncs (.item(), .tolist(), .cpu(), .numpy(), .to('cpu'), "
        ".synchronize(), float()/bool()/int() on device values, device "
        "truthiness) in hot dispatch/harvest modules",
        _lint_paths(HOST_SYNC_SCOPE),
    )


def _run_rng_discipline(device=None, main_graph=None) -> RuleResult:
    return _run_lint_rule(
        lint.RNG_DISCIPLINE,
        "build/repair RNG keys stay positional: no split() stored into "
        "mutable state, no fold_in with non-literal non-offset data",
        _lint_paths(RNG_SCOPE),
    )


def _run_bare_time(device=None, main_graph=None) -> RuleResult:
    paths = [
        p for p in sorted(_SRC.rglob("*.py"))
        if str(p.relative_to(_SRC)) not in BARE_TIME_EXEMPT
    ]
    return _run_lint_rule(
        lint.BARE_TIME,
        "no bare time.time() / stdlib random.* / draws from torch's global "
        "generator outside loadgen",
        paths,
    )


RULES: Dict[str, Callable[..., RuleResult]] = {
    "hbm-residency": _run_hbm_residency,
    "no-replicated-index": _run_no_replicated_index,
    "dense-state-bound": _run_dense_state_bound,
    "retrace-guard": _run_retrace_guard,
    "host-sync": _run_host_sync,
    "rng-discipline": _run_rng_discipline,
    "bare-time": _run_bare_time,
}
_TRACED = ("hbm-residency", "no-replicated-index", "dense-state-bound",
           "retrace-guard")


def run_rules(only: Optional[Sequence[str]] = None, device="cuda",
              main_graph: Optional[MainGraph] = None) -> List[RuleResult]:
    """Run the catalog (or the ``only`` subset) on ``device`` and return
    per-rule results.  ``main_graph`` is ``(graph, index)`` on the card
    for hbm-residency's shapes (default: rmat(20) with an index of its
    own).

    Entry points are loaded first; lint rules need no device and run
    whatever the traced rules can do.
    """
    names = list(RULES) if not only else list(only)
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise ValueError(
            f"unknown rule(s) {unknown}; known: {sorted(RULES)}"
        )
    dev = resolve_device(device)
    if any(n in _TRACED for n in names):
        load_entry_points()
    return [RULES[name](dev, main_graph) for name in names]
