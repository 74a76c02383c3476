"""The port's auditor audited (``src/repro_torch/analysis``): each rule must
fire on its violation fixture with the right file:line anchor, suppression
must work exactly as documented, the port's engine must agree with the
reference's (``repro.analysis``) where the two share ground, and the full
runner must come back clean over the port's own tree on the CPU — the
no-false-positive gate.  The card half (captured graphs, the kernels'
shared memory and launch operands) is in ``tests/test_torch_cuda.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import lint as jlint
from repro.analysis import registry as jregistry
from repro.analysis import rules as jrules
from repro_torch.analysis import registry
from repro_torch.analysis import rules as rules_mod
from repro_torch.analysis.lint import (
    BARE_TIME,
    HOST_SYNC,
    RNG_DISCIPLINE,
    lint_file,
    parse_suppressions,
)
from repro_torch.analysis.trace import (
    dense_state_findings,
    operand_findings,
    parse_res_usage,
    record,
    replicated_index_findings,
    shared_memory_findings,
    smem_findings,
    smem_totals,
)

torch.set_num_threads(1)
FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
REF_FIXTURES = Path(__file__).parent / "analysis_fixtures"
REPO_ROOT = Path(__file__).resolve().parents[1]
CSRC = REPO_ROOT / "src" / "repro_torch" / "kernels" / "csrc"
PORT_KERNELS = {"walk_step.cu": ["col_idx"], "frontier_push.cu": ["col_idx"],
                "sharded_frontier_push.cu": ["col_idx"],
                "index_combine.cu": ["vals", "idx"]}


def _marker_line(path: Path, marker: str) -> int:
    """1-based line of the unique ``[viol:<marker>]`` tag in a fixture."""
    hits = [
        i for i, line in enumerate(path.read_text().splitlines(), start=1)
        if f"[viol:{marker}]" in line
    ]
    assert len(hits) == 1, (path, marker, hits)
    return hits[0]


def _with_entry(name, rule, build, fn):
    """Run ``fn()`` with the registry holding only one throwaway entry."""
    saved = registry.entry_points()
    registry.clear_entry_points()
    try:
        registry.register_entry_point(name, rule, "tests/x.py", build)
        return fn()
    finally:
        registry.clear_entry_points()
        for ep in saved:
            registry.register_entry_point(ep.name, ep.rule, ep.module,
                                          ep.build)


# -- traced rules fire on their violation fixtures ----------------------------

def test_dense_state_bound_fires_on_dense_intermediate():
    from torch_analysis_fixtures import bad_dense_step

    _, records = record(bad_dense_step.dense_chunk,
                        torch.arange(64, dtype=torch.int32), 4096)
    findings = dense_state_findings(records, budget=10_000,
                                    floor=64 * 4096)
    assert findings
    assert any("float32[64, 4096]" in f.message
               and "exceeds the sparse-state budget" in f.message
               for f in findings)
    assert all(f.rule == "dense-state-bound" for f in findings)


def test_dense_state_bound_budget_needs_teeth():
    _, records = record(lambda x: x * 2.0, torch.ones(8))
    findings = dense_state_findings(records, budget=100, floor=100)
    assert findings and "no teeth" in findings[0].message


def test_no_replicated_index_fires_on_replicated_step():
    from torch_analysis_fixtures import bad_build_step

    out, records = record(bad_build_step.replicated_step(2, 64, 16),
                          torch.ones(8, 4))
    findings = replicated_index_findings(
        records, [tuple(o.shape) for o in out], n=64, l=16, shards=2,
        anchor="tests/torch_analysis_fixtures/bad_build_step.py")
    assert findings
    assert any("(2, 64, 16)" in f.message and "replicated" in f.message
               for f in findings)
    assert all(f.rule == "no-replicated-index" for f in findings)


def test_no_replicated_index_fires_without_shard_axis():
    from torch_analysis_fixtures import bad_build_step

    out, records = record(bad_build_step.unstacked_step(2, 64, 16),
                          torch.ones(8, 4))
    findings = replicated_index_findings(
        records, [tuple(o.shape) for o in out], n=64, l=16, shards=2)
    assert len(findings) == 1
    assert "no array stacked on its 2 model shards" in findings[0].message


@pytest.mark.parametrize("marker", ["runtime-extent", "writable",
                                    "dynamic-bytes"])
def test_hbm_residency_fires_on_kernel_fixture(marker):
    path = FIXTURES / "bad_kernel.cu"
    findings = shared_memory_findings(path, operands=["col_idx"],
                                      root=REPO_ROOT)
    anchor = "tests/torch_analysis_fixtures/bad_kernel.cu"
    assert {f.file for f in findings} == {anchor}
    assert all(f.rule == "hbm-residency" for f in findings)
    assert _marker_line(path, marker) in {f.line for f in findings}
    assert len(findings) == 3


@pytest.mark.parametrize("cu", sorted(PORT_KERNELS))
def test_hbm_residency_passes_on_port_kernels(cu):
    """Control: the real kernels' sources yield no finding."""
    assert shared_memory_findings(CSRC / cu, operands=PORT_KERNELS[cu],
                                  root=REPO_ROOT) == []


def test_hbm_residency_operands_must_be_the_owners_storage():
    """The card half's operand check, on CPU tensors: the owner's own
    tensor passes; a copy of it, or a block of another shape, fires."""
    col_idx = torch.arange(64, dtype=torch.int32)
    ops_ = {"col_idx": 1}
    owners = {"col_idx": col_idx}
    assert operand_findings((None, col_idx), ops_, owners, label="g",
                            shapes=[(64,)]) == []
    copied = operand_findings((None, col_idx.clone()), ops_, owners,
                              label="g")
    assert len(copied) == 1 and "a copy reached the kernel" in \
        copied[0].message
    wrong = operand_findings((None, col_idx[:32]), ops_, owners, label="g",
                             shapes=[(64,)])
    assert len(wrong) == 1 and "not one of [(64,)]" in wrong[0].message


RES_USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,8]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN2wr17merge_pass_kernelEPKyPyPKiPKxS4_x:
  REG:40 STACK:0 SHARED:1040 LOCAL:0 CONSTANT[0]:584 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function walk_step_kernel:
  REG:16 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:612 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_hbm_residency_shared_bytes_a_block():
    """The card half's byte accounting on a library's resource usage:
    static plus the planners' dynamic bytes (matched through C++ name
    mangling), the same on every graph and within the opt-in limit."""
    static = parse_res_usage(RES_USAGE)
    merge = "_ZN2wr17merge_pass_kernelEPKyPyPKiPKxS4_x"
    assert static == {merge: 1040, "walk_step_kernel": 0}
    dyn = {"merge_pass_kernel": 65536}
    same = smem_totals(static, dyn)
    assert same == {merge: 66576, "walk_step_kernel": 0}
    assert smem_findings({"n=4096": same, "n=2^20": same}, 232448,
                         name="x") == []
    grown = smem_totals(static, {"merge_pass_kernel": 65536 * 2})
    findings = smem_findings({"n=4096": same, "n=2^20": grown}, 100_000,
                             name="x")
    assert [("over the opt-in" in f.message, "grows with the graph"
             in f.message) for f in findings] == [(True, False),
                                                  (False, True)]


@pytest.mark.parametrize("keyed_on,fires", [("dtype", True),
                                            ("width", False)])
def test_retrace_guard_fires_on_dtype_keyed_cache(keyed_on, fires):
    """A dispatcher that keys its captured graphs on dtype as well as
    width holds two graphs per width when fed int32 then int64; keyed on
    width alone it holds one."""
    from torch_analysis_fixtures import bad_dispatch

    disp = (bad_dispatch.DtypeKeyedDispatcher() if keyed_on == "dtype"
            else bad_dispatch.WidthKeyedDispatcher())

    def call(width, variant):
        disp.dispatch(np.zeros(width, (np.int32, np.int64)[variant]))

    res = _with_entry(
        "bad-dispatch", "retrace-guard",
        lambda device: dict(cache=disp.graphs, widths=[1, 2, 4],
                            variants=2, call=call),
        lambda: rules_mod._run_retrace_guard(torch.device("cpu")))
    assert res.audited == ["bad-dispatch"]
    if fires:
        assert res.status == "FAIL"
        assert "6 captured graphs" in res.findings[0].message
        assert "recapturing" in res.findings[0].message
    else:
        assert res.status == "PASS" and not res.findings


# -- lint rules fire with the right file:line ---------------------------------

HOST_SYNC_MARKERS = ("truthiness", "float", "item", "tolist", "cpu", "numpy",
                     "to-cpu", "to-cpu-kw", "cuda-sync", "event-sync",
                     "stream-sync", "bool", "int")


@pytest.mark.parametrize("marker", HOST_SYNC_MARKERS)
def test_host_sync_fixture_lines(marker):
    path = FIXTURES / "bad_hot_path.py"
    anchor = "tests/torch_analysis_fixtures/bad_hot_path.py"
    findings = lint_file(path, anchor, [HOST_SYNC])
    unsuppressed = {f.line for f in findings if not f.suppressed}
    assert _marker_line(path, marker) in unsuppressed
    assert all(f.file == anchor for f in findings)


def test_host_sync_fixture_flags_nothing_else():
    path = FIXTURES / "bad_hot_path.py"
    findings = lint_file(path, "x.py", [HOST_SYNC])
    marked = {_marker_line(path, m) for m in HOST_SYNC_MARKERS}
    loose = {f.line for f in findings if not f.suppressed} - marked
    assert len(loose) == 1   # the allow() without a justification


def test_host_sync_suppression_and_missing_justification():
    path = FIXTURES / "bad_hot_path.py"
    findings = lint_file(path, "x.py", [HOST_SYNC])
    ok_line = next(
        i for i, line in enumerate(path.read_text().splitlines(), start=1)
        if "[ok:suppressed]" in line
    )
    sup = [f for f in findings if f.line == ok_line]
    assert len(sup) == 1 and sup[0].suppressed
    assert "harvest after the event" in sup[0].justification
    missing = [f for f in findings
               if not f.suppressed and "missing the required justification"
               in f.message]
    assert len(missing) == 1


def test_rng_discipline_fixture_lines():
    path = FIXTURES / "bad_rng.py"
    findings = lint_file(path, "bad_rng.py", [RNG_DISCIPLINE])
    assert {f.line for f in findings} == {
        _marker_line(path, "split-state"), _marker_line(path, "fold-data")}
    assert all(not f.suppressed for f in findings)


def test_bare_time_fixture_line():
    path = FIXTURES / "bad_rng.py"
    findings = lint_file(path, "bad_rng.py", [BARE_TIME])
    assert {f.line for f in findings} == {_marker_line(path, "bare-time")}


def test_bare_time_fires_on_global_generator_draws():
    path = FIXTURES / "bad_draw.py"
    findings = lint_file(path, "bad_draw.py", [BARE_TIME])
    assert sorted(f.line for f in findings) == sorted(
        _marker_line(path, m) for m in ("manual-seed", "randn", "uniform"))


# -- runner plumbing ----------------------------------------------------------

def test_run_rules_only_subset():
    results = rules_mod.run_rules(only=["bare-time"], device="cpu")
    assert [r.rule for r in results] == ["bare-time"]
    with pytest.raises(ValueError, match="unknown rule"):
        rules_mod.run_rules(only=["no-such-rule"], device="cpu")


def test_report_json_shape():
    from repro_torch.analysis import report as report_mod

    results = rules_mod.run_rules(only=["rng-discipline"], device="cpu")
    payload = json.loads(report_mod.render_json(results))
    assert set(payload) == {"results", "exit_code"}
    assert payload["exit_code"] == 0
    (entry,) = payload["results"]
    assert set(entry) == {"rule", "kind", "status", "description",
                          "audited", "skipped", "findings"}
    assert entry["rule"] == "rng-discipline"
    assert entry["kind"] == "lint"
    assert entry["status"] == "PASS"
    assert entry["audited"]


# -- parity with the reference's auditor --------------------------------------

@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_parse_suppressions_matches_reference(package):
    files = sorted((REPO_ROOT / "src" / package).rglob("*.py"))
    assert len(files) > 20
    for path in files:
        text = path.read_text()
        assert parse_suppressions(text) == jlint.parse_suppressions(text), \
            path


@pytest.mark.parametrize("rule", [RNG_DISCIPLINE, BARE_TIME])
def test_lint_matches_reference_on_its_rng_fixture(rule):
    path = REF_FIXTURES / "bad_rng.py"
    ours = lint_file(path, "bad_rng.py", [rule])
    theirs = jlint.lint_file(path, "bad_rng.py", [rule])
    assert ours
    assert ([(f.line, f.suppressed) for f in ours]
            == [(f.line, f.suppressed) for f in theirs])


SPEC_KEYS = ("budget", "floor", "widths", "variants", "hbm_shapes", "n", "l")


def _reference_specs():
    jrules.load_entry_points()
    return {(ep.rule, ep.name): ep for ep in jregistry.entry_points()}


@pytest.mark.parametrize("rule,name", [
    ("hbm-residency", "frontier-push"),
    ("hbm-residency", "sharded-frontier-push"),
    ("hbm-residency", "index-combine-sparse"),
    ("hbm-residency", "walk-step"),
    ("dense-state-bound", "sparse-walk-chunk"),
    ("dense-state-bound", "sparse-query-path"),
    ("retrace-guard", "fused-topk-serving"),
    ("no-replicated-index", "sparse-index-build-step"),
])
def test_spec_builders_match_reference(rule, name):
    """Each port builder draws the reference's fixture: the same budget,
    floor, widths, variants, operand shapes and index dimensions."""
    rules_mod.load_entry_points()
    ours = {(ep.rule, ep.name): ep for ep in registry.entry_points()}
    theirs = _reference_specs()
    assert set(ours) == set(theirs)
    got = ours[(rule, name)].build("cpu")
    want = theirs[(rule, name)].build()
    if "skip" in want:   # the reference's sharded step needs >= 2 devices
        want = dict(n=64, l=16)
    shared = [k for k in SPEC_KEYS if k in want]
    assert shared
    for k in shared:
        w = want[k]
        if k == "hbm_shapes":
            w = [tuple(int(d) for d in s) for s in w]
        assert got[k] == w, k


# -- the no-false-positive gate over the port's tree --------------------------

def test_auditor_clean_on_port_tree():
    """``python -m repro_torch.analysis --device cpu --json`` exits 0 with
    every rule PASS and a target audited, but ``retrace-guard``, which
    SKIPs on the CPU with its reason, and every suppression justified."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--json"],
        capture_output=True, text=True, cwd=REPO_ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["exit_code"] == 0
    by_rule = {r["rule"]: r for r in payload["results"]}
    assert set(by_rule) == {
        "hbm-residency", "no-replicated-index", "dense-state-bound",
        "retrace-guard", "host-sync", "rng-discipline", "bare-time",
    }
    for rule, entry in by_rule.items():
        assert [f for f in entry["findings"] if not f["suppressed"]] == []
        assert all(f["justification"] for f in entry["findings"])
        if rule == "retrace-guard":
            assert entry["status"] == "SKIP" and not entry["audited"]
            assert "captures nothing" in entry["skipped"][0]
        else:
            assert entry["status"] == "PASS", (rule, entry)
            assert entry["audited"], rule
    assert len(by_rule["hbm-residency"]["audited"]) == 4
    assert len(by_rule["dense-state-bound"]["audited"]) == 2
    assert any(f["file"].endswith("serving/pipeline.py")
               for f in by_rule["host-sync"]["findings"])
