"""The port's dry-run and roofline (``repro_torch.launch.dryrun``,
``roofline/``) against the reference's, on the CPU.

* ``configs/powerwalk.py`` equals the reference's field by field, and the
  port's ``describe`` gives the reference's keys and counts;
* each ``CostCounter`` rule gives its exact value on hand-made ops;
* each of the eight kernel wrappers on meta gives its plain version's
  shapes and dtypes, charges its operands and outputs once and counts no
  launch (and still takes the plain route on the CPU);
* the matmul FLOPs of the reduced ``smollm-135m`` ``prefill_32k`` and
  ``dlrm-rm2`` ``serve_p99`` forwards equal the reference's dot FLOPs of
  the compiled step (its own ``parse_module``, ``computation_multipliers``
  and ``_dot_flops``) within 0.1%;
* the ``all-to-all`` bytes per device of one VERD tile on a 2 x 2 mesh
  equal the reference's ``hlo_parse.analyze`` of its step lowered on four
  fake host devices (a subprocess: this file, run as a script), on both
  exchanges;
* the argument bytes of a traced cell are its parameters', optimizer
  state's, cache's and batch's; two full-size cells trace without
  allocating; a failing cell is recorded and ``main`` exits 1; the report
  renders.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import powerwalk as jpw
from repro.launch import steps as jsteps
from repro.roofline import hlo_parse
from repro_torch.configs import powerwalk as tpw
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.graphs import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.roofline import analysis as troof
from repro_torch.roofline import report as treport
from repro_torch.roofline.cost import CostCounter
from repro_torch.training import train_loop
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

# rmat(12)'s shapes (n = 4,096, 16 edges a vertex) for the tile parity;
# an f32 wire: XLA's CPU backend carries a bf16 all-to-all as f32 (it
# converts around the collective), which would double the reference's bytes
TILE_SPECS = {
    "sparse": dict(n=4096, m=65536, q_tile=8, index_l=16, frontier_k=256,
                   wire_k=128, degree_cap=512, hub_split_degree=64),
    "dense": dict(n=4096, m=65536, q_tile=4, index_l=16, exchange="dense"),
}


def _nbytes(t):
    return t.numel() * t.element_size()


# -- configs and meshes --------------------------------------------------------

def test_powerwalk_configs_equal_reference():
    assert set(tpw.PAPER_GRAPHS) == set(jpw.PAPER_GRAPHS)
    for name, g in jpw.PAPER_GRAPHS.items():
        assert dataclasses.asdict(tpw.PAPER_GRAPHS[name]) == \
            dataclasses.asdict(g)
    assert dataclasses.asdict(tpw.PowerWalkEngineConfig()) == \
        dataclasses.asdict(jpw.PowerWalkEngineConfig())
    want = [dataclasses.asdict(s) for s in jpw.engine_dryrun_shapes()]
    assert [dataclasses.asdict(s) for s in tpw.engine_dryrun_shapes()] == want
    assert [f.name for f in dataclasses.fields(tpw.PPRDryRunShape)] == \
        [f.name for f in dataclasses.fields(jpw.PPRDryRunShape)]


def test_describe_has_reference_keys_and_counts():
    from repro.launch import mesh as jmesh

    want = jmesh.describe(jax.make_mesh((1, 1), ("data", "model")))
    assert tmesh.describe(tmesh.make_debug_mesh(1, 1, device="cpu")) == want
    pod = tmesh.describe(tmesh.make_production_mesh())
    assert pod == dict(shape=dict(data=16, model=16), n_devices=256,
                       axis_names=["data", "model"])
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.describe(multi)["n_devices"] == 2 * 16 * 16
    assert multi.device.type == "meta" and multi.shape == dict(data=32,
                                                              model=16)


def test_meta_is_admitted_and_cuda_still_checked():
    assert ShardMesh(2, 2, device="meta").device.type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ShardMesh(2, 2)


# -- the counter's rules -------------------------------------------------------

def _count(fn, *args):
    counter = CostCounter()
    with counter:
        out = fn(*args)
    return counter, out


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_counter_matmul_is_2mnk_by_unit(dt):
    a = torch.empty((24, 40), dtype=dt, device="meta")
    b = torch.empty((40, 8), dtype=dt, device="meta")
    c, _ = _count(torch.matmul, a, b)
    flops = 2 * 24 * 8 * 40
    tc = dt == torch.bfloat16
    assert (c.flops_tc, c.flops_other, c.flops_dot) == \
        ((flops, 0, flops) if tc else (0, flops, flops))
    assert c.hbm == _nbytes(a) + _nbytes(b) + 24 * 8 * a.element_size()
    x = torch.empty((3, 24, 40), dtype=dt, device="meta")
    c, _ = _count(torch.einsum, "bmk,kn->bmn", x, b)
    assert c.flops_dot == 2 * 3 * 24 * 8 * 40


def test_counter_elementwise_view_gather_and_scatter():
    x = torch.empty((64, 32), device="meta")
    y = torch.empty((64, 32), device="meta")
    c, _ = _count(torch.add, x, y)
    assert (c.flops_other, c.hbm) == (64 * 32, 3 * _nbytes(x))
    c, _ = _count(lambda t: t.t().reshape(-1)[:100].view(10, 10), x.t())
    assert (c.flops_other, c.hbm) == (0, 0)
    idx = torch.empty((5,), dtype=torch.int64, device="meta")
    c, out = _count(torch.index_select, x, 0, idx)
    assert (c.flops_other, c.hbm) == (0, 2 * _nbytes(out))
    upd = torch.empty((5, 32), device="meta")
    c, _ = _count(lambda t: t.index_put_((idx,), upd, accumulate=True), x)
    assert c.hbm == 2 * _nbytes(upd)
    c, _ = _count(torch.sum, x)
    assert (c.flops_other, c.hbm) == (1, _nbytes(x) + 4)


def test_counter_memory_arguments_temps_and_aliases():
    """A temporary freed inside the step counts toward the peak only while
    it lives; an argument updated in place is aliased."""
    p = torch.empty((1000,), device="meta")
    x = torch.empty((10,), device="meta")

    def step(p, x):
        t = torch.exp(p)              # 4,000 B, freed below
        s = t.sum()
        del t
        u = torch.empty((250,), device="meta").fill_(0.0)   # 1,000 B
        p.add_(1.0)
        return p, s + u.sum()

    counter = CostCounter()
    counter.arguments((p, x))
    with counter:
        out = step(p, x)
    cost = counter.result(out)
    assert cost.argument_bytes == 4040 and cost.alias_bytes == 4000
    assert cost.output_bytes == 4004
    fits, used = troof.fit_check(troof.roofline_from_counts(cost))
    # peak: t (4,000) and s (4) live together; the output s + u.sum() is 4
    assert fits and used == 4040 + 4 + (4004 - 4)


# -- the eight wrappers on meta ------------------------------------------------

def _wrapper_cases():
    g = tsyn.rmat(6, device="cpu")
    n, m = g.n, g.m
    r = torch.Generator().manual_seed(0)
    q, k, l, s = 3, 4, 5, 6
    fv = torch.rand((q, k), generator=r)
    fi = torch.randint(0, n, (q, k), generator=r, dtype=torch.int32)
    vals = torch.rand((n, l), generator=r)
    idx = torch.randint(0, n, (n, l), generator=r, dtype=torch.int32)
    ids = torch.randint(0, 50, (7, 3), generator=r, dtype=torch.int32)
    mask = torch.rand((7, 3), generator=r)
    w = torch.randint(0, n, (9,), generator=r, dtype=torch.int32)
    ell = g.ell()
    ns = n // 2
    rp_local = g.row_ptr[:ns + 1].clone()
    cases = {
        "walk_step": (tops.walk_step, (w, w, torch.rand(9, generator=r),
                                       g.row_ptr, g.out_deg, g.col_idx), {}),
        "frontier_push": (tops.frontier_push, (
            fv, fi, torch.zeros((q, 8)), torch.zeros((q, 8), dtype=torch.int32),
            g.row_ptr, g.out_deg, g.col_idx),
            dict(c=0.15, degree_cap=64, hub_split_degree=0, slots=2,
                 k_out=8, run_first=True)),
        "index_combine_sparse": (tops.index_combine_sparse, (
            torch.rand((q, s), generator=r),
            torch.randint(0, n, (q, s), generator=r, dtype=torch.int32),
            fv, fi, vals, idx), dict(k_out=10)),
        "ell_spmm": (tops.ell_push, (torch.rand((q, n), generator=r), ell),
                     {}),
        "index_combine": (tops.index_combine, (
            torch.rand((q, n), generator=r), torch.rand((q, n), generator=r),
            vals, idx), {}),
        "sharded_frontier_push": (tops.sharded_frontier_push, (
            fv, torch.randint(0, ns, (q, k), generator=r, dtype=torch.int32),
            rp_local, g.col_idx[:int(rp_local[-1])].clone()),
            dict(c=0.15, degree_cap=64, ep=2, n_shard=ns, wire_k=6)),
        "embedding_bag": (tops.embedding_bag, (ids, mask,
                                               torch.rand((50, 16))), {}),
        "embedding_bag_backward": (tops.embedding_bag_backward, (
            ids, mask, torch.rand((7, 16), generator=r), 50), {}),
    }
    assert set(cases) == set(tops.KERNELS) and m > 0
    return cases


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to_meta(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    return x


def _charged_inputs(name, args):
    if name == "ell_spmm":
        f, e = args
        return [f, e.nbr, e.weight, e.row2vertex, e.vertex_rows]
    return [a for a in args if isinstance(a, torch.Tensor)]


@pytest.mark.parametrize("name", tops.KERNELS)
def test_wrapper_on_meta_charges_custom_call_and_no_launch(name):
    fn, args, kwargs = _wrapper_cases()[name]
    tops.reset_launch_counts()
    want = fn(*args, **kwargs)                  # the CPU: the plain route
    assert tops.launch_counts()[name] == 0
    want = want if isinstance(want, tuple) else (want,)
    margs = tuple(_to_meta(a) for a in args)
    counter = CostCounter()
    with counter:
        got = fn(*margs, **kwargs)
    got = got if isinstance(got, tuple) else (got,)
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(t.shape, t.dtype, "meta") for t in want]
    inputs = sum(_nbytes(t) for t in _charged_inputs(name, margs))
    assert counter.hbm == inputs + sum(_nbytes(t) for t in got)
    assert counter.flops_tc + counter.flops_other == 0
    assert sum(tops.launch_counts().values()) == 0


def test_wrapper_on_meta_without_counter_is_refused():
    t = torch.zeros((2, 1), device="meta")
    with pytest.raises(ValueError):
        tops.embedding_bag(t.int(), t, t)


# -- parity with the reference's compiled programs -----------------------------

def _reference_dot_flops(arch_id, shape_name):
    b = jsteps.build(jget_arch(arch_id), shape_name, reduced=True)
    params = jax.eval_shape(b.init_fn, jax.random.PRNGKey(0))
    args = (params, b.batch_spec)
    text = jax.jit(b.step_fn).lower(*args).compile().as_text()
    comps = hlo_parse.parse_module(text)
    mult = hlo_parse.computation_multipliers(comps)
    return sum(mult.get(cname, 1.0) * hlo_parse._dot_flops(op, comp.ops)
               for cname, comp in comps.items()
               for op in comp.ops.values() if op.opcode == "dot")


@pytest.mark.parametrize("arch_id,shape_name", [
    ("smollm-135m", "prefill_32k"), ("dlrm-rm2", "serve_p99"),
    ("dbrx-132b", "prefill_32k"), ("grok-1-314b", "prefill_32k")])
def test_dot_flops_match_reference_hlo(arch_id, shape_name):
    want = _reference_dot_flops(arch_id, shape_name)
    cost, _ = dryrun.trace_cell(arch_id, shape_name, reduced=True)
    assert want > 0
    assert abs(cost.dot_flops - want) <= 1e-3 * want


def _reference_collectives(out_path):
    """Subprocess body: the reference's tile step lowered on a 2 x 2 mesh
    of four fake host devices (the environment sets ``XLA_FLAGS``), each
    exchange's ``hlo_parse.analyze`` collective bytes."""
    import jax.numpy as jnp

    from repro.core import distributed_engine as jde
    from repro.distributed import sharding as shpol
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, spec in TILE_SPECS.items():
        n = spec["n"]
        cfg = jde.DistConfig(
            n=n, ep=2, q_tile=spec["q_tile"], t_iterations=2,
            index_l=spec["index_l"], exchange=spec.get("exchange", "sparse"),
            frontier_k=spec.get("frontier_k", 0),
            wire_k=spec.get("wire_k", 0),
            degree_cap=spec.get("degree_cap", 0),
            hub_split_degree=spec.get("hub_split_degree", 0),
            wire_dtype=jnp.float32, batch_axes=shpol.batch_axes(mesh))
        m_shard = (((spec["m"] + 1) // 2 + 1023) // 1024) * 1024
        sds = jax.ShapeDtypeStruct
        ish = NamedSharding(mesh, P("model", None, None))
        args = (jde.ShardedGraph.specs(cfg, m_shard),
                sds((cfg.q_tile,), jnp.int32),
                sds((2, cfg.n_shard, cfg.index_l), jnp.bfloat16),
                sds((2, cfg.n_shard, cfg.index_l), jnp.int32))
        shards = (jde.ShardedGraph.shardings(cfg, mesh),
                  NamedSharding(mesh, P()), ish, ish)
        with mesh:
            compiled = jax.jit(jde.make_verd_tile_step(cfg, mesh),
                               in_shardings=shards).lower(*args).compile()
        out[name] = hlo_parse.analyze(compiled.as_text()).collective_breakdown
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def reference_collectives(tmp_path_factory):
    out = tmp_path_factory.mktemp("coll") / "reference.json"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("exchange", sorted(TILE_SPECS))
def test_all_to_all_bytes_match_reference_hlo(exchange,
                                              reference_collectives):
    """Per device, f32 wire: sparse all-to-all 58,368 B (t = 2 pushes of
    ``[8, 2, 128]`` values and indices, then the combine's ``[8, 2,
    200]``), dense 196,608 B (three ``[4, 2, 2048]`` slabs).  Beside them,
    equal as well: all-reduce 64 / 32 B (the dangling mass, ``[q_tile]``
    twice) and all-gather 25,600 / 12,800 B (the local top-k values and
    ids, ``[q_tile, 2 * 200]``)."""
    spec = dict(TILE_SPECS[exchange], wire_dtype=torch.float32)
    cost, ctx = dryrun.trace_ppr_cell(exchange, ShardMesh(2, 2, device="meta"),
                                      spec=spec)
    want = reference_collectives[exchange]
    got = cost.collective_breakdown
    assert got["all-to-all"] == want["all-to-all"] > 0
    assert (got["all-reduce"], got["all-gather"]) == \
        (want["all-reduce"], want["all-gather"])
    assert ctx["mesh"]["n_devices"] == 4


# -- cells ---------------------------------------------------------------------

@pytest.mark.parametrize("arch_id,shape_name", [
    ("dlrm-rm2", "serve_p99"), ("smollm-135m", "decode_32k"),
    ("gcn-cora", "molecule"), ("sasrec", "train_batch"),
    ("dbrx-132b", "train_4k"), ("qwen1.5-32b", "decode_32k")])
def test_trace_argument_bytes_are_the_steps_inputs(arch_id, shape_name):
    b = tsteps.build(arch_id, shape_name, reduced=True, device="cpu")
    params = b.init_fn(dryrun.SEED)
    batch = b.make_batch(torch.Generator().manual_seed(1))
    if b.kind == "train":
        leaves = tree_leaves((params, train_loop.init_state(b.opt_cfg,
                                                            params)))
    else:    # serving holds bf16 weights
        leaves = [t.to(torch.bfloat16) if torch.is_floating_point(t) else t
                  for t in tree_leaves(params)]
        if b.make_cache is not None:
            leaves += tree_leaves(b.make_cache())
    want = sum(_nbytes(t) for t in leaves + tree_leaves(batch))
    cost, ctx = dryrun.trace_cell(arch_id, shape_name, reduced=True)
    assert cost.argument_bytes == want
    assert ctx["kind"] == b.kind
    if b.kind == "train" or b.make_cache is not None:
        assert cost.alias_bytes > 0        # updated in place


@pytest.mark.parametrize("arch_id", ["qwen1.5-32b", "command-r-plus-104b",
                                     "dbrx-132b", "grok-1-314b"])
def test_large_lm_decode_traces_at_full_size_with_mesh_bytes(arch_id):
    """A large LM's ``long_500k`` step at its published size on meta: the
    record holds the bytes a device of the 16 x 16 production mesh holds of
    its (bf16 serving) parameters under ``sharding``'s specs, about a
    256th of them; qwen's cache is int8 (its bf16 cache passes 0.5 TB)."""
    cost, ctx = dryrun.trace_cell(arch_id, "long_500k")
    cfg = tsteps.build(arch_id, "long_500k", device="meta")
    m = ctx["mesh_16x16"]
    assert m["shape"] == {"data": 16, "model": 16} and "opt_bytes" not in m
    whole = 2 * dryrun.get_arch(arch_id).config.param_count()
    assert whole / 256 <= m["param_bytes"] <= whole / 256 * 1.01
    assert ("k_scale" in cfg.cache_spec) == (arch_id == "qwen1.5-32b")
    assert cost.flops > 0 and cost.argument_bytes > whole


def test_run_cells_in_workers_keeps_the_cells_order(tmp_path):
    """``run_cells`` in two spawned processes: one record a cell, in the
    cells' order, each written; the train cell's record holds the mesh
    bytes of its optimizer state too.  ``run_jobs`` runs any module
    function, and returns a job's exception in its place."""
    cells = [("mind", "serve_p99"), ("dbrx-132b", "long_500k"),
             ("smollm-135m", "train_4k")]
    recs = dryrun.run_cells(cells, str(tmp_path), workers=2)
    assert [(r["arch"], r["shape"]) for r in recs] == cells
    assert all(r["ok"] for r in recs)
    assert len(list(tmp_path.glob("*.json"))) == 3
    assert "mesh_16x16" not in recs[0]
    m = recs[2]["mesh_16x16"]
    # smollm is too narrow for 16-way TP: every leaf replicated
    params = 4 * dryrun.get_arch("smollm-135m").config.param_count()
    assert m["param_bytes"] == params
    assert m["opt_bytes"] == 4 + params       # bf16 mu and nu
    ppr, bad = dryrun.run_jobs([
        (dryrun.run_ppr_cell, ("ppr_verd_ukunion",
                               tmesh.make_production_mesh(), str(tmp_path),
                               "pod"), {}),
        (dryrun.trace_cell, ("no-such-arch", "train_4k"), {})])
    assert ppr["ok"] and ppr["mesh_tag"] == "pod"
    assert isinstance(bad, KeyError)


_NO_ALLOCATION = """
import json, resource, time, torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
out = {}
for arch, shape in (("smollm-135m", "train_4k"), ("dlrm-rm2", "serve_bulk")):
    t0 = time.monotonic()
    cost, ctx = dryrun.trace_cell(arch, shape)
    terms = analysis.roofline_from_counts(cost)
    out[shape] = dict(seconds=time.monotonic() - t0,
                      used=analysis.fit_check(terms)[1])
out["grown_kb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - base
print(json.dumps(out))
"""


def test_full_size_cells_trace_without_allocating():
    """``train_4k`` at its published B = 256 (its peak is hundreds of GB)
    and DLRM's ``serve_bulk`` (a 3.3 GB bf16 table) trace in a fresh
    process whose peak resident memory grows by less than 256 MB."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, "-c", _NO_ALLOCATION], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["grown_kb"] < 256 * 1024
    assert got["train_4k"]["used"] > 200e9 and got["serve_bulk"]["used"] > 3e9
    assert got["train_4k"]["seconds"] < 20 and got["serve_bulk"]["seconds"] < 10


def test_failed_cell_is_recorded_and_main_exits_1(tmp_path, monkeypatch,
                                                  capsys):
    def boom(*a, **k):
        raise RuntimeError("no such step")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "dlrm-rm2", "--shape", "serve_p99",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "dlrm-rm2__serve_p99__card.json").read_text())
    assert rec["ok"] is False and "no such step" in rec["error"]
    assert "[FAIL]" in capsys.readouterr().out


def test_report_renders(tmp_path, capsys):
    hw = troof.Hardware()
    assert dryrun.run_cell("mind", "serve_p99", str(tmp_path), hw=hw)["ok"]
    rec = dryrun.run_ppr_cell("ppr_verd_ukunion",
                              tmesh.make_production_mesh(), str(tmp_path),
                              "pod", hw=hw)
    assert rec["ok"] and rec["hbm_fits"]
    assert rec["roofline"]["collective_breakdown"]["all-to-all"] > 0
    capsys.readouterr()
    treport.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert '"ok": 2' in out and "NVIDIA H100 80GB HBM3, 700 W" in out
    assert "| mind | serve_p99 |" in out
    assert "| powerwalk-engine | ppr_verd_ukunion |" in out
    recs = treport.load(str(tmp_path))
    assert {r["mesh_tag"] for r in recs} == {"card", "pod"}
    assert treport.summary(recs)["failed"] == 0


if __name__ == "__main__":
    _reference_collectives(sys.argv[1])
