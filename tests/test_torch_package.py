"""Package rules of the PyTorch port (``src/repro_torch``).

* It imports neither ``jax`` nor any module of the JAX package ``repro``.
* Its entry points default to ``device="cuda"`` and raise where there is
  no GPU, instead of quietly running on the CPU.
* ``convert`` carries the reference's arrays (graphs, indexes, keys, DLRM
  parameters) across unchanged.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as jdlrm_cfg
from repro.graphs import synthetic as jsyn
from repro.models.recsys import dlrm as jdlrm
from repro_torch import convert, rng
from repro_torch.analysis import __main__ as analysis_cli
from repro_torch.configs import dlrm_rm2 as tdlrm_cfg
from repro_torch.configs import get_arch
from repro_torch.core import index as tindex
from repro_torch.core.graph import Graph
from repro_torch.core.query import BatchQueryEngine
from repro_torch.core.updates import build_maintainable_index
from repro_torch.graphs import synthetic as tsyn
from repro_torch.launch import serve, steps
from repro_torch.models import gcn as tgcn
from repro_torch.models.recsys import dlrm as tdlrm
from repro_torch.serving import PPRService

torch.set_num_threads(1)
PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference_module():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    walked = {f.relative_to(PKG).as_posix() for f in files}
    assert {"distributed/sharding.py", "distributed/mesh.py",
            "launch/mesh.py", "launch/ranks.py", "models/transformer.py",
            "configs/qwen1_5_32b.py", "configs/command_r_plus_104b.py",
            "configs/dbrx_132b.py", "configs/grok_1_314b.py",
            "core/index.py", "core/updates.py", "serving/engine.py"} <= walked
    bad = [(f.relative_to(PKG), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_chip_smoke_imports_no_jax():
    path = PKG.parents[1] / "chip_smoke.py"
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]


@pytest.fixture()
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_default_device_entry_points_raise_without_gpu(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        tsyn.rmat(6)
    with pytest.raises(RuntimeError, match="cuda"):
        Graph.from_edges([0, 1], [1, 0])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.graph_from_arrays([0, 1, 2], [1, 0], [0, 1], [1, 1], 2, 2)
    g = tsyn.rmat(6, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tindex.build_index(g, r=2, l=4, key=rng.prng_key(0))
    index, _ = tindex.build_index(g, r=2, l=4, key=rng.prng_key(0),
                                  device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchQueryEngine(g, index)
    with pytest.raises(RuntimeError, match="cuda"):
        PPRService(g, index)
    with pytest.raises(RuntimeError, match="cuda"):
        build_maintainable_index(g, r=2, l=4, key=rng.prng_key(0))
    ckpt = tmp_path / "ckpt"
    tindex.build_index(g, r=2, l=4, key=rng.prng_key(0), device="cpu",
                       checkpoint_dir=str(ckpt))
    with pytest.raises(RuntimeError, match="cuda"):
        PPRService.from_checkpoint(g, str(ckpt))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--n-log2", "6", "--r", "2", "--queries", "4"])
    with pytest.raises(RuntimeError, match="cuda"):
        steps.build("dlrm-rm2", "serve_p99", reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tdlrm.init(tdlrm_cfg.reduced(), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.dlrm_params_from_arrays({"w": np.zeros(2, np.float32)})
    for arch in ("dcn-v2", "sasrec", "mind"):
        with pytest.raises(RuntimeError, match="cuda"):
            steps.build(arch, "serve_p99", reduced=True)
        spec = get_arch(arch)
        with pytest.raises(RuntimeError, match="cuda"):
            steps._REC_MODS[spec.model_kind].init(spec.reduced, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.recsys_params_from_arrays({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        steps.build("gcn-cora", "full_graph_sm", reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tgcn.init(steps._gnn_cfg(get_arch("gcn-cora").reduced,
                                 get_arch("gcn-cora").shape("molecule")), 0)
    with pytest.raises(RuntimeError, match="cuda"):
        tsyn.batched_molecules(2, 3, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        analysis_cli.main([])


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--n-log2", "14", "--r", "2", "--queries", "48",
                "--max-batch", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "48 queries" in out and "q/s" in out


def test_serve_cli_runs_the_dense_route_on_cpu(capsys):
    """At the reference's default n = 2,048 every mode serves dense; verd
    needs no index, nor does mcfp."""
    serve.main(["--mode", "verd", "--queries", "40", "--max-batch", "16",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "n=2048" in out and "route=dense: 40 queries" in out
    serve.main(["--mode", "mcfp", "--n-log2", "6", "--queries", "4",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "n=64" in out and "mode=mcfp route=dense: 4 queries" in out


def test_convert_round_trips_reference_state():
    jg = jsyn.rmat(7, avg_deg=4.0, seed=9)
    tg = convert.graph_from_arrays(jg.row_ptr, jg.col_idx, jg.src,
                                   jg.out_deg, jg.n, jg.m, device="cpu")
    for name in ("row_ptr", "col_idx", "src", "out_deg"):
        t = getattr(tg, name)
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy(), np.asarray(getattr(jg, name)))
    r = np.random.default_rng(0)
    vals = r.random((jg.n, 8)).astype(np.float32)
    idx = r.integers(0, jg.n, (jg.n, 8)).astype(np.int32)
    ti = convert.index_from_arrays(vals, idx, device="cpu")
    assert (ti.n, ti.l) == (jg.n, 8)
    assert np.array_equal(ti.values.numpy(), vals)
    key = jax.random.fold_in(jax.random.PRNGKey(2), 5)
    assert np.array_equal(
        convert.key_from_array(jax.random.key_data(key)).numpy(),
        np.asarray(jax.random.key_data(key)).astype(np.int64))


def test_convert_round_trips_reference_dlrm_params():
    """Every array of the reference's DLRM pytree arrives under the same
    path, shape, dtype and bits, dense weights as ``[d_in, d_out]``."""
    cfg = jdlrm_cfg.reduced()
    tree = jax.tree.map(np.asarray, jdlrm.init(cfg, jax.random.PRNGKey(3)))
    got = convert.dlrm_params_from_arrays(tree, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == 1 + 2 * (len(cfg.bot_mlp) - 1 + len(cfg.top_mlp))
    for path, want in flat:
        t = got
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.float32 and t.shape == want.shape
        assert np.array_equal(t.numpy(), want)
    assert got["top"]["layer_0"]["w"].shape == (cfg.top_in, cfg.top_mlp[0])
    back = jax.tree.map(np.asarray, got)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
