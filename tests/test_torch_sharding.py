"""The port's sharding policy (``distributed/sharding.py``) and the
stacked mesh's per-axis collectives, against the JAX package's
``repro.distributed.sharding`` on the CPU.

The reference's spec functions read only a mesh's axis names and sizes,
so they run here on a stand-in of the 16 x 16 production mesh (or a
2 x 2 one); the port's on a ``ShardMesh`` of the same shape.  Parameter
trees are the full-size ones, from ``jax.eval_shape`` on the reference's
side and made on ``meta`` on the port's (nothing allocated).
"""

import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.distributed import ShardMesh
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun, steps
from repro_torch.roofline.cost import CostCounter
from repro_torch.training import train_loop

torch.set_num_threads(1)

MESHES = {"16x16": (16, 16), "2x2": (2, 2)}


def _ref_mesh(data, model):
    """What the reference's spec functions read of a ``jax`` mesh."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": data, "model": model})


def _norm(spec):
    """A spec as a tuple of entries, a one-axis tuple entry as its name
    (``P(("data",), None)`` and ``P("data", None)`` shard alike)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out)


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_leaves(tree[k], path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", jconfigs.all_arch_ids())
def test_param_specs_equal_the_references_for_every_leaf(arch):
    """Every leaf of the arch's full parameter tree (its first shape's
    bundle) gets the reference's spec; a train cell's optimizer state
    follows its parameters, as the reference's ``opt_state_specs``."""
    jspec = jconfigs.get_arch(arch)
    shape = jspec.shapes[0].name
    jb = jsteps.build(jspec, shape)
    jparams = jax.eval_shape(jb.init_fn, jax.random.PRNGKey(0))
    want = jsh.param_specs(jspec.family, jparams, jspec.config)
    tspec = tconfigs.get_arch(arch)
    tb = steps.build(arch, shape, device="meta")
    with dryrun._OnMeta():
        tparams = tb.init_fn(0)
    got = tsh.param_specs(tspec.family, tparams, tspec.config)
    wl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    gl = _port_leaves(got)
    assert len(wl) == len(gl) == len(_port_leaves(tparams))
    for (wpath, w), (gpath, g) in zip(wl, gl):
        assert tuple(p.key for p in wpath) == gpath
        assert isinstance(g, tsh.P)
        assert _norm(g) == _norm(w), (gpath, g, w)
    ost = tsh.opt_state_specs(got)
    assert ost.step == tsh.P() and ost.mu is got and ost.nu is got


@pytest.mark.parametrize("batch", [1, 2, 16, 256])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_equal_the_references(mesh, batch):
    """``batch_spec_lm`` for both LM kinds and ``cache_spec`` with and
    without the int8 scales, on 16 x 16 and 2 x 2, batches below, at
    and above the data axis."""
    data, model = MESHES[mesh]
    ref, port = _ref_mesh(data, model), ShardMesh(data, model, device="meta")
    assert tsh.batch_axes(port) == jsh.batch_axes(ref) == ("data",)
    assert tsh.data_axis_size(port) == jsh.data_axis_size(ref) == data
    assert tsh.model_axis_size(port) == jsh.model_axis_size(ref) == model
    for kind in ("lm_train", "lm_prefill"):
        w, g = jsh.batch_spec_lm(ref, kind, batch), \
            tsh.batch_spec_lm(port, kind, batch)
        assert {k: _norm(v) for k, v in g.items()} \
            == {k: _norm(v) for k, v in w.items()}
    for quantized in (False, True):
        w, g = jsh.cache_spec(ref, batch, quantized), \
            tsh.cache_spec(port, batch, quantized)
        assert {k: _norm(v) for k, v in g.items()} \
            == {k: _norm(v) for k, v in w.items()}
    with pytest.raises(ValueError):
        tsh.batch_spec_lm(port, "lm_decode", batch)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "dbrx-132b",
                                  "smollm-135m", "dlrm-rm2"])
def test_per_device_bytes_is_the_spec_arithmetic(arch):
    """Each leaf's block is its dims over its axes' ways, ceiling where
    they do not divide; a train cell's optimizer state too (bf16
    moments, or fp8 ``mu`` above 6e10 parameters)."""
    spec = tconfigs.get_arch(arch)
    shape = "train_4k" if spec.family == "lm" else "train_batch"
    b = steps.build(arch, shape, device="meta")
    with dryrun._OnMeta():
        params = b.init_fn(0)
        opt = train_loop.init_state(b.opt_cfg, params)
    mesh = ShardMesh(16, 16, device="meta")
    specs = tsh.param_specs(spec.family, params, spec.config)
    want = 0
    for (_, t), (_, s) in zip(_port_leaves(params), _port_leaves(specs)):
        ways = [1 if e is None else 16 for e in tuple(s)]
        ways += [1] * (t.dim() - len(ways))
        want += int(np.prod([-(-n // w) for n, w in zip(t.shape, ways)])) \
            * t.element_size()
    assert tsh.per_device_bytes(params, specs, mesh) == want
    mu = opt.mu
    got_opt = tsh.per_device_bytes(opt, tsh.opt_state_specs(specs), mesh)
    scale = sum(x.element_size() for x in (
        _port_leaves(mu)[0][1], _port_leaves(opt.nu)[0][1]))
    assert got_opt == 4 + want // 4 * scale
    if spec.family == "lm" and spec.config.d_model >= 2048:
        whole = sum(t.numel() * t.element_size()
                    for _, t in _port_leaves(params))
        assert whole / 256 <= tsh.per_device_bytes(params, specs, mesh) \
            <= whole / 256 * 1.01


def test_shard_lays_out_blocks_and_pads_uneven_dims():
    """``shard`` of a ``[40, 6]`` tensor: 40 rows over ``model`` = 4 (10
    a shard, no pad: a view), then 40 over 16 (3 a shard, 48 padded with
    zeros); a replicated axis repeats the block; an axis named twice or
    unknown is refused."""
    x = torch.arange(240, dtype=torch.float32).reshape(40, 6)
    mesh = ShardMesh(2, 4, device="cpu")
    s = tsh.shard(x, tsh.P("model", None), mesh)
    assert s.shape == (2, 4, 10, 6)
    assert s.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    for i in range(2):
        for j in range(4):
            assert torch.equal(s[i, j], x[10 * j:10 * j + 10])
    s = tsh.shard(x, tsh.P("model", "data"), mesh)
    assert s.shape == (2, 4, 10, 3)
    assert torch.equal(s[1, 2], x[20:30, 3:6])
    s = tsh.shard(x, tsh.P(("data", "model"), None), mesh)
    assert s.shape == (2, 4, 5, 6)
    assert torch.equal(s[1, 3], x[35:40])
    wide = ShardMesh(1, 16, device="cpu")
    s = tsh.shard(x, tsh.P("model"), wide)
    assert s.shape == (1, 16, 3, 6)
    assert torch.equal(s[0, 13, 0], x[39]) and not bool(s[0, 13, 1:].any())
    assert torch.equal(s.reshape(48, 6)[:40], x)
    assert tsh.block_shape((40, 6), tsh.P("model"), wide) == (3, 6)
    with pytest.raises(ValueError):
        tsh.shard(x, tsh.P("model", "model"), mesh)
    with pytest.raises(ValueError):
        tsh.shard(x, tsh.P("pod", None), mesh)


def test_per_axis_collectives_and_their_charges():
    """``psum_axis``, ``pmean_axis`` and ``all_gather_axis`` on ``[data,
    model, ...]`` blocks: each group of one axis joined, the other apart,
    every shard's result charged under the reference's kinds."""
    mesh = ShardMesh(2, 3, device="cpu")
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    s = mesh.psum_axis(x, "model")
    assert torch.equal(s[1, 2], x[1].sum(0))
    assert torch.equal(mesh.psum_axis(x, "data")[0, 1], x[:, 1].sum(0))
    assert torch.equal(mesh.pmean_axis(x, "data")[1, 0],
                       x[:, 0].sum(0) / 2)
    w = torch.arange(2 * 3 * 5 * 2, dtype=torch.float32).reshape(2, 3, 5, 2)
    g = mesh.all_gather_axis(w, "data", dim=1)
    assert g.shape == (2, 3, 5, 4)
    assert torch.equal(g[1, 2], torch.cat([w[0, 2], w[1, 2]], dim=1))
    assert torch.equal(g[0, 2], g[1, 2])
    with pytest.raises(ValueError):
        mesh.psum_axis(x.reshape(3, 2, 4), "model")
    meta = ShardMesh(2, 3, device="meta")
    counter = CostCounter()
    with counter:
        meta.psum_axis(torch.empty((2, 3, 4), device="meta"), "model")
        meta.all_gather_axis(torch.empty((2, 3, 5, 2), device="meta"),
                             "data", dim=1)
    coll = counter.result(None).collective_breakdown
    assert coll["all-reduce"] == 2 * 3 * 4 * 4
    assert coll["all-gather"] == 2 * 3 * 5 * 4 * 4


LM_ARCHS = ("qwen1.5-32b", "command-r-plus-104b", "dbrx-132b",
            "grok-1-314b")


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (16, 16)],
                         ids=["2x2", "1x4", "16x16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rank_layout_is_the_references_2d_layout(arch, mesh):
    """``rank_param_specs`` of a large LM's full tree (made on meta) gives
    every leaf the reference's 2-D spec (``lm_param_specs``), but for
    ``wk``/``wv`` where the kv heads do not split over ``model`` (8 kv
    heads on 16 model shards), which stay whole over ``model``;
    ``transformer.param_specs`` gives the same without a tree."""
    from repro_torch.models import transformer as tfm

    data, model = mesh
    jspec = jconfigs.get_arch(arch)
    jparams = jax.eval_shape(jsteps.build(jspec, "train_4k").init_fn,
                             jax.random.PRNGKey(0))
    want = jsh.lm_param_specs(jparams)
    cfg = tconfigs.get_arch(arch).config
    with dryrun._OnMeta():
        tparams = tfm.init(cfg, 0, device="meta")
    port = ShardMesh(data, model, device="meta")
    got = tsh.rank_param_specs(tparams, cfg, port)
    assert got == tfm.param_specs(cfg, port)
    wl = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    gl = _port_leaves(got)
    assert len(wl) == len(gl)
    kept = 0
    for (wpath, w), (gpath, g) in zip(wl, gl):
        assert tuple(p.key for p in wpath) == gpath
        w = _norm(w)
        if gpath[1:2] in (("wk",), ("wv",)) and cfg.n_kv_heads % model:
            w = tuple(None if e == "model" else e for e in w)
            kept += 1
        assert _norm(g) == w, (gpath, g, w)
    assert kept == (0 if cfg.n_kv_heads % model == 0
                    else 2 * (1 + cfg.qkv_bias))


def test_rank_trace_holds_a_ranks_blocks():
    """``dryrun.trace_rank_cell``: one rank of a 2 x 2 mesh traced on meta
    holds its blocks of the parameters and the moments (the arguments:
    ``per_device_bytes`` of the parameters, f32 moments under the reduced
    qwen's rules, fp8 ``mu`` and bf16 ``nu`` under command-r's, the step
    and the whole batch), and its collectives are charged."""
    from repro_torch.models import transformer as tfm

    mesh = ShardMesh(2, 2, device="meta")
    for arch, moments in (("qwen1.5-32b", 8), ("command-r-plus-104b", 3)):
        cfg = tconfigs.get_arch(arch).reduced
        cost, ctx = dryrun.trace_rank_cell(arch, "train_4k", 2, 2,
                                           reduced=True)
        with dryrun._OnMeta():
            whole = tfm.init(cfg, 0, device="meta")
        p = tsh.per_device_bytes(whole, tsh.rank_param_specs(
            whole, cfg, mesh), mesh)
        nbytes = sum(t.numel() * 4 for _, t in _port_leaves(whole))
        assert nbytes / 4 <= p < nbytes / 3     # the norm scales whole
        batch = 3 * 4 * 4 * 32            # tokens, labels, mask of [4, 32]
        assert cost.argument_bytes == p + p * moments // 4 + 4 + batch
        assert cost.collective_breakdown["all-gather"] > 0
        assert cost.collective_breakdown["all-to-all"] > 0
        assert ctx["mesh"]["n_devices"] == 4


def test_command_r_step_fits_a_card_of_a_2x2_rank_mesh():
    """command-r-plus-104b's full-width ``train_4k`` step at 2 layers and
    B = 8 under its published rules: one rank of a 2 x 2 mesh holds a
    quarter of the parameters and moments (13 B a parameter with the
    accumulator and one microbatch's f32 gradients), and its predicted
    peak is within the 75 GB gate of the four-card run, where one card
    would need 122 GB."""
    from repro_torch.roofline import analysis as roof

    cfg = tconfigs.get_arch("command-r-plus-104b").config
    n = dataclasses_replace_layers(cfg, 2).param_count()
    cost, _ = dryrun.trace_rank_cell("command-r-plus-104b", "train_4k", 2, 2,
                                     batch=8,
                                     config_overrides=dict(n_layers=2))
    args = cost.argument_bytes
    assert abs(args - n * (4 + 1 + 2) / 4) < 0.01 * args
    peak = roof.fit_check(roof.roofline_from_counts(cost), roof.HW)[1]
    assert args < peak < 75e9
    assert n * 13 > 120e9


def dataclasses_replace_layers(cfg, n):
    import dataclasses

    return dataclasses.replace(cfg, n_layers=n)


@pytest.mark.parametrize("spec", [("data", "model"), ("model", "data"),
                                  ("model", None), (None, "data")],
                         ids=["dm", "md", "m-", "-d"])
@pytest.mark.parametrize("shape", [(8, 12), (5, 7)], ids=["even", "padded"])
def test_norm_and_update_by_blocks_cover_2d_and_padded_blocks(spec, shape,
                                                             monkeypatch):
    """``optimizer.global_norm`` and ``update`` with a mesh and specs on a
    stacked 2 x 4 mesh: the distinct blocks (``distinct_blocks``) of a 2-D
    leaf, zero padded where the axes do not divide it, cover every
    element once, so the norm is the whole's (integer squares: exact in
    any order), and the update walked in blocks of rows
    (``leaf_blocks``, cut to 2 rows) is the update without a mesh."""
    from repro_torch.training import optimizer as topt

    mesh = ShardMesh(2, 4, device="cpu")
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.integers(1, 9, shape).astype(np.float32))
    specs = {"w": tsh.P(*spec)}
    blocks = tsh.shard(x, specs["w"], mesh)
    seen = sum(int((blocks[d, m] != 0).sum())
               for d, m in tsh.distinct_blocks(specs["w"], mesh))
    assert seen == x.numel()
    assert float(topt.global_norm({"w": x}, mesh=mesh, specs=specs)) == \
        float(topt.global_norm({"w": x}))
    monkeypatch.setattr(topt, "UPDATE_ROWS", 2)
    cfg = topt.AdamWConfig(grad_clip=1e-3)
    outs = []
    for kw in (dict(mesh=mesh, specs=specs), {}):
        p = {"w": x.clone()}
        g = {"w": x.flip(0).clone() * 0.5}
        p, st, m = topt.update(cfg, g, topt.init(cfg, p), p, **kw)
        outs.append((p["w"], st.mu["w"], st.nu["w"], m["grad_norm"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
