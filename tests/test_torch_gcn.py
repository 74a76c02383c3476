"""gcn-cora in the port (``repro_torch.models.gcn``, ``graphs/sampler.py``,
``graphs/partition.py``, ``graphs/synthetic.batched_molecules``, the GNN
bundles of ``launch/steps.py``) against the JAX package on the CPU.

* Host numpy (the partitioner, ``batched_molecules``, the fanout and PPR
  samplers): equal, bit for bit.
* The model in f32 at ``_reduce_gnn_shape``'s sizes: within 1e-5 (values
  relative to the largest, gradients of each leaf's norm): the bag sums run
  over :func:`~repro_torch.models.gcn.segment_bags`' layout, the reference's
  ``segment_sum`` over the edge list.
* The four bundles: ``batch_spec`` and FLOPs equal the reference's at full
  size, and 3 train steps match its jitted step under
  ``tests/torch_train_parity.py``'s rules.

Inputs come from a numpy seed or from the reference's own ``make_batch``,
moved across through numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.graphs import partition as jpart
from repro.graphs import sampler as jsamp
from repro.graphs import synthetic as jsyn
from repro.launch import steps as jsteps
from repro.models import gcn as jgcn
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.graphs import partition as tpart
from repro_torch.graphs import sampler as tsamp
from repro_torch.graphs import synthetic as tsyn
from repro_torch.launch import steps
from repro_torch.launch import train as ttrain
from repro_torch.models import gcn as tgcn
from repro_torch.training import train_loop as ttl
from repro_torch.tree import tree_leaves
from torch_train_parity import GNN_CELLS, run_against_reference

torch.set_num_threads(1)
TOL = 1e-5
DT = {"float32": torch.float32, "int32": torch.int32}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _tree_t(tree):
    return convert.params_from_arrays(jax.tree.map(np.asarray, tree),
                                      device="cpu")


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _grads_close(tgrads, jgrads, tol=TOL):
    for a, b in zip(tree_leaves(tgrads), jax.tree.leaves(jgrads)):
        b = np.asarray(b)
        scale = max(float(np.linalg.norm(b)), 1e-30)
        assert float(np.linalg.norm(a.numpy() - b)) <= tol * scale


def _value_and_grads(jloss, tloss, jparams, jbatch, tbatch):
    jl, jg = jax.value_and_grad(jloss)(jparams, jbatch)
    tl, _, tg = ttl.value_and_grad(tloss)(_tree_t(jparams), tbatch)
    assert float(tl) == pytest.approx(float(jl), rel=TOL, abs=1e-7)
    _grads_close(tg, jg)


# rmat(10), and the reference's partitioner test graph
GRAPHS = {"rmat10": dict(n_log2=10, avg_deg=8.0, seed=1),
          "rmat11_skew": dict(n_log2=11, avg_deg=16.0, seed=3)}


# -- host numpy: bit for bit --------------------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_partition_equals_reference(graph, parts):
    kw = GRAPHS[graph]
    jg = jsyn.rmat(**kw)
    tg = tsyn.rmat(**kw, device="cpu")
    for fn in ("vertex_intervals", "edge_balanced_intervals"):
        want = getattr(jpart, fn)(jg, parts)
        got = getattr(tpart, fn)(tg, parts)
        assert [(i.lo, i.hi, i.edges, i.size) for i in got] == \
            [(i.lo, i.hi, i.edges, i.size) for i in want]
        assert tpart.balance_stats(got) == jpart.balance_stats(want)
    srcs = np.arange(tg.n)[::7]
    for a, b in zip(tpart.assign_sources_to_shards(srcs, parts),
                    jpart.assign_sources_to_shards(srcs, parts)):
        assert np.array_equal(a, b)


def test_edge_balanced_beats_vertex_balanced_on_skew():
    """The reference's own partitioner test (``tests/test_runtime.py``)."""
    g = tsyn.rmat(11, avg_deg=16.0, seed=3, device="cpu")
    _, v_imb = tpart.balance_stats(tpart.vertex_intervals(g, 8))
    e_parts = tpart.edge_balanced_intervals(g, 8)
    assert tpart.balance_stats(e_parts)[1] <= v_imb
    assert sum(p.size for p in e_parts) == g.n


@pytest.mark.parametrize("args", [(4, 30, 64, 0), (7, 5, 3, 2), (1, 2, 1, 9)])
def test_batched_molecules_equal_reference(args):
    jg = jsyn.batched_molecules(*args)
    tg = tsyn.batched_molecules(*args, device="cpu")
    assert (tg.n, tg.m) == (jg.n, jg.m)
    for name in ("row_ptr", "col_idx", "src", "out_deg"):
        assert np.array_equal(getattr(tg, name).numpy(),
                              np.asarray(getattr(jg, name)))


@pytest.mark.parametrize("fanouts,seed,step",
                         [((3, 2), 0, 0), ((15, 10), 4, 7), ((5,), 1, 2)])
def test_fanout_sample_equals_reference(fanouts, seed, step):
    kw = dict(n_log2=10, avg_deg=4.0, seed=2)
    jg, tg = jsyn.rmat(**kw), tsyn.rmat(**kw, device="cpu")
    # seeds include vertices with no out-edge (their samples are masked)
    seeds = np.concatenate([np.flatnonzero(tg.out_deg.numpy() == 0)[:3],
                            np.arange(0, tg.n, 97)])
    want = jsamp.fanout_sample(jg, seeds, fanouts, seed=seed, step=step)
    got = tsamp.fanout_sample(tg, seeds, fanouts, seed=seed, step=step)
    assert len(got) == len(want) == len(fanouts)
    assert any(float(b.edge_mask.min()) == 0.0 for b in got)
    for a, b in zip(got, want):
        for name in ("nodes", "edge_src", "edge_dst", "edge_mask"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("budget", [4, 16, 40])
def test_ppr_importance_sample_equals_reference_on_ties(budget):
    """Integer-count values tie often: numpy's argsort order is kept."""
    r = np.random.default_rng(5)
    vals = (r.integers(0, 4, (300, 32)) / 100).astype(np.float32)
    vals[7] = 0.0                                   # an all-zero row
    idx = r.integers(0, 300, (300, 32)).astype(np.int32)
    seeds = r.integers(0, 300, 50)
    seeds[0] = 7
    want = jsamp.ppr_importance_sample(vals, idx, seeds, budget)
    got = tsamp.ppr_importance_sample(vals, idx, seeds, budget)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# -- the model: within 1e-5 ---------------------------------------------------

def _edges(r, n, m, n_src=None):
    """Edges with duplicates, self loops, masked edges and rows of
    in-degree 0 (destinations drawn from the first half of the rows)."""
    n_src = n_src or n
    src = r.integers(0, n_src, m).astype(np.int32)
    dst = r.integers(0, n // 2, m).astype(np.int32)
    src[:5], dst[:5] = 3, 3                        # a self loop, repeated
    src[5:8], dst[5:8] = 1, 2                      # a duplicate edge
    mask = (r.random(m) < 0.8).astype(np.float32)
    return src, dst, mask


@pytest.mark.parametrize("d", [1, 5, 16])
def test_segment_bags_embedding_bag_equal_segment_sum(d):
    r = np.random.default_rng(d)
    n, n_src, m = 40, 57, 300
    src, dst, mask = _edges(r, n, m, n_src)
    w = (r.random(m) * mask).astype(np.float32)
    h = r.standard_normal((n_src, d)).astype(np.float32)
    g = r.standard_normal((n, d)).astype(np.float32)
    ids, wb = tgcn.segment_bags(_t(src), _t(dst), _t(w), n, n_src=n_src)
    counts = np.bincount(dst, minlength=n)
    assert ids.shape == wb.shape == (n, counts.max())
    assert int((wb != 0).sum()) == int((w != 0).sum())
    pad = torch.arange(ids.shape[1])[None, :] >= _t(counts)[:, None]
    assert bool((wb[pad] == 0).all())               # padding weighs 0 ...
    assert torch.equal(ids[pad], (torch.arange(n)[:, None] % n_src).expand(
        n, ids.shape[1])[pad])                       # ... at its own row

    def jagg(hh):
        msgs = jnp.take(hh, jnp.asarray(src), axis=0) * jnp.asarray(w)[:, None]
        return jax.ops.segment_sum(msgs, jnp.asarray(dst), num_segments=n)

    th = _t(h).requires_grad_(True)
    out = tgcn.aggregate(ids, wb, th)
    _close(out, jagg(jnp.asarray(h)))
    (grad,) = torch.autograd.grad(out, th, _t(g))
    jgrad = jax.grad(lambda hh: jnp.sum(jagg(hh) * g))(jnp.asarray(h))
    _close(grad, jgrad)


def test_segment_bags_rejects_a_destination_out_of_range():
    with pytest.raises(ValueError, match="outside"):
        tgcn.segment_bags(_t(np.array([0, 1], np.int32)),
                          _t(np.array([0, 5], np.int32)), None, 4)


def test_sym_norm_coeffs_match_reference():
    r = np.random.default_rng(1)
    src, dst, mask = _edges(r, 50, 400)
    for m in (None, mask):
        want = jgcn.sym_norm_coeffs(jnp.asarray(src), jnp.asarray(dst), 50,
                                    None if m is None else jnp.asarray(m))
        got = tgcn.sym_norm_coeffs(_t(src), _t(dst), 50,
                                   None if m is None else _t(m))
        for a, b in zip(got, want):
            _close(a, b)


def _cfgs(kind, aggregator=None):
    jarch, tarch = jget_arch("gcn-cora"), get_arch("gcn-cora")
    shape = {"gnn_full": "full_graph_sm", "gnn_minibatch": "minibatch_lg",
             "gnn_batched": "molecule"}[kind]
    js = jsteps.reduce_shape(jarch, jarch.shape(shape))
    jcfg = jsteps._gnn_cfg(jarch.reduced, js, True)
    tcfg = steps._gnn_cfg(tarch.reduced, steps.reduce_shape(
        tarch, tarch.shape(shape)))
    if aggregator:
        jcfg = dataclasses.replace(jcfg, aggregator=aggregator)
        tcfg = dataclasses.replace(tcfg, aggregator=aggregator)
    return jcfg, tcfg, jsteps.build(jarch, shape, reduced=True)


@pytest.mark.parametrize("aggregator", ["sym", "mean"])
def test_forward_full_and_loss_match_reference(aggregator):
    jcfg, tcfg, jb = _cfgs("gnn_full", aggregator)
    jparams = jgcn.init(jcfg, jax.random.PRNGKey(3))
    jbatch = jb.make_batch(jax.random.PRNGKey(4))
    tbatch = _tree_t(jbatch)
    keys = ("features", "edge_src", "edge_dst", "edge_mask")
    want = jgcn.forward_full(jcfg, jparams, *(jbatch[k] for k in keys))
    got = tgcn.forward_full(tcfg, _tree_t(jparams), *(tbatch[k] for k in keys))
    _close(got, want)
    _value_and_grads(lambda p, b: jgcn.loss_full(jcfg, p, b),
                     lambda p, b: tgcn.loss_full(tcfg, p, b),
                     jparams, jbatch, tbatch)


def test_loss_full_with_the_mean_readout_matches_reference():
    jcfg, tcfg, jb = _cfgs("gnn_batched")
    assert tcfg.readout == "mean" and tcfg.aggregator == "mean"
    jparams = jgcn.init(jcfg, jax.random.PRNGKey(5))
    jbatch = jb.make_batch(jax.random.PRNGKey(6))
    _value_and_grads(lambda p, b: jgcn.loss_full(jcfg, p, b),
                     lambda p, b: tgcn.loss_full(tcfg, p, b),
                     jparams, jbatch, _tree_t(jbatch))


def test_forward_sampled_and_loss_match_reference_on_sampled_blocks():
    """Blocks from the fanout sampler (masked edges at seeds with no
    out-edge), the reference's ``loss_sampled`` batch layout."""
    jcfg, tcfg, _ = _cfgs("gnn_minibatch")
    kw = dict(n_log2=9, avg_deg=3.0, seed=4)
    tg = tsyn.rmat(**kw, device="cpu")
    r = np.random.default_rng(2)
    seeds = np.concatenate([np.flatnonzero(tg.out_deg.numpy() == 0)[:2],
                            r.integers(0, tg.n, 6)])
    blocks = tsamp.fanout_sample(tg, seeds, (3, 2), seed=1)
    feats = r.standard_normal((tg.n, jcfg.d_feat)).astype(np.float32)
    n_dst = [len(seeds), len(blocks[0].nodes)]
    labels = r.integers(0, jcfg.n_classes, len(seeds)).astype(np.int32)

    def batch(conv):
        return dict(
            block_feats=[conv(feats[blocks[0].nodes]),
                         conv(feats[blocks[-1].nodes])],
            block_edges=[dict(edge_src=conv(b.edge_src),
                              edge_dst=conv(b.edge_dst),
                              edge_mask=conv(b.edge_mask), n_dst=k)
                         for b, k in zip(blocks, n_dst)],
            labels=conv(labels))

    jbatch, tbatch = batch(jnp.asarray), batch(_t)
    jparams = jgcn.init(jcfg, jax.random.PRNGKey(7))
    _close(tgcn.forward_sampled(tcfg, _tree_t(jparams), tbatch["block_feats"],
                                tbatch["block_edges"]),
           jgcn.forward_sampled(jcfg, jparams, jbatch["block_feats"],
                                jbatch["block_edges"]))
    _value_and_grads(lambda p, b: jgcn.loss_sampled(jcfg, p, b),
                     lambda p, b: tgcn.loss_sampled(tcfg, p, b),
                     jparams, jbatch, tbatch)


def test_ppr_propagate_and_loss_ppr_match_reference():
    """The path of ``examples/gnn_ppr.py``: the PPR sampler's neighbours
    and weights, then the MLP and one PPR-weighted aggregation."""
    jcfg, tcfg, _ = _cfgs("gnn_full")
    r = np.random.default_rng(3)
    n, l = 200, 24
    vals = (r.integers(0, 6, (n, l)) / 50).astype(np.float32)
    idx = r.integers(0, n, (n, l)).astype(np.int32)
    seeds = r.integers(0, n, 32)
    nbr, w = tsamp.ppr_importance_sample(vals, idx, seeds, 16)
    feats = r.standard_normal((n, jcfg.d_feat)).astype(np.float32)
    labels = r.integers(0, jcfg.n_classes, len(seeds)).astype(np.int32)
    h = r.standard_normal((n, 7)).astype(np.float32)
    _close(tgcn.ppr_propagate(_t(h), _t(w), _t(nbr)),
           jgcn.ppr_propagate(jnp.asarray(h), jnp.asarray(w),
                              jnp.asarray(nbr)))
    jbatch = dict(feats=jnp.asarray(feats), ppr_vals=jnp.asarray(w),
                  ppr_idx=jnp.asarray(nbr), labels=jnp.asarray(labels))
    jparams = jgcn.init(jcfg, jax.random.PRNGKey(8))
    _value_and_grads(lambda p, b: jgcn.loss_ppr(jcfg, p, b),
                     lambda p, b: tgcn.loss_ppr(tcfg, p, b),
                     jparams, jbatch, _tree_t(jbatch))


def test_init_and_convert_carry_the_reference_parameters():
    """``params_from_arrays`` carries ``{layer_i: {w, b}}`` unchanged; the
    port's own ``init`` has the same tree, shapes and parameter count."""
    jcfg, tcfg, _ = _cfgs("gnn_full")
    tree = jax.tree.map(np.asarray, jgcn.init(jcfg, jax.random.PRNGKey(1)))
    got = convert.params_from_arrays(tree, device="cpu")
    mine = tgcn.init(tcfg, 0, device="cpu")
    assert sorted(got) == sorted(mine) == [f"layer_{i}"
                                           for i in range(tcfg.n_layers)]
    for k, layer in tree.items():
        for name, want in layer.items():
            assert got[k][name].dtype == torch.float32
            assert np.array_equal(got[k][name].numpy(), want)
            assert mine[k][name].shape == want.shape
    assert tcfg.param_count() == jcfg.param_count() == sum(
        x.size for x in jax.tree.leaves(tree))


# -- the bundles --------------------------------------------------------------

@pytest.mark.parametrize("shape", GNN_CELLS)
def test_gnn_bundle_specs_and_flops_match_reference(shape):
    """At full size (nothing allocated) and reduced."""
    for reduced in (False, True):
        jb = jsteps.build(jget_arch("gcn-cora"), shape, reduced=reduced)
        tb = steps.build("gcn-cora", shape, reduced=reduced, device="cpu")
        assert tb.kind == jb.kind == "train"
        assert {k: (tuple(v.shape), DT[jnp.dtype(v.dtype).name])
                for k, v in jb.batch_spec.items()} == tb.batch_spec
        assert tb.model_flops_per_step == jb.model_flops_per_step
        assert tb.opt_cfg == (steps.SMOKE_OPT if reduced
                              else steps.DEFAULT_OPT)


@pytest.mark.parametrize("shape", GNN_CELLS)
def test_gnn_make_batch_keeps_the_reference_distributions(shape):
    tb = steps.build("gcn-cora", shape, reduced=True, device="cpu")
    x = steps.reduce_shape(get_arch("gcn-cora"),
                           get_arch("gcn-cora").shape(shape)).extra
    b = tb.make_batch(torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == \
        tb.batch_spec
    kind = get_arch("gcn-cora").shape(shape).kind
    if kind == "gnn_full":
        n_real, m_real = x["n_nodes"], x["n_edges"]
        for k in ("edge_src", "edge_dst"):
            assert 0 <= int(b[k].min()) and int(b[k].max()) < n_real
        assert torch.equal(b["edge_mask"], (torch.arange(
            b["edge_mask"].numel()) < m_real).float())
        assert torch.equal(b["label_mask"], (torch.arange(
            b["label_mask"].numel()) < n_real).float())
    elif kind == "gnn_minibatch":
        seeds = x["batch_nodes"]
        n1 = seeds * (1 + x["fanout"][0])
        assert int(b["e2_dst"].max()) < n1 and int(b["e1_dst"].max()) < seeds
        assert int(b["e1_src"].max()) < n1
        assert int(b["e2_src"].max()) < b["feats"].shape[0]
    else:
        npg = x["n_nodes"]
        g_src = b["edge_src"] // npg
        assert torch.equal(g_src, b["edge_dst"] // npg)   # block-diagonal
        assert torch.equal(g_src, torch.repeat_interleave(
            torch.arange(x["batch"]), 2 * x["n_edges"]).to(torch.int32))
        assert torch.equal(b["graph_ids"], torch.repeat_interleave(
            torch.arange(x["batch"]), npg).to(torch.int32))


@pytest.mark.parametrize("shape", GNN_CELLS)
def test_gnn_train_steps_match_reference(shape):
    run_against_reference("gcn-cora", shape=shape)


def test_launcher_trains_gcn_and_resumes_bit_equal(tmp_path):
    """``launch/train.py`` on ``full_graph_sm`` reduced: 6 steps with a
    commit every 2 and a failure at step 3 end with the bytes of an
    uninterrupted run."""
    def final(tmp, **kw):
        bundle = steps.build("gcn-cora", "full_graph_sm", reduced=True,
                             device="cpu")
        params, state, info = ttrain.run(bundle, steps=6, ckpt_dir=str(tmp),
                                         ckpt_every=2, log=lambda s: None,
                                         **kw)
        return tree_leaves((params, state)), info

    want, _ = final(tmp_path / "a")
    got, info = final(tmp_path / "b", simulate_failure=3)
    assert info["restored_at_failure"] == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
