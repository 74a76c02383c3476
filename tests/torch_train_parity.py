"""Helpers of the train-step parity tests (``tests/test_torch_train_steps.py``,
``tests/test_torch_training.py``, ``tests/test_torch_gcn.py``): run the
port's and the JAX package's train steps side by side from the same
parameters and batches and hold them to the rules those tests state."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.distributed import compression as jcomp
from repro.launch import steps as jsteps
from repro.models import gcn as jgcn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.models.recsys import dcn as jdcn
from repro.models.recsys import dlrm as jdlrm
from repro.models.recsys import mind as jmind
from repro.models.recsys import sasrec as jsasrec
from repro.training import train_loop as jtl
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed import compression as tcomp
from repro_torch.launch import steps
from repro_torch.models import transformer as ttfm
from repro_torch.models.recsys import dcn as tdcn
from repro_torch.models.recsys import dlrm as tdlrm
from repro_torch.models.recsys import mind as tmind
from repro_torch.models.recsys import sasrec as tsasrec
from repro_torch.training import train_loop as ttl
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

CELLS = {"dlrm-rm2": "train_batch", "dcn-v2": "train_batch",
         "sasrec": "train_batch", "mind": "train_batch",
         "smollm-135m": "train_4k"}
LOSSES = {"dlrm-rm2": (jdlrm.loss_fn, tdlrm.loss_fn),
          "dcn-v2": (jdcn.loss_fn, tdcn.loss_fn),
          "sasrec": (jsasrec.loss_fn, tsasrec.loss_fn),
          "mind": (jmind.loss_fn, tmind.loss_fn),
          "smollm-135m": (jtfm.loss_fn, ttfm.loss_fn)}
# gcn-cora's cells: each shape assembles its own config, and the
# minibatch bundle's loss is a closure over the batch's block keys
GNN_CELLS = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
STEPS = 3


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        if x.dtype == jnp.bfloat16 else np.asarray(x), tree)


def _t(tree):
    return convert.params_from_arrays(_np(tree), device="cpu")


def _leaves_np(tree):
    return [np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)
            for x in tree_leaves(tree)]


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _configs(arch, overrides):
    jcfg = jget_arch(arch).reduced
    tcfg = get_arch(arch).reduced
    if overrides:
        tcfg = dataclasses.replace(tcfg, **overrides)
        jcfg = dataclasses.replace(jcfg, **{
            k: JDT.get(v, v) if k == "compute_dtype" else v
            for k, v in overrides.items()})
    return jcfg, tcfg


def gnn_losses(shape_name):
    """``(jloss, tloss)`` of gcn-cora's reduced ``shape_name`` cell: the
    loss each package's bundle trains (the reference's minibatch loss is a
    closure of its ``_gnn_bundle``, written out here; the port's bundle
    names its loss)."""
    jarch = jget_arch("gcn-cora")
    jshape = jsteps.reduce_shape(jarch, jarch.shape(shape_name))
    jcfg = jsteps._gnn_cfg(jarch.reduced, jshape, True)
    tloss = steps.build("gcn-cora", shape_name, reduced=True,
                        device="cpu").loss_fn
    if jshape.kind != "gnn_minibatch":
        return functools.partial(jgcn.loss_full, jcfg), tloss
    seeds = jshape.extra["batch_nodes"]
    n1 = seeds * (1 + jshape.extra["fanout"][0])

    def jloss(p, b):
        blocks = [dict(edge_src=b["e1_src"], edge_dst=b["e1_dst"],
                       edge_mask=b["e1_mask"], n_dst=seeds),
                  dict(edge_src=b["e2_src"], edge_dst=b["e2_dst"],
                       edge_mask=b["e2_mask"], n_dst=n1)]
        logits = jgcn.forward_sampled(jcfg, p, [None, b["feats"]], blocks)
        return jlayers.softmax_cross_entropy(logits, b["labels"])

    return jloss, tloss


def run_against_reference(arch, *, shape=None, overrides=None,
                          microbatches=1, compress=None, eager=False,
                          tol=1e-5, seed=0):
    """3 train steps of ``arch``'s reduced config on both sides, held
    to the rules of ``tests/test_torch_train_steps.py``.  ``shape`` names
    the cell of an arch with several (gcn-cora), whose steps are its two
    bundles' own ``step_fn``."""
    shape = shape or CELLS[arch]
    opt_j, opt_t = jsteps.SMOKE_OPT, steps.SMOKE_OPT
    if arch == "gcn-cora":
        jloss, tloss = gnn_losses(shape)
    else:
        jcfg, tcfg = _configs(arch, overrides)
        jloss_fn, tloss_fn = LOSSES[arch]
        jloss = functools.partial(jloss_fn, jcfg)
        tloss = functools.partial(tloss_fn, tcfg)
    jtransform = ttransform = None
    if compress:
        ccfg_j = jcomp.CompressionConfig(method=compress)
        ccfg_t = tcomp.CompressionConfig(method=compress)
        jtransform = lambda g: jcomp.compress(  # noqa: E731
            ccfg_j, g, jcomp.init(g))[0]
        ttransform = lambda g: tcomp.compress(  # noqa: E731
            ccfg_t, g, tcomp.init(g))[0]
    jstep = jtl.make_train_step(jloss, opt_j, microbatches=microbatches,
                                grad_transform=jtransform)
    tstep = ttl.make_train_step(tloss, opt_t, microbatches=microbatches,
                                grad_transform=ttransform)
    bundle = jsteps.build(jget_arch(arch), shape, reduced=True)
    if arch == "gcn-cora":
        jstep = bundle.step_fn
        tstep = steps.build(arch, shape, reduced=True, device="cpu").step_fn
    jparams = bundle.init_fn(jax.random.PRNGKey(seed))
    if not eager:
        jstep = jax.jit(jstep)
    jstate = jtl.init_state(opt_j, jparams)
    tparams = _t(jparams)
    tstate = ttl.init_state(opt_t, tparams)
    grads_of = ttl.value_and_grad(tloss)

    def jgrads(p, b):
        return jax.value_and_grad(
            lambda q: (lambda o: o[0] if isinstance(o, tuple) else o)(
                jloss(q, b)))(p)

    if not eager:
        jgrads = jax.jit(jgrads)

    noisy = [np.zeros(x.shape, bool) for x in _jleaves(jparams)]
    allowance = 0.0
    for s in range(STEPS):
        jbatch = bundle.make_batch(jax.random.PRNGKey(100 + s))
        tbatch = _t(jbatch)
        with jax.disable_jit() if eager else contextlib.nullcontext():
            jl, jg = jgrads(jparams, jbatch)
            jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        tl, _, tg = grads_of(tparams, tbatch)
        tparams, tstate, tm = tstep(tparams, tstate, tbatch)
        assert float(tl) == pytest.approx(float(jl), rel=tol, abs=1e-7)
        for k in ("loss", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=tol,
                                                 abs=1e-7), k
        lr = float(jm["lr"])
        assert abs(float(tm["lr"]) - lr) <= 2 * np.spacing(np.float32(lr))
        for i, (a, b) in enumerate(zip(_leaves_np(tg), _jleaves(jg))):
            scale = max(float(np.linalg.norm(b)), 1e-30)
            assert float(np.linalg.norm(a - b)) <= tol * scale, (s, i)
            noisy[i] |= np.abs(b) < max(1e-6, tol) * np.abs(b).max()
        allowance += 2 * lr
        for i, (a, b) in enumerate(zip(_leaves_np(tparams),
                                       _jleaves(jparams))):
            limit = np.where(noisy[i], 1e-5 + allowance, 1e-5)
            if tol > 1e-5:
                limit = limit + tol * np.abs(b).max() * lr * STEPS
            assert np.all(np.abs(a - b) <= limit), (s, i, np.abs(a - b).max())
        assert int(tstate.step) == int(jstate.step) == s + 1
    for a, b in zip(_leaves_np(tstate.mu), _jleaves(jstate.mu)):
        assert a.shape == b.shape
    return tparams, tstate


