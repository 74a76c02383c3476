"""The port's MoE FFN and the four large LMs (``qwen1.5-32b``,
``command-r-plus-104b``, ``dbrx-132b``, ``grok-1-314b``) against the JAX
package, on the CPU, at the reference's reduced configs.

Parameters come from the reference's ``init`` carried across by
``convert.params_from_arrays``; inputs from numpy seeds.  The routing
(top experts, each slot's place in its expert's queue, which slots stay
within the capacity) must be equal; outputs agree to 1e-5 in f32 and
3e-2 in bf16 (the zoo's bars, ``tests/test_torch_lm.py``; the bf16
reference runs eagerly, op by op), the aux loss to 1e-6 relative,
gradients to 1e-5 of each leaf's norm.  The stacked 2 x 2
expert-parallel path is held against the reference's ``shard_map`` on
four fake host devices, in a subprocess (this file run as a script): its
outputs, and ``loss_fn(mesh=)``'s gradients against ``jax.grad`` through
``shard_map`` (the mesh's own gradients: the aux loss is each data
shard's, averaged, so they are not the one-device ones), and one
``make_train_step(mesh=)`` step against the reference's
``make_train_step(..., grad_pspecs=)`` jitted under the mesh, with the
large MoE LMs' published rules (fp8 ``mu``, bf16 ``nu``, a bf16
accumulator over two microbatches).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import transformer as jtfm
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    from repro_torch.distributed import ShardMesh
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import layers as tL
    from repro_torch.models import transformer as ttfm
    from repro_torch.training import train_loop as ttl
    from repro_torch.tree import tree_leaves

LMS = ("dbrx-132b", "grok-1-314b", "qwen1.5-32b", "command-r-plus-104b")
MOE_ARCHS = ("dbrx-132b", "grok-1-314b")
TOL = {"f32": 1e-5, "bf16": 3e-2}
TOKENS = 64
# ffn cases: (arch, MoEConfig overrides, other config overrides).
# "reference_drop" is the reference's tests/test_models.py dropping
# config; "dbrx_cf1" is dbrx reduced at capacity 1.0, where slots drop.
FFN_CASES = {
    "dbrx": ("dbrx-132b", {}, {}),
    "grok": ("grok-1-314b", {}, {}),
    "dbrx_cf1": ("dbrx-132b", dict(capacity_factor=1.0), {}),
    "reference_drop": ("dbrx-132b", dict(n_experts=2, top_k=2,
                                         capacity_factor=1.0),
                       dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                            d_ff=32, vocab=50, attn_chunk=8)),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, dt):
    want = _np(want)
    assert tuple(got.shape) == want.shape
    scale = min(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dt],
                               atol=TOL[dt] * scale)


def _configs(case, dt="f32"):
    arch, moe_over, over = FFN_CASES[case]
    dts = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    out = []
    for i, reg in enumerate((jconfigs, tconfigs)):
        cfg = reg.get_arch(arch).reduced
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_over),
            compute_dtype=dts[i], **over)
        out.append(cfg)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _params(arch, case=None):
    """The reference's parameters (its reduced config, or a case's) as
    JAX arrays and as the port's copy; zero biases and unit norm scales
    made random, so each changes the output."""
    jc = _configs(case)[0] if case else jconfigs.get_arch(arch).reduced
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jtfm.init, jc))(jax.random.PRNGKey(0)))
    r = np.random.default_rng(1)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'b'" in name:
            return (0.1 * r.standard_normal(leaf.shape)).astype(np.float32)
        if "'scale'" in name:
            return (1.0 + 0.1 * r.standard_normal(leaf.shape)).astype(
                np.float32)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_from_arrays(tree, device="cpu"))


def _layer0(case):
    """The first layer's parameters of a case, the reference's and the
    port's."""
    jp, tp = _params(FFN_CASES[case][0], case)
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            ttfm._unbound(tp["layers"], 1)[0])


def _x(d, t=TOKENS, seed=2):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _ref_route(cfg, router_w, x):
    """The reference ``_moe_ffn``'s routing, its lines as written:
    ``top_e``, and in the sorted slot order ``se``, ``stok``, ``pos`` and
    ``keep``."""
    moe = cfg.moe
    t = x.shape[0]
    split, k = moe.ep_split, moe.top_k
    e_virt, kv = moe.n_experts * split, k * split
    cap = max(int(t * kv * moe.capacity_factor / e_virt), 1)
    gates = jax.nn.softmax(x.astype(jnp.float32) @ router_w, axis=-1)
    _, top_e = jax.lax.top_k(gates, k)
    offs = jnp.arange(split, dtype=top_e.dtype)
    flat_e = (top_e[:, :, None] * split + offs).reshape(-1)
    flat_tok = jnp.broadcast_to(jnp.arange(t)[:, None, None],
                                (t, k, split)).reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se, stok = flat_e[order], flat_tok[order]
    counts = jnp.zeros((e_virt,), jnp.int32).at[se].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(t * kv, dtype=jnp.int32) - starts[se]
    return dict(top_e=top_e, se=se, stok=stok, pos=pos, keep=pos < cap)


# -- the FFN --------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_routing_matches_reference(case):
    """The top experts (lower first on ties), the sorted slots' experts and
    tokens, each slot's place in its queue and which slots are kept."""
    jc, tc = _configs(case)
    jl, tl = _layer0(case)
    x = _x(jc.d_model)
    want = _ref_route(jc, jl["router"]["w"], jnp.asarray(x))
    got = ttfm._moe_route(tc.moe, tl["router"]["w"], torch.from_numpy(x))
    for name in ("top_e", "se", "stok", "pos", "keep"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(want[name])), name
    if case == "dbrx_cf1":
        assert not bool(got.keep.all())
    assert int(got.counts.sum()) == TOKENS * tc.moe.top_k * tc.moe.ep_split


def test_moe_top_k_keeps_the_lower_expert_on_ties():
    """Equal gates: ``jax.lax.top_k``'s order, lower expert first."""
    jc, tc = _configs("dbrx")
    x = np.zeros((3, jc.d_model), np.float32)       # every gate 1 / E
    w = np.random.default_rng(3).standard_normal(
        (jc.d_model, jc.moe.n_experts)).astype(np.float32)
    want = _ref_route(jc, jnp.asarray(w), jnp.asarray(x))
    got = ttfm._moe_route(tc.moe, torch.from_numpy(w), torch.from_numpy(x))
    assert np.array_equal(got.top_e.numpy(), np.asarray(want["top_e"]))
    assert got.top_e.tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference(case, dt):
    """``_moe_ffn`` of one layer on ``[64, d]`` tokens in the compute
    dtype: the output, and the aux loss to 1e-6 relative."""
    jc, tc = _configs(case, dt)
    jl, tl = _layer0(case)
    x = _x(jc.d_model)
    xj = jnp.asarray(x).astype(jc.compute_dtype)
    fn = functools.partial(jtfm._moe_ffn, jc)
    if dt == "f32":
        want, waux = jax.jit(fn)(jl, xj)
    else:
        with jax.disable_jit():
            want, waux = fn(jl, xj)
    got, aux = ttfm._moe_ffn(tc, tl, torch.from_numpy(x).to(
        tc.compute_dtype))
    assert got.dtype == tc.compute_dtype and aux.dtype == torch.float32
    _close(got, want, dt)
    assert float(aux) == pytest.approx(float(waux), rel=1e-6)


def test_moe_combine_is_deterministic_and_uses_no_scatter_add(monkeypatch):
    """Two runs give the same bytes, and the combine calls neither
    ``index_add_`` nor an accumulating ``index_put_`` (no float atomics
    on the card)."""
    _, tc = _configs("grok", "bf16")
    _, tl = _layer0("grok")
    x = torch.from_numpy(_x(tc.d_model)).to(torch.bfloat16)
    calls = []
    for name in ("index_add_", "index_add", "index_put_", "index_put"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    a, _ = ttfm._moe_ffn(tc, tl, x)
    b, _ = ttfm._moe_ffn(tc, tl, x)
    assert not calls
    assert a.view(torch.int16).equal(b.view(torch.int16))


# -- the whole model ------------------------------------------------------------

def _overrides(dt="f32", **extra):
    dts = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    return tuple(dict(compute_dtype=dts[i], **extra) for i in (0, 1))


@pytest.mark.parametrize("arch", LMS)
def test_prefill_bundle_matches_reference(arch):
    """The reduced ``prefill_32k`` bundle's last-position logits, in f32."""
    jo, to = _overrides()
    want_b = jsteps.build(jconfigs.get_arch(arch), "prefill_32k",
                          reduced=True, config_overrides=jo)
    got_b = steps.build(arch, "prefill_32k", reduced=True, device="cpu",
                        config_overrides=to)
    jp, tp = _params(arch)
    vocab = tconfigs.get_arch(arch).reduced.vocab
    toks = np.random.default_rng(3).integers(0, vocab, (2, 64)).astype(
        np.int32)
    want = jax.jit(want_b.step_fn)(jp, {"tokens": jnp.asarray(toks)})
    got = got_b.step_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, vocab)
    _close(got, want, "f32")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", LMS)
def test_decode_steps_match_reference(arch, kv_quant):
    """Ten ``decode_32k`` steps of the reduced bundles from empty caches,
    in f32 (the int8 cache with its bf16 scales too): each step's
    logits."""
    jo, to = _overrides(kv_quant=kv_quant)
    want_b = jsteps.build(jconfigs.get_arch(arch), "decode_32k",
                          reduced=True, config_overrides=jo)
    got_b = steps.build(arch, "decode_32k", reduced=True, device="cpu",
                        config_overrides=to)
    assert ("k_scale" in got_b.cache_spec) == kv_quant
    jp, tp = _params(arch)
    jcache = {k: jnp.zeros(v.shape, v.dtype)
              for k, v in want_b.cache_spec.items()}
    tcache = got_b.make_cache()
    vocab = tconfigs.get_arch(arch).reduced.vocab
    toks = np.random.default_rng(4).integers(0, vocab, (10, 2, 1)).astype(
        np.int32)
    ref_step = jax.jit(want_b.step_fn)
    for t in range(10):
        want, jcache = ref_step(jp, jcache, {"tokens": jnp.asarray(toks[t])})
        got, tcache = got_b.step_fn(tp, tcache,
                                    {"tokens": torch.from_numpy(toks[t])})
        _close(got, want, "f32")
    assert int(tcache["length"]) == int(jcache["length"]) == 10


def _batch(vocab, seed=5):
    toks = np.random.default_rng(seed).integers(0, vocab, (2, 32)).astype(
        np.int32)
    mask = np.ones((2, 32), np.float32)
    mask[1, 20:] = 0.0
    return dict(tokens=toks, labels=np.roll(toks, -1, axis=1), mask=mask)


@pytest.mark.parametrize("arch", LMS)
def test_loss_and_aux_match_reference(arch):
    """``loss_fn``: the loss (cross-entropy plus the layers' aux), and
    ``ce`` and ``aux`` apart; aux 0 for a dense LM."""
    jc, tc = (dataclasses.replace(r.get_arch(arch).reduced)
              for r in (jconfigs, tconfigs))
    jp, tp = _params(arch)
    b = _batch(tc.vocab)
    wl, wm = jax.jit(functools.partial(jtfm.loss_fn, jc))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    gl, gm = ttfm.loss_fn(tc, tp, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    assert float(gm["ce"]) == pytest.approx(float(wm["ce"]), rel=1e-5)
    assert float(gm["aux"]) == pytest.approx(float(wm["aux"]), rel=1e-6)
    assert (float(gm["aux"]) > 0) == (tc.moe is not None)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_match_reference(arch):
    """Every leaf's gradient of ``loss_fn`` (the router's through the
    gates and the aux loss) within 1e-5 of its norm."""
    jc = jconfigs.get_arch(arch).reduced
    tc = tconfigs.get_arch(arch).reduced
    jp, _ = _params(arch)
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp),
                                    device="cpu")
    b = _batch(tc.vocab)
    want = jax.jit(jax.grad(lambda p, bb: jtfm.loss_fn(jc, p, bb)[0]))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tp = _map(lambda t: t.requires_grad_(True), tp)
    loss, _ = ttfm.loss_fn(tc, tp, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
    loss.backward()
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, g in flat:
        t = tp
        for p in path:
            t = t[p.key]
        g = np.asarray(g)
        scale = max(float(np.linalg.norm(g)), 1e-30)
        assert float(np.linalg.norm(t.grad.numpy() - g)) <= 1e-5 * scale, \
            jax.tree_util.keystr(path)
    router = tp["layers"]["router"]["w"].grad
    assert float(router.abs().max()) > 0


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_moe_decode_matches_forward():
    """The reference's ``test_moe_decode_matches_forward`` restated: its
    config (4 experts, top 2, capacity 4.0, so nothing drops), token by
    token decode gives the forward's logits at every position, 5e-3."""
    cfg = ttfm.TransformerConfig(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=101,
        moe=ttfm.MoEConfig(n_experts=4, top_k=2, capacity_factor=4.0),
        compute_dtype=torch.float32, attn_chunk=8, remat=False)
    params = ttfm.init(cfg, 0, device="cpu")
    b, s = 2, 6
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (b, s)).astype(np.int32))
    h, aux = ttfm.forward(cfg, params, toks)
    full = tL.dense_apply(params["lm_head"], h)
    cache = ttfm.init_cache(cfg, b, 8, torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = ttfm.decode_step(cfg, params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)
    assert float(aux) > 0


# -- parameters -----------------------------------------------------------------

@pytest.mark.parametrize("arch", LMS)
def test_full_init_tree_is_the_references(arch):
    """At full size on meta (nothing allocated): the port's tree has the
    reference's nesting, names, shapes (the router ``[n, d, E]``, the
    expert stacks with their virtual-expert axis) and f32 dtypes."""
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: jtfm.init(jconfigs.get_arch(arch).config, k),
        jax.random.PRNGKey(0)))[0]
    with dryrun._OnMeta():
        got = ttfm.init(tconfigs.get_arch(arch).config, 0, device="meta")
    n = 0
    for path, leaf in want:
        t = got
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        assert t.device.type == "meta"
        n += 1
    assert n == len(_leaves(got))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_carries_the_moe_leaves(arch):
    """``convert.params_from_arrays`` carries the router and the expert
    stacks as they are, and the port's own ``init`` makes them in the same
    shapes, each of ``N(0, 1) / sqrt(fan_in)``."""
    jp, tp = _params(arch)
    for name in ("w_gate", "w_up", "w_down"):
        assert np.array_equal(tp["layers"][name].numpy(),
                              np.asarray(jp["layers"][name]))
    assert np.array_equal(tp["layers"]["router"]["w"].numpy(),
                          np.asarray(jp["layers"]["router"]["w"]))
    cfg = tconfigs.get_arch(arch).reduced
    own = ttfm.init(cfg, 0, device="cpu")
    for name in ("w_gate", "w_up", "w_down"):
        assert own["layers"][name].shape == tp["layers"][name].shape
        fan_in = own["layers"][name].shape[2]
        assert float(own["layers"][name].std()) == pytest.approx(
            fan_in ** -0.5, rel=0.1)


# -- the stacked expert-parallel path ---------------------------------------------

# (case, tokens): with drops at capacity 1.0, T < data (replicated), grok
SHARDMAP_CASES = (("dbrx_cf1", TOKENS), ("dbrx", 1), ("grok", TOKENS))
# the whole reduced model on the 2 x 2 mesh: dbrx at capacity 1.0 (slots
# drop), remat on; prefill [2, 32] (tokens split over data), then decode
# steps of B = 2 (one token a data shard) and B = 1 (replicated)
MESH_MODEL_CASE = "dbrx_cf1"
MESH_DECODE = ((2, 4), (1, 2))          # (batch, steps)


def _mesh_model_configs():
    jc, tc = _configs(MESH_MODEL_CASE)
    return (dataclasses.replace(jc, remat=True),
            dataclasses.replace(tc, remat=True))


# the mesh's gradients and train step: dbrx at capacity 1.0 with remat,
# grok with its experts split in two
MESH_GRAD_CASES = {"dbrx_cf1": dict(remat=True), "grok": {}}
# the published rules of the large MoE LMs forced on the smoke optimizer;
# b1 0.5 and a clip that does not bind keep most of mu above fp8's
# smallest subnormal at these gradients
TRAIN_RULES = dict(warmup_steps=2, total_steps=100, b1=0.5, grad_clip=1e3)
TRAIN_MICROBATCHES = 2


def _mesh_case_configs(case):
    return tuple(dataclasses.replace(c, **MESH_GRAD_CASES[case])
                 for c in _configs(case))


def _decode_tokens(vocab, b, steps):
    return np.random.default_rng(6 + b).integers(
        0, vocab, (steps, b, 1)).astype(np.int32)


def _reference_shardmap(out_path):
    """Run in a subprocess with four fake host devices: the reference's
    ``_moe_ffn_shardmap`` on a 2 x 2 mesh for each case, then its
    ``forward``, ``loss_fn`` and ``decode_step`` with ``act_shard`` on
    that mesh (the shard_map MoE in every layer)."""
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    ash = jtfm.ActSharding(batch=("data",), model="model", mesh=mesh,
                           fsdp_axis="data")
    out = {}
    for case, t in SHARDMAP_CASES:
        jc, _ = _configs(case)
        jc = dataclasses.replace(jc, act_shard=ash)
        jl, _ = _layer0(case)
        y, aux = jax.jit(functools.partial(jtfm._moe_ffn_shardmap, jc))(
            jl, jnp.asarray(_x(jc.d_model, t)))
        out[f"{case}_{t}_y"] = np.asarray(y)
        out[f"{case}_{t}_aux"] = np.asarray(aux)

    jc = dataclasses.replace(_mesh_model_configs()[0], act_shard=ash)
    jp, _ = _params(FFN_CASES[MESH_MODEL_CASE][0], MESH_MODEL_CASE)
    b = {k: jnp.asarray(v) for k, v in _batch(jc.vocab).items()}
    h, aux = jax.jit(functools.partial(jtfm.forward, jc))(jp, b["tokens"])
    loss, m = jax.jit(functools.partial(jtfm.loss_fn, jc))(jp, b)
    out.update(model_h=np.asarray(h), model_aux=np.asarray(aux),
               model_loss=np.asarray(loss), model_ce=np.asarray(m["ce"]),
               model_loss_aux=np.asarray(m["aux"]))
    step = jax.jit(functools.partial(jtfm.decode_step, jc))
    for bsz, steps in MESH_DECODE:
        cache = jtfm.init_cache(jc, bsz, 8, jnp.float32)
        toks = _decode_tokens(jc.vocab, bsz, steps)
        for i in range(steps):
            logits, cache = step(jp, cache, jnp.asarray(toks[i]))
            out[f"decode_{bsz}_{i}"] = np.asarray(logits)

    from repro.distributed import sharding as jsharding
    from repro.training import optimizer as jopt
    from repro.training import train_loop as jtl

    opt = jopt.AdamWConfig(mu_dtype=jnp.float8_e4m3fn,
                           nu_dtype=jnp.bfloat16, **TRAIN_RULES)
    for case in MESH_GRAD_CASES:
        jc = dataclasses.replace(_mesh_case_configs(case)[0], act_shard=ash)
        jp, _ = _params(FFN_CASES[case][0], case)
        b = {k: jnp.asarray(v) for k, v in _batch(jc.vocab).items()}
        grads = jax.jit(jax.grad(lambda p, bb: jtfm.loss_fn(jc, p, bb)[0]))(
            jp, b)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"grad_{case}{jax.tree_util.keystr(path)}"] = np.asarray(g)
        train = jtl.make_train_step(
            functools.partial(jtfm.loss_fn, jc), opt,
            microbatches=TRAIN_MICROBATCHES, accum_dtype=jnp.bfloat16,
            grad_pspecs=jsharding.param_specs("lm", jp, jc))
        with jax.set_mesh(mesh):
            p1, s1, m = jax.jit(train)(jp, jopt.init(opt, jp), b)
        out[f"train_{case}_loss"] = np.asarray(m["loss"])
        out[f"train_{case}_grad_norm"] = np.asarray(m["grad_norm"])
        out[f"train_{case}_lr"] = np.asarray(m["lr"])
        # the step's gradient: the microbatches' summed into a bf16
        # accumulator, as its scan sums them, then averaged
        n = TRAIN_MICROBATCHES
        micro = [jax.jit(jax.grad(lambda p, bb: jtfm.loss_fn(jc, p, bb)[0]))(
            jp, {k: v.reshape((n, -1) + v.shape[1:])[i]
                 for k, v in b.items()}) for i in range(n)]
        for i, gs in enumerate(zip(*(jax.tree.leaves(h) for h in micro))):
            acc = jnp.zeros(gs[0].shape, jnp.bfloat16)
            # two bf16 steps of each partial sum, summed: how far two
            # accumulations of gradients 1e-6 apart can end apart (a sum
            # rounds to a neighbour of the other's, from an input a step
            # or more away)
            steps_of = np.zeros(gs[0].shape, np.float32)
            for g in gs:
                acc = (acc.astype(jnp.float32) + g).astype(jnp.bfloat16)
                steps_of += 2 * np.spacing(np.abs(np.asarray(acc))).astype(
                    np.float32)
            out[f"train_{case}_grad_{i}"] = np.asarray(
                (acc / n).astype(jnp.float32))
            out[f"train_{case}_gstep_{i}"] = steps_of / n
        for kind, tree in (("param", p1), ("mu", s1.mu), ("nu", s1.nu)):
            for i, x in enumerate(jax.tree.leaves(tree)):
                out[f"train_{case}_{kind}_{i}"] = np.asarray(
                    x.astype(jnp.float32))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference_2x2(tmp_path_factory):
    """The reference's 2 x 2 ``shard_map`` results, made once a module."""
    out = tmp_path_factory.mktemp("shardmap") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def test_shardmap_2x2_matches_reference_shard_map(reference_2x2):
    want = reference_2x2
    mesh = ShardMesh(2, 2, device="cpu")
    for case, t in SHARDMAP_CASES:
        _, tc = _configs(case)
        _, tl = _layer0(case)
        y, aux = ttfm._moe_ffn_shardmap(tc, tl, torch.from_numpy(
            _x(tc.d_model, t)), mesh)
        w = want[f"{case}_{t}_y"]
        assert y.shape == w.shape
        np.testing.assert_allclose(y.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * min(1.0, np.abs(w).max()))
        assert float(aux) == pytest.approx(float(want[f"{case}_{t}_aux"]),
                                           rel=1e-6)


def test_mesh_model_matches_reference_act_shard(reference_2x2):
    """``forward``, ``loss_fn`` and ``decode_step`` with ``mesh=`` a 2 x 2
    ``ShardMesh`` against the reference's with ``act_shard`` on a 2 x 2
    mesh: the reduced dbrx at capacity 1.0 with remat, the hidden states
    and aux, the loss and its parts, and each decode step's logits at
    B = 2 (tokens split over data) and B = 1 (replicated)."""
    want = reference_2x2
    _, tc = _mesh_model_configs()
    _, tp = _params(FFN_CASES[MESH_MODEL_CASE][0], MESH_MODEL_CASE)
    mesh = ShardMesh(2, 2, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(tc.vocab).items()}
    h, aux = ttfm.forward(tc, tp, b["tokens"], mesh=mesh)
    _close(h, want["model_h"], "f32")
    assert float(aux) == pytest.approx(float(want["model_aux"]), rel=1e-6)
    loss, m = ttfm.loss_fn(tc, tp, b, mesh=mesh)
    assert float(loss) == pytest.approx(float(want["model_loss"]), rel=1e-5)
    assert float(m["ce"]) == pytest.approx(float(want["model_ce"]), rel=1e-5)
    assert float(m["aux"]) == pytest.approx(float(want["model_loss_aux"]),
                                            rel=1e-6)
    for bsz, steps in MESH_DECODE:
        cache = ttfm.init_cache(tc, bsz, 8, torch.float32, device="cpu")
        toks = _decode_tokens(tc.vocab, bsz, steps)
        for i in range(steps):
            logits, cache = ttfm.decode_step(
                tc, tp, cache, torch.from_numpy(toks[i]), mesh=mesh)
            _close(logits, want[f"decode_{bsz}_{i}"], "f32")
        assert int(cache["length"]) == steps


@pytest.mark.parametrize("case", list(MESH_GRAD_CASES))
def test_mesh_gradients_match_reference_shard_map(reference_2x2, case):
    """``loss_fn(mesh=)``'s gradients on the stacked 2 x 2 mesh against
    ``jax.grad`` of the reference's through its ``shard_map``: every leaf
    within 1e-5 of its norm, and none a whole multiple of it."""
    _, tc = _mesh_case_configs(case)
    _, tp = _params(FFN_CASES[case][0], case)
    b = {k: torch.from_numpy(v) for k, v in _batch(tc.vocab).items()}
    _, _, grads = ttl.value_and_grad(functools.partial(
        ttfm.loss_fn, tc, mesh=ShardMesh(2, 2, device="cpu")))(tp, b)
    n = 0
    for key, want in reference_2x2.items():
        if not key.startswith(f"grad_{case}["):
            continue
        got = grads
        for part in key[len(f"grad_{case}"):].strip("[]'").split("']['"):
            got = got[part]
        scale = max(float(np.linalg.norm(want)), 1e-30)
        err = float(np.linalg.norm(got.numpy() - want))
        assert err <= 1e-5 * scale, (key, err / scale)
        n += 1
    assert n == len(tree_leaves(grads))


@pytest.mark.parametrize("case", list(MESH_GRAD_CASES))
def test_mesh_train_step_matches_reference(reference_2x2, case):
    """One ``make_train_step(mesh=)`` step on the stacked 2 x 2 mesh (two
    microbatches, a bf16 accumulator, fp8 ``mu`` and bf16 ``nu``, the
    norm taken by the blocks of ``transformer.param_specs``) against the
    reference's ``make_train_step(..., grad_pspecs=)`` jitted under the
    mesh, at the training bars (``tests/torch_train_parity.py``): the loss
    and ``grad_norm`` within 1e-5 relative, the parameters within 1e-5
    absolute, 1e-5 + 2 ``lr`` where the step's reference gradient (its
    bf16 accumulator's) is below 1e-5 of its leaf's largest (Adam turns
    such an element's rounding noise into a step of up to ``lr``; two
    microbatches' gradients that cancel leave such an element, whose bf16
    sum keeps little but noise); each moment within one step of its dtype
    at the reference's value plus what the bf16 accumulator's rounding
    makes of it (gradients 1e-6 apart can round each partial sum to
    neighbouring bf16 values, and two microbatches' that cancel leave the
    first's step in a small sum: ``s`` two steps of each partial sum,
    summed over the microbatches and divided by them, ``(1 - b1) s`` in ``mu``, ``(1 - b2) (2 |g| +
    s) s`` in ``nu``), at a noise element plus the moment of a gradient at
    that threshold."""
    _, tc = _mesh_case_configs(case)
    _, tp = _params(FFN_CASES[case][0], case)
    tp = _map(lambda t: t.detach().clone(), tp)
    mesh = ShardMesh(2, 2, device="cpu")
    opt = dataclasses.replace(
        steps.SMOKE_OPT, mu_dtype=torch.float8_e4m3fn,
        nu_dtype=torch.bfloat16, **TRAIN_RULES)
    step = ttl.make_train_step(
        functools.partial(ttfm.loss_fn, tc, mesh=mesh), opt,
        microbatches=TRAIN_MICROBATCHES, accum_dtype=torch.bfloat16,
        mesh=mesh, specs=ttfm.param_specs(tc, mesh))
    b = {k: torch.from_numpy(v) for k, v in _batch(tc.vocab).items()}
    p1, s1, m = step(tp, ttl.init_state(opt, tp), b)
    want = reference_2x2
    for k in ("loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(want[f"train_{case}_{k}"]),
                                            rel=1e-5), k
    lr = float(want[f"train_{case}_lr"])
    noisy = []
    for i, x in enumerate(tree_leaves(p1)):
        g = np.abs(want[f"train_{case}_grad_{i}"])
        noisy.append((g < 1e-5 * g.max(), 1e-5 * g.max()))
        limit = np.where(noisy[i][0], 1e-5 + 2 * lr, 1e-5)
        off = np.abs(x.numpy() - want[f"train_{case}_param_{i}"])
        assert np.all(off <= limit), (i, off.max())
    for kind, tree, dt in (("mu", s1.mu, torch.float8_e4m3fn),
                           ("nu", s1.nu, torch.bfloat16)):
        for i, x in enumerate(tree_leaves(tree)):
            assert x.dtype == dt
            w = want[f"train_{case}_{kind}_{i}"]
            jdt = {torch.float8_e4m3fn: jnp.float8_e4m3fn,
                   torch.bfloat16: jnp.bfloat16}[dt]
            ulp = np.spacing(np.abs(w).astype(jdt)).astype(np.float32)
            off = np.abs(x.float().numpy() - w)
            # one step of the bf16 accumulator, in the moment
            g = np.abs(want[f"train_{case}_grad_{i}"])
            gstep = want[f"train_{case}_gstep_{i}"]
            acc = ((1 - opt.b1) * gstep if kind == "mu"
                   else (1 - opt.b2) * (2 * g + gstep) * gstep)
            # a noise gradient's moment: (1 - b1) 2 g or (1 - b2) g^2
            mask, thr = noisy[i]
            noise = (2 * (1 - opt.b1) * thr if kind == "mu"
                     else (1 - opt.b2) * thr * thr)
            limit = np.where(mask, noise, acc) + ulp
            assert np.all(off <= limit), (kind, i)


def test_mesh_loss_gradients_through_remat():
    """``loss_fn(mesh=)``'s backward through the remat checkpoint: every
    leaf's gradient equal to the one without remat, the router's and the
    expert stacks' not zero."""
    _, tc = _mesh_model_configs()
    _, tp = _params(FFN_CASES[MESH_MODEL_CASE][0], MESH_MODEL_CASE)
    mesh = ShardMesh(2, 2, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(tc.vocab).items()}
    grads = []
    for remat in (True, False):
        p = _map(lambda t: t.detach().clone().requires_grad_(True), tp)
        loss, _ = ttfm.loss_fn(dataclasses.replace(tc, remat=remat), p, b,
                               mesh=mesh)
        loss.backward()
        grads.append(_leaves(_map(lambda t: t.grad, p)))
    for g_remat, g_plain in zip(*grads):
        torch.testing.assert_close(g_remat, g_plain, rtol=1e-6, atol=1e-7)
    lay = grads[0]
    assert all(float(g.abs().max()) > 0 for g in lay)


def test_decode_step_makes_no_fold_table():
    """A MoE ``decode_step`` computes no aux loss, so it never reaches the
    fold table that ``forward`` copies from the host (nothing to copy
    inside a CUDA-graph capture, at any batch size)."""
    _, tc = _configs("grok")
    _, tp = _params("grok-1-314b", "grok")
    cache = ttfm.init_cache(tc, 3, 4, torch.float32, device="cpu")
    ttfm._sequential_folds.cache_clear()
    for mesh in (None, ShardMesh(2, 2, device="cpu")):
        ttfm.decode_step(tc, tp, cache, torch.zeros((3, 1), dtype=torch.int32),
                         mesh=mesh)
    assert ttfm._sequential_folds.cache_info().currsize == 0
    ttfm.forward(tc, tp, torch.zeros((1, 4), dtype=torch.int32))
    assert ttfm._sequential_folds.cache_info().currsize == 1


def test_shardmap_equals_single_device_where_nothing_drops():
    """At a capacity where no slot drops, the stacked 2 x 2 path gives
    ``_moe_ffn``'s output (the aux differs: each data shard's own)."""
    _, tc = _configs("grok")
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=float(tc.moe.n_experts)))
    _, tl = _layer0("grok")
    x = torch.from_numpy(_x(tc.d_model))
    want, _ = ttfm._moe_ffn(tc, tl, x)
    got, _ = ttfm._moe_ffn_shardmap(tc, tl, x, ShardMesh(2, 2, device="cpu"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as jtfm
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    from repro_torch.models import transformer as ttfm

    _reference_shardmap(sys.argv[1])
