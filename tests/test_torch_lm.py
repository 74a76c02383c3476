"""The port's decoder-only transformer (``smollm-135m``'s prefill and
KV-cache decode) against the JAX package, on the CPU.

Tokens come from a numpy seed; parameters from the reference's ``init``
(its zero biases and unit norm scales replaced by seeded random values,
so the bias and each norm change the output), carried across by
``convert.params_from_arrays``.  The reduced config (4 layers, d = 96,
3 heads over 3 KV heads) runs as it is, with 6 heads over 2 KV heads
(G = 3, smollm's grouping) and with ``qkv_bias``, each in f32 and with
``compute_dtype`` bf16.

Tolerances are the zoo's (``tests/test_torch_zoo.py``): f32 1e-5 (the
same sums in other orders), bf16 3e-2, each relative with an absolute
part of the same size scaled down to the reference output's largest
magnitude when that is below 1.  The f32 reference runs jitted, the bf16
one eagerly, op by op (``_ref``: a compiled bf16 program fuses ops and
skips roundings the eager reference makes).
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttfm
from repro_torch.training import train_loop as ttl

torch.set_num_threads(1)

ARCH = "smollm-135m"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}
VARIANTS = {"reduced": {},
            "gqa_6_over_2": dict(n_heads=6, n_kv_heads=2),
            "qkv_bias": dict(qkv_bias=True)}
DECODE_STEPS = 10

_spec = importlib.util.spec_from_file_location(
    "chip_smoke",
    os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _np(x):
    """numpy f32 of a JAX or torch array (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, dt):
    """Within ``TOL[dt]`` relative, and absolute ``TOL[dt]`` times the
    reference's largest magnitude where that is below 1."""
    assert tuple(got.shape) == tuple(want.shape)
    want = _np(want)
    scale = min(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dt],
                               atol=TOL[dt] * scale)


def _overrides(variant, dt, **extra):
    """``config_overrides`` of the reference (index 0) and the port (1)."""
    return tuple(dict(compute_dtype=DTYPES[dt][i], **VARIANTS[variant],
                      **extra) for i in (0, 1))


def _configs(variant, dt, **extra):
    jo, to = _overrides(variant, dt, **extra)
    return (dataclasses.replace(jconfigs.get_arch(ARCH).reduced, **jo),
            dataclasses.replace(tconfigs.get_arch(ARCH).reduced, **to))


@functools.lru_cache(maxsize=None)
def _params(variant):
    """The reference's reduced parameters (f32) with its zero biases and
    unit norm scales made random, as JAX arrays and as the port's copy."""
    jc, _ = _configs(variant, "f32")
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


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _ref(fn, dt):
    """The reference's ``fn`` jitted in f32, and in bf16 eager, op by op:
    under ``jax.disable_jit`` its ``lax.scan`` over the layers (and over
    the attention's chunks) runs as a loop of primitives.  A scan that
    runs compiled fuses its body and skips roundings the eager reference
    makes: at this depth the two differ by more than the bar allows at a
    few entries of the bf16 hidden states."""
    if dt == "f32":
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


# -- prefill ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_reference(variant, dt):
    """The hidden states of a ``[2, 64]`` batch, every position."""
    jc, tc = _configs(variant, dt)
    jp, tp = _params(variant)
    toks = _tokens((2, 64), 2, jc.vocab)
    want, _ = _ref(functools.partial(jtfm.forward, jc), dt)(
        jp, jnp.asarray(toks))
    got, aux = ttfm.forward(tc, tp, torch.from_numpy(toks))
    assert got.dtype == tc.compute_dtype and float(aux) == 0.0
    _close(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_bundle_matches_reference(variant, dt):
    """The reduced ``prefill_32k`` bundle's ``step_fn`` (the last
    position's logits, no bias) against the reference bundle's; the same
    kind, batch spec and model FLOPs; the port's own ``init_fn`` and
    ``make_batch`` give finite logits of that shape."""
    jo, to = _overrides(variant, dt)
    want_b = jsteps.build(jconfigs.get_arch(ARCH), "prefill_32k",
                          reduced=True, config_overrides=jo)
    got_b = steps.build(ARCH, "prefill_32k", reduced=True, device="cpu",
                        config_overrides=to)
    assert got_b.kind == want_b.kind == "serve"
    assert got_b.model_flops_per_step == want_b.model_flops_per_step > 0
    assert got_b.cache_spec is None and got_b.make_cache is None
    assert {k: (shp, dtype) for k, (shp, dtype) in got_b.batch_spec.items()
            } == {"tokens": ((2, 64), torch.int32)}
    assert want_b.batch_spec["tokens"].shape == (2, 64)
    jp, tp = _params(variant)
    toks = _tokens((2, 64), 3, 512)
    want = _ref(want_b.step_fn, dt)(jp, {"tokens": jnp.asarray(toks)})
    got = got_b.step_fn(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, dt)
    own = got_b.make_batch(torch.Generator().manual_seed(2))
    assert own["tokens"].shape == (2, 64)
    assert own["tokens"].dtype == torch.int32
    out = got_b.step_fn(got_b.init_fn(0), own)
    assert out.shape == (2, 1, 512) and bool(torch.isfinite(out).all())


# -- decode -----------------------------------------------------------------------

def _ref_cache(bundle):
    return {k: jnp.zeros(v.shape, v.dtype)
            for k, v in bundle.cache_spec.items()}


def _decode_both(variant, dt, steps_n, *, shape="decode_32k", **extra):
    """``steps_n`` decode steps of the reduced bundles from empty caches on
    the same tokens: ``[(want_logits, got_logits)]``, both final caches."""
    jo, to = _overrides(variant, dt, **extra)
    want_b = jsteps.build(jconfigs.get_arch(ARCH), shape, reduced=True,
                          config_overrides=jo)
    got_b = steps.build(ARCH, shape, reduced=True, device="cpu",
                        config_overrides=to)
    jp, tp = _params(variant)
    jcache, tcache = _ref_cache(want_b), got_b.make_cache()
    assert {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()} \
        == got_b.cache_spec
    ref_step = _ref(want_b.step_fn, dt)
    toks = _tokens((steps_n, 2, 1), 4, 512)
    outs = []
    for t in range(steps_n):
        want, jcache = ref_step(jp, jcache, {"tokens": jnp.asarray(toks[t])})
        got, tcache = got_b.step_fn(tp, tcache,
                                    {"tokens": torch.from_numpy(toks[t])})
        outs.append((want, got))
    return outs, jcache, tcache


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match_reference(variant, dt):
    """Ten ``decode_32k`` steps from ``init_cache``: each step's logits,
    and the cache's K/V and length after them."""
    outs, jcache, tcache = _decode_both(variant, dt, DECODE_STEPS)
    for want, got in outs:
        assert got.shape == (2, 1, 512) and got.dtype == DTYPES[dt][1]
        _close(got, want, dt)
    assert int(tcache["length"]) == int(jcache["length"]) == DECODE_STEPS
    assert tcache["length"].dtype == torch.int32
    assert tcache["length"].shape == ()
    for name in ("k", "v"):
        assert tcache[name].dtype == DTYPES[dt][1]
        _close(tcache[name], jcache[name], dt)
        assert not bool(tcache[name][:, :, DECODE_STEPS:].any())


@pytest.mark.parametrize("variant", ["reduced", "gqa_6_over_2"])
def test_decode_reproduces_the_forward(variant):
    """Token-by-token decode gives the parallel forward's logits at every
    position (the reference's ``test_decode_matches_forward`` contract),
    in f32."""
    _, tc = _configs(variant, "f32")
    _, tp = _params(variant)
    toks = torch.from_numpy(_tokens((2, 10), 5, tc.vocab))
    h, _ = ttfm.forward(tc, tp, toks)
    full = tL.dense_apply(tp["lm_head"], h)
    cache = ttfm.init_cache(tc, 2, 16, torch.float32, device="cpu")
    outs = []
    for t in range(10):
        logits, cache = ttfm.decode_step(tc, tp, cache, toks[:, t:t + 1])
        outs.append(logits[:, 0])
    _close(torch.stack(outs, dim=1), full.numpy(), "f32")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_at_max_seq_writes_the_last_slot(dt):
    """A step at ``length == max_seq`` writes the last slot, as the
    reference's ``dynamic_update_slice`` clamps its start, and attends to
    every slot; the others keep their values (G = 3)."""
    jc, tc = _configs("gqa_6_over_2", dt)
    jp, tp = _params("gqa_6_over_2")
    s = 16
    r = np.random.default_rng(6)
    kv = {n: r.standard_normal((jc.n_layers, 2, s, jc.n_kv_heads,
                                jc.hd)).astype(np.float32)
          for n in ("k", "v")}
    jcache = {n: jnp.asarray(x).astype(DTYPES[dt][0]) for n, x in kv.items()}
    jcache["length"] = jnp.int32(s)
    tcache = {n: torch.from_numpy(x).to(DTYPES[dt][1])
              for n, x in kv.items()}
    before = {n: t.clone() for n, t in tcache.items()}
    tcache["length"] = torch.tensor(s, dtype=torch.int32)
    toks = _tokens((2, 1), 7, jc.vocab)
    want, jnew = _ref(functools.partial(jtfm.decode_step, jc), dt)(
        jp, jcache, jnp.asarray(toks))
    got, tnew = ttfm.decode_step(tc, tp, tcache, torch.from_numpy(toks))
    _close(got, want, dt)
    assert int(tnew["length"]) == int(jnew["length"]) == s + 1
    for n in ("k", "v"):
        assert torch.equal(tnew[n][:, :, :-1], before[n][:, :, :-1])
        assert not torch.equal(tnew[n][:, :, -1], before[n][:, :, -1])
        _close(tnew[n], jnew[n], dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kv_quant_cache_matches_reference(dt):
    """The int8 cache (``kv_quant``) over ten steps at G = 3: the logits
    within the bar, the bf16 scales within one bf16 step of the
    reference's, and the int8 values the reference's except where the two
    frameworks' K/V sit on either side of a rounding edge: then one apart,
    at most 1% of the 2,560 values written a tensor (f32: at most 2; none
    differ on these inputs in either dtype)."""
    outs, jcache, tcache = _decode_both("gqa_6_over_2", dt, DECODE_STEPS,
                                        kv_quant=True)
    for want, got in outs:
        _close(got, want, dt)
    assert int(tcache["length"]) == int(jcache["length"]) == DECODE_STEPS
    written = slice(0, DECODE_STEPS)
    for name in ("k", "v"):
        assert tcache[name].dtype == torch.int8
        got = tcache[name][:, :, written].numpy().astype(np.int32)
        want = np.asarray(jcache[name])[:, :, written].astype(np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1
        bound = 2 if dt == "f32" else diff.size // 100
        assert int((diff > 0).sum()) <= bound, (name, int((diff > 0).sum()))
        assert not bool(tcache[name][:, :, DECODE_STEPS:].any())
        sc = tcache[f"{name}_scale"]
        assert sc.dtype == torch.bfloat16
        np.testing.assert_allclose(
            _np(sc), _np(jcache[f"{name}_scale"]), rtol=2.0 ** -7, atol=0)


# -- init, bundles, launches ------------------------------------------------------

@pytest.mark.parametrize("variant", ["reduced", "qkv_bias"])
def test_init_tree_is_the_references(variant):
    """The port's ``init`` gives the reference's nesting, names, shapes
    (layers stacked on a leading ``n_layers`` axis) and dtypes (f32)."""
    jc, tc = _configs(variant, "f32")
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda k: jtfm.init(jc, k), jax.random.PRNGKey(0)))[0]
    got = ttfm.init(tc, 3, device="cpu")
    for path, leaf in want:
        t = got
        for p in path:
            t = t[p.key]
        assert t.shape == leaf.shape and t.dtype == torch.float32, path
    assert len(jax.tree.leaves(jax.tree.map(np.asarray, got))) == len(want)
    assert got["layers"]["wq"]["w"].std() == pytest.approx(
        tc.d_model ** -0.5, rel=0.05)
    assert float(got["embed"]["table"].std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k",
                                   "decode_32k_int8"])
def test_full_bundle_specs_match_reference(shape):
    """At full size (nothing is allocated): batch and cache specs, kind
    and model FLOPs are the reference's; ``decode_32k_int8`` is 60 layers
    of 9 KV heads, whose bf16 cache passes 0.5 TB and so takes the int8
    cache with its scales."""
    name, over = shape, {}
    if shape == "decode_32k_int8":
        name, over = "decode_32k", dict(n_layers=60, n_kv_heads=9)
    want_b = jsteps.build(jconfigs.get_arch(ARCH), name,
                          config_overrides=over or None)
    got_b = steps.build(ARCH, name, device="cpu",
                        config_overrides=over or None)
    jdt = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
           jnp.int8: torch.int8, jnp.float32: torch.float32}
    as_torch = lambda spec: {  # noqa: E731
        k: (tuple(v.shape), jdt[v.dtype.type]) for k, v in spec.items()}
    assert got_b.batch_spec == as_torch(want_b.batch_spec)
    assert got_b.model_flops_per_step == want_b.model_flops_per_step
    assert got_b.kind == want_b.kind == "serve"
    if want_b.cache_spec is None:
        assert got_b.cache_spec is None
    else:
        assert got_b.cache_spec == as_torch(want_b.cache_spec)
        assert ("k_scale" in got_b.cache_spec) == (shape == "decode_32k_int8")


@pytest.mark.parametrize("shape,kind", [("prefill_32k", "lm_prefill"),
                                        ("decode_32k", "lm_decode")])
def test_embedding_bag_launches_a_forward_and_a_step(shape, kind,
                                                     monkeypatch):
    """Every token lookup is one ``embedding_bag`` launch: one a prefill
    forward and one a decode step, as ``chip_smoke.LM_LOOKUPS`` states
    (the count phase 3k gates on).  The kernel is stood in for by its
    plain version, so the launch path runs on the CPU."""
    bundle = steps.build(ARCH, shape, reduced=True, device="cpu")
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(3))
    args = (params, bundle.make_cache(), batch) if bundle.make_cache \
        else (params, batch)
    want = bundle.step_fn(*args)
    monkeypatch.setattr(tops, "_route", lambda name, t: True)
    monkeypatch.setattr(tbag, "embedding_bag_cuda", tbag.embedding_bag_plain)
    tops.reset_launch_counts()
    args = (params, bundle.make_cache(), batch) if bundle.make_cache \
        else (params, batch)
    got = bundle.step_fn(*args)
    assert tops.launch_counts()["embedding_bag"] == chip_smoke.LM_LOOKUPS[
        (ARCH, kind)]
    if bundle.make_cache:
        got, want = got[0], want[0]
    assert torch.equal(got, want)


def test_lm_train_and_moe_raise(monkeypatch):
    """Training is ported (the name is from when it raised): two steps of
    the reduced ``train_4k`` on one batch, the second loss below 1.5x the
    first (the reference's ``test_second_train_step_decreases_or_close``),
    one lookup and one backward launch a step.  The MoE FFN is ported too
    (the name is from when it raised): the same two steps with
    ``smollm-135m``'s reduced config made MoE, the loss its cross-entropy
    plus a positive aux loss (``tests/test_torch_moe.py`` holds it against
    the reference)."""
    l1, l2, counts = _two_train_steps(ARCH, "train_4k", monkeypatch)
    assert np.isfinite(l1) and np.isfinite(l2) and l2 < 1.5 * l1
    n = chip_smoke.TRAIN_LOOKUPS[(ARCH, "lm_train")]
    assert counts["embedding_bag"] == counts["embedding_bag_backward"] == n
    moe = dict(moe=ttfm.MoEConfig(n_experts=4, top_k=2))
    bundle = steps.build(ARCH, "train_4k", reduced=True, device="cpu",
                         config_overrides=moe)
    params = bundle.init_fn(0)
    assert params["layers"]["w_gate"].shape[:2] == (4, 4)
    state = ttl.init_state(bundle.opt_cfg, params)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    params, state, m1 = bundle.step_fn(params, state, batch)
    params, state, m2 = bundle.step_fn(params, state, batch)
    assert float(m2["loss"]) < 1.5 * float(m1["loss"])
    loss, parts = bundle.loss_fn(params, batch)
    assert float(parts["aux"]) > 0
    assert float(loss) == pytest.approx(float(parts["ce"] + parts["aux"]))


def _two_train_steps(arch, shape, monkeypatch):
    """Two train steps of the reduced cell on one batch, the lookups and
    their backward on the kernels' launch path (each stood in for by its
    plain version, so the path runs on the CPU): ``(first loss, second
    loss, launch counts of the first step)``."""
    bundle = steps.build(arch, shape, reduced=True, device="cpu")
    assert bundle.kind == "train" and bundle.opt_cfg is steps.SMOKE_OPT
    params = bundle.init_fn(0)
    state = ttl.init_state(bundle.opt_cfg, params)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    for name, (shp, dtype) in bundle.batch_spec.items():
        assert batch[name].shape == shp and batch[name].dtype == dtype
    monkeypatch.setattr(tops, "_route", lambda name, t: True)
    monkeypatch.setattr(tbag, "embedding_bag_cuda", tbag.embedding_bag_plain)
    monkeypatch.setattr(tbag, "embedding_bag_backward_cuda",
                        tbag.embedding_bag_backward_plain)
    tops.reset_launch_counts()
    params, state, m1 = bundle.step_fn(params, state, batch)
    counts = tops.launch_counts()
    params, state, m2 = bundle.step_fn(params, state, batch)
    assert int(state.step) == 2
    return float(m1["loss"]), float(m2["loss"]), counts


@pytest.fixture()
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")


def test_lm_entry_points_default_to_cuda_and_raise_without_gpu(no_gpu):
    cfg = tconfigs.get_arch(ARCH).reduced
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        with pytest.raises(RuntimeError, match="cuda"):
            steps.build(ARCH, shape, reduced=True)
    with pytest.raises(RuntimeError, match="cuda"):
        ttfm.init(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        ttfm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_arrays({"w": np.zeros(2, np.float32)})

