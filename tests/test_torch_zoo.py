"""The port's recsys zoo (DCN-v2, SASRec, MIND), its shared layers and its
attention against the JAX package, on the CPU.

Inputs come from a numpy seed; parameters from the reference's ``init``,
carried across by ``convert.recsys_params_from_arrays``.  The reduced
configs run as they are (f32) and with ``compute_dtype`` set to bf16.

Tolerances: 1e-5 wherever both sides compute in f32 (the same sums in
other orders); ``embedding_apply`` bit-equal in both dtypes (each row is
one rounding of an f32 row); bf16 within 3e-2 (bf16 keeps 8 bits, and the
two frameworks may round products at other places).  Each tolerance is
relative, with an absolute part of the same size scaled down to the
reference output's largest magnitude when that is below 1 (``_close``).
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
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models.recsys import dcn as jdcn
from repro.models.recsys import mind as jmind
from repro.models.recsys import sasrec as jsasrec
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models.recsys import dcn as tdcn
from repro_torch.models.recsys import mind as tmind
from repro_torch.models.recsys import sasrec as tsasrec
from repro_torch.training import train_loop as ttl

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 3e-2}
ZOO = ("dcn-v2", "sasrec", "mind")
MODS = {"dcn-v2": (jdcn, tdcn), "sasrec": (jsasrec, tsasrec),
        "mind": (jmind, tmind)}

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


def _both(x, dt="f32"):
    """One numpy array as a JAX array and a torch tensor of ``dt``."""
    jd, td = DTYPES[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got, want, dt):
    """Within ``TOL[dt]`` relative, and absolute ``TOL[dt]`` times the
    reference's largest magnitude where that is below 1, so an output of
    small values (MIND's interests and scores) is held to its own scale."""
    assert got.shape == want.shape
    want = _np(want)
    scale = min(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dt],
                               atol=TOL[dt] * scale)


# -- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("bias,x_dt,compute", [
    (True, "f32", None), (False, "f32", None), (False, "bf16", None),
    (True, "f32", "bf16"), (False, "f32", "bf16")])
def test_dense_apply_matches_reference(bias, x_dt, compute):
    jp = jL.dense_init(jax.random.PRNGKey(0), 12, 7, bias=bias)
    tp = convert.recsys_params_from_arrays(jax.tree.map(np.asarray, jp),
                                           device="cpu")
    assert set(tp) == ({"w", "b"} if bias else {"w"})
    x = np.random.default_rng(1).standard_normal((5, 12)).astype(np.float32)
    jx, tx = _both(x, x_dt)
    cd = None if compute is None else DTYPES[compute]
    want = jL.dense_apply(jp, jx, compute_dtype=cd and cd[0])
    got = tL.dense_apply(tp, tx, compute_dtype=cd and cd[1])
    out = compute or x_dt
    assert got.dtype == DTYPES[out][1]
    _close(got, want, out)


def test_dense_and_embedding_init_match_the_reference_scales():
    """The port draws from its own generator: the shapes, the names and
    the scale of each draw are the reference's."""
    gen = torch.Generator().manual_seed(0)
    p = tL.dense_init(gen, 400, 300, bias=True)
    assert p["w"].shape == (400, 300) and not p["b"].any()
    assert float(p["w"].std()) == pytest.approx(400 ** -0.5, rel=0.02)
    q = tL.dense_init(gen, 400, 300, scale=0.5)
    assert set(q) == {"w"}
    assert float(q["w"].std()) == pytest.approx(0.5, rel=0.02)
    e = tL.embedding_init(gen, 1000, 64)["table"]
    assert e.shape == (1000, 64)
    assert float(e.std()) == pytest.approx(0.02, rel=0.02)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_embedding_apply_bit_equal_to_reference(dt):
    """Bags of one through ``embedding_bag`` with no mask: the reference's
    ``jnp.take`` of the cast table bit for bit, negative ids from the end,
    ids outside the table NaN rows."""
    r = np.random.default_rng(2)
    table = r.standard_normal((40, 12)).astype(np.float32)
    ids = r.integers(-40, 40, (6, 5)).astype(np.int32)
    ids[0, :3] = [40, -41, -1]
    jd, td = DTYPES[dt]
    want = _np(jL.embedding_apply({"table": jnp.asarray(table)},
                                  jnp.asarray(ids), compute_dtype=jd))
    got = tL.embedding_apply({"table": torch.from_numpy(table)},
                             torch.from_numpy(ids), compute_dtype=td)
    assert got.dtype == td and got.shape == (6, 5, 12)
    got = _np(got)
    nan = np.isnan(want)
    assert nan[0, :2].all() and not nan[0, 2:].any()
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_reference(norm, dt):
    r = np.random.default_rng(3)
    x = (3.0 * r.standard_normal((4, 6, 24)) + 1.0).astype(np.float32)
    jp = getattr(jL, f"{norm}_init")(24)
    jp = {k: jnp.asarray(r.standard_normal(24).astype(np.float32))
          for k in jp}
    tp = convert.recsys_params_from_arrays(jax.tree.map(np.asarray, jp),
                                           device="cpu")
    assert set(tp) == set(getattr(tL, f"{norm}_init")(24))
    jx, tx = _both(x, dt)
    got = getattr(tL, f"{norm}_apply")(tp, tx)
    assert got.dtype == tx.dtype
    _close(got, getattr(jL, f"{norm}_apply")(jp, jx), dt)


@pytest.mark.parametrize("act,final", [("relu", None), ("tanh", "sigmoid")])
def test_mlp_apply_matches_reference(act, final):
    jp = jL.mlp_init(jax.random.PRNGKey(4), [9, 16, 8, 3])
    tp = convert.recsys_params_from_arrays(jax.tree.map(np.asarray, jp),
                                           device="cpu")
    x = np.random.default_rng(5).standard_normal((7, 9)).astype(np.float32)
    jx, tx = _both(x)
    jfin = final and getattr(jax.nn, final)
    tfin = final and getattr(torch, final)
    want = jL.mlp_apply(jp, jx, act=getattr(jax.nn, act), final_act=jfin)
    got = tL.mlp_apply(tp, tx, act=getattr(torch, act), final_act=tfin)
    _close(got, want, "f32")


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rope_matches_reference(dt):
    np.testing.assert_allclose(tL.rope_frequencies(16).numpy(),
                               np.asarray(jL.rope_frequencies(16)),
                               rtol=1e-6)
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = r.integers(0, 4096, (2, 5)).astype(np.int32)
    jx, tx = _both(x, dt)
    got = tL.apply_rope(tx, torch.from_numpy(pos))
    assert got.dtype == tx.dtype
    # angles of up to 4,096 radians: the two libraries' f32 sin and cos
    # may differ in the last bits of such arguments
    _close(got, jL.apply_rope(jx, jnp.asarray(pos)), dt)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_reference(masked):
    r = np.random.default_rng(7)
    logits = (4 * r.standard_normal((3, 5, 11))).astype(np.float32)
    labels = r.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (r.random((3, 5)) > 0.4).astype(np.float32) if masked else None
    want = jL.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = tL.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.shape == ()
    _close(got, want, "f32")


def test_binary_cross_entropy_matches_reference():
    r = np.random.default_rng(8)
    logits = (6 * r.standard_normal(64)).astype(np.float32)
    labels = (r.random(64) > 0.5).astype(np.float32)
    _close(tL.binary_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels)),
           jL.binary_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)),
           "f32")


# -- attention ------------------------------------------------------------------

ATTN_CASES = {   # b, sq, skv, hq, hkv, hd, causal, chunk, q_offset
    "causal_one_chunk": (2, 16, 16, 2, 2, 8, True, 1024, 0),
    "causal_chunks": (2, 16, 16, 2, 2, 8, True, 4, 0),
    "full_chunks": (2, 16, 16, 2, 2, 8, False, 4, 0),
    "gqa_4_over_2": (2, 16, 16, 4, 2, 8, True, 8, 0),
    "q_offset": (1, 4, 16, 4, 2, 8, True, 4, 12),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_reference(case, dt):
    b, sq, skv, hq, hkv, hd, causal, chunk, off = ATTN_CASES[case]
    r = np.random.default_rng(9)
    q = r.standard_normal((b, sq, hq, hd)).astype(np.float32)
    k, v = (r.standard_normal((b, skv, hkv, hd)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dt) for x in (q, k, v))
    kw = dict(n_kv_heads=hkv, causal=causal, chunk=chunk, q_offset=off)
    want = jattn.chunked_attention(jq, jk, jv, **kw)
    got = tattn.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype
    _close(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_attention_matches_reference(dt):
    """Positions at and past ``cache_length`` (11 of 16) are masked: values
    there must not reach the output."""
    r = np.random.default_rng(10)
    q = r.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k, v = (r.standard_normal((2, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dt) for x in (q, k, v))
    want = jattn.decode_attention(jq, jk, jv, jnp.int32(11), n_kv_heads=2)
    got = tattn.decode_attention(tq, tk, tv, 11, n_kv_heads=2)
    _close(got, want, dt)
    tv[:, 11:] = 1e4
    _close(tattn.decode_attention(tq, tk, tv, torch.tensor(11),
                                  n_kv_heads=2), want, dt)
    assert tattn.NEG_INF == jattn.NEG_INF
    assert tattn.KVCache._fields == jattn.KVCache._fields


# -- the three models -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch, seed):
    """The reference's reduced parameters (f32 whatever the compute dtype;
    ``init`` jitted, which only makes it quicker) and the port's copy."""
    cfg = jconfigs.get_arch(arch).reduced
    jp = jax.jit(functools.partial(MODS[arch][0].init, cfg))(
        jax.random.PRNGKey(seed))
    return jp, convert.recsys_params_from_arrays(
        jax.tree.map(np.asarray, jp), device="cpu")


def _case(arch, dt, seed=0):
    jc = dataclasses.replace(jconfigs.get_arch(arch).reduced,
                             compute_dtype=DTYPES[dt][0])
    tc = dataclasses.replace(tconfigs.get_arch(arch).reduced,
                             compute_dtype=DTYPES[dt][1])
    return (jc, tc) + _params(arch, seed)


def _batch(arch, cfg, b, seed, n_cand=0):
    """A numpy batch: MIND's histories of 1 to H items (the rest masked)."""
    r = np.random.default_rng(seed)
    if arch == "dcn-v2":
        out = dict(dense=r.standard_normal((b, cfg.n_dense)).astype(np.float32),
                   sparse_ids=r.integers(0, cfg.vocab_per_field,
                                         (b, cfg.n_sparse)).astype(np.int32))
        vocab = cfg.vocab_per_field
    elif arch == "sasrec":
        out = dict(item_seq=r.integers(0, cfg.n_items,
                                       (b, cfg.seq_len)).astype(np.int32))
        vocab = cfg.n_items
    else:
        lens = r.integers(1, cfg.hist_len + 1, b)
        out = dict(hist=r.integers(0, cfg.n_items,
                                   (b, cfg.hist_len)).astype(np.int32),
                   hist_mask=(np.arange(cfg.hist_len)[None, :]
                              < lens[:, None]).astype(np.float32))
        vocab = cfg.n_items
    if n_cand:
        out["candidates"] = r.integers(0, vocab, n_cand).astype(np.int32)
    return out


def _call(mod, layers, fn, cfg, params, batch, as_tensor):
    b = {k: as_tensor(v) for k, v in batch.items()}
    if fn in ("forward", "retrieval_scores"):
        return getattr(mod, fn)(cfg, params, b)
    if fn in ("encode", "user_embedding"):
        return getattr(mod, fn)(cfg, params, b["item_seq"])
    ints = mod.user_interests(cfg, params, b["hist"], b["hist_mask"])
    if fn == "user_interests":
        return ints
    # label_aware_scores: the interests against each row's first item
    target = layers.embedding_apply(params["item_embed"], b["hist"][:, 0],
                                    compute_dtype=cfg.compute_dtype)
    return mod.label_aware_scores(cfg, ints, target)


MODEL_FNS = [("dcn-v2", "forward"), ("dcn-v2", "retrieval_scores"),
             ("sasrec", "encode"), ("sasrec", "user_embedding"),
             ("sasrec", "retrieval_scores"), ("mind", "user_interests"),
             ("mind", "label_aware_scores"), ("mind", "retrieval_scores")]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch,fn", MODEL_FNS)
def test_model_matches_reference(arch, fn, dt):
    jc, tc, jp, tp = _case(arch, dt)
    retrieval = fn == "retrieval_scores"
    batch = _batch(arch, jc, 1 if retrieval else 16, seed=11,
                   n_cand=300 if retrieval else 0)
    jmod, tmod = MODS[arch]
    ref = functools.partial(_call, jmod, jL, fn, jc)
    # in f32 the reference runs jitted (one compile in place of one a
    # primitive); in bf16 eagerly, since a jitted bf16 program fuses ops
    # and skips roundings the eager reference makes
    want = (jax.jit(ref, static_argnums=2) if dt == "f32" else ref)(
        jp, batch, jnp.asarray)
    got = _call(tmod, tL, fn, tc, tp, batch, torch.from_numpy)
    assert got.dtype == tc.compute_dtype
    assert bool(torch.isfinite(got).all())
    _close(got, want, dt)


@pytest.mark.parametrize("arch", ZOO)
def test_init_trees_are_the_references(arch):
    """The port's ``init`` gives the reference's nesting, names, shapes
    and dtypes (f32), from a seed on the asked device."""
    jmod, tmod = MODS[arch]
    cfg_j = jconfigs.get_arch(arch).reduced
    want = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda k: jmod.init(cfg_j, k),
                       jax.random.PRNGKey(0)))[0]
    got = tmod.init(tconfigs.get_arch(arch).reduced, 3, device="cpu")
    for path, leaf in want:
        t = got
        for p in path:
            t = t[p.key]
        assert t.shape == leaf.shape and t.dtype == torch.float32, path
    n = len(jax.tree.leaves(jax.tree.map(np.asarray, got)))
    assert n == len(want)


def test_sasrec_is_causal():
    """Changing the last item moves the last position's state only."""
    cfg = tconfigs.get_arch("sasrec").reduced
    p = tsasrec.init(cfg, 0, device="cpu")
    seq1 = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.n_items, (1, cfg.seq_len)).astype(np.int32))
    seq2 = seq1.clone()
    seq2[0, -1] = (seq1[0, -1] + 7) % cfg.n_items
    h1 = tsasrec.encode(cfg, p, seq1)
    h2 = tsasrec.encode(cfg, p, seq2)
    np.testing.assert_allclose(h1[:, :-1].numpy(), h2[:, :-1].numpy(),
                               atol=1e-5)
    assert not np.allclose(h1[:, -1].numpy(), h2[:, -1].numpy())


def test_mind_masking_matches_reference():
    """Masked history slots do not reach the interests, and a fully masked
    history still gives finite ones, the reference's."""
    jc, tc, jp, tp = _case("mind", "f32")
    r = np.random.default_rng(13)
    hist = r.integers(0, jc.n_items, (2, jc.hist_len)).astype(np.int32)
    mask = np.ones((2, jc.hist_len), np.float32)
    mask[0, 3:] = 0.0
    hist2 = hist.copy()
    hist2[0, 3:] = (hist[0, 3:] + 1) % jc.n_items    # masked slots only
    got = tmind.user_interests(tc, tp, torch.from_numpy(hist),
                               torch.from_numpy(mask))
    assert got.shape == (2, jc.n_interests, jc.embed_dim)
    again = tmind.user_interests(tc, tp, torch.from_numpy(hist2),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)
    for m in (mask, np.zeros_like(mask)):
        want = jmind.user_interests(jc, jp, jnp.asarray(hist), jnp.asarray(m))
        got = tmind.user_interests(tc, tp, torch.from_numpy(hist),
                                   torch.from_numpy(m))
        assert bool(torch.isfinite(got).all())
        _close(got, want, "f32")


# -- steps, configs and the launches a forward makes ------------------------------

@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
@pytest.mark.parametrize("arch", ZOO)
def test_steps_build_matches_reference_bundle(arch, shape):
    """The reduced bundle's ``step_fn`` against the reference bundle's on
    the reference's parameters and one numpy batch; the port's own
    ``init_fn`` and ``make_batch`` give a finite output of that shape."""
    want_b = jsteps.build(jconfigs.get_arch(arch), shape, reduced=True)
    got_b = steps.build(arch, shape, reduced=True, device="cpu")
    assert got_b.kind == want_b.kind == "serve"
    assert got_b.model_flops_per_step == want_b.model_flops_per_step > 0
    assert {k: v[0] for k, v in got_b.batch_spec.items()} == {
        k: v.shape for k, v in want_b.batch_spec.items()}
    cfg = tconfigs.get_arch(arch).reduced
    n_cand = got_b.batch_spec.get("candidates", ((0,),))[0][0]
    batch = _batch(arch, cfg, got_b.batch_spec[next(iter(
        got_b.batch_spec))][0][0], seed=14, n_cand=n_cand)
    jp, tp = _params(arch, 1)
    want = jax.jit(want_b.step_fn)(jp, batch)
    got = got_b.step_fn(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    _close(got, want, "f32")
    own = got_b.make_batch(torch.Generator().manual_seed(2))
    for name, (shp, dtype) in got_b.batch_spec.items():
        assert own[name].shape == shp and own[name].dtype == dtype
    out = got_b.step_fn(got_b.init_fn(0), own)
    assert out.shape == got.shape and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("arch", ZOO + ("dlrm-rm2",))
@pytest.mark.parametrize("kind", ["rec_serve", "rec_retrieval"])
def test_embedding_bag_launches_a_forward(arch, kind, monkeypatch):
    """Every gather of a forward is one ``embedding_bag`` launch, as many
    as ``chip_smoke.ZOO_LOOKUPS`` states (the count phase 3g gates on).
    The kernel is stood in for by its plain version, so the launch path
    runs on the CPU."""
    shape = "serve_p99" if kind == "rec_serve" else "retrieval_cand"
    bundle = steps.build(arch, shape, reduced=True, device="cpu")
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(3))
    want = bundle.step_fn(params, batch)
    monkeypatch.setattr(tops, "_route", lambda name, t: True)
    monkeypatch.setattr(tbag, "embedding_bag_cuda", tbag.embedding_bag_plain)
    tops.reset_launch_counts()
    got = bundle.step_fn(params, batch)
    assert tops.launch_counts()["embedding_bag"] == chip_smoke.ZOO_LOOKUPS[
        (arch, kind)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ZOO)
def test_rec_train_raises(arch, monkeypatch):
    """Training is ported (the name is from when it raised): two steps of
    the reduced ``train_batch`` on one batch, the second loss below 1.5x
    the first (the margin of the reference's
    ``test_second_train_step_decreases_or_close``), and a step launching
    ``chip_smoke.TRAIN_LOOKUPS`` lookups and as many of their backward."""
    l1, l2, counts = _two_train_steps(arch, "train_batch", monkeypatch)
    assert np.isfinite(l1) and np.isfinite(l2) and l2 < 1.5 * l1
    n = chip_smoke.TRAIN_LOOKUPS[(arch, "rec_train")]
    assert counts["embedding_bag"] == counts["embedding_bag_backward"] == n


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


# the reference's config fields the port does not carry: its parameters
# are f32 (``param_dtype``), and the transformer's other two only steer
# XLA's lowering (activation sharding, casting the parameters before an
# FSDP gather); ``remat`` is carried since training is ported
DROPPED_FIELDS = ("param_dtype", "act_shard", "precast_params")


@pytest.mark.parametrize("arch", ZOO + ("dlrm-rm2", "smollm-135m",
                                  "qwen1.5-32b", "command-r-plus-104b",
                                  "dbrx-132b", "grok-1-314b"))
def test_configs_match_reference(arch):
    """``full()`` and ``reduced()`` field for field (dtypes mapped, the
    dropped fields aside), ``param_count()``, the spec's kind, source,
    shapes and (for the zoo and the LM) notes."""
    want, got = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for w, g in ((want.config, got.config), (want.reduced, got.reduced)):
        wf = dataclasses.asdict(w)
        for name in DROPPED_FIELDS:
            wf.pop(name, None)
        wf["compute_dtype"] = dt[wf["compute_dtype"]]
        assert dataclasses.asdict(g) == wf
        assert g.param_count() == w.param_count()
    # DLRM's notes describe the port's table (one fused table, not
    # sharded), since its first slice
    names = ("id", "family", "model_kind", "source") + (
        ("notes",) if arch != "dlrm-rm2" else ())
    for name in names:
        assert getattr(got, name) == getattr(want, name)
    assert [(s.name, s.kind, s.seq_len, s.global_batch, s.extra)
            for s in got.shapes] \
        == [(s.name, s.kind, s.seq_len, s.global_batch, s.extra)
            for s in want.shapes]


def test_all_cells_are_the_references_for_the_ported_archs():
    """Every architecture is ported: the registry is the reference's, in
    its order, and so are its 40 cells; ``steps.build`` builds each one at
    full size on ``meta`` (nothing is made) and reduced on the CPU."""
    assert tconfigs.all_arch_ids() == jconfigs.all_arch_ids()
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert len(tconfigs.all_cells()) == 40
    for arch, shape in tconfigs.all_cells():
        for kw in (dict(device="meta"), dict(device="cpu", reduced=True)):
            b = steps.build(arch, shape, **kw)
            assert (b.arch_id, b.shape_name) == (arch, shape)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("no-such-arch")
