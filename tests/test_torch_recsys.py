"""The port's recsys serving path (DLRM RM2) against the JAX package, on
the CPU: ``embedding_bag`` (the plain version the wrapper picks for a CPU
tensor) against the reference's Pallas kernel in interpret mode and its
oracle, the embedding lookups, and DLRM's ``forward`` and
``retrieval_scores`` from the same parameters (``convert.
dlrm_params_from_arrays``) and the same numpy batch.

Tolerances: 1e-5 wherever both sides compute in f32 (sums of a few terms
in other orders); the bf16 lookup is bit-equal (each row is one rounding
of an f32 row); the bf16 model within atol = rtol = 3e-2 (bf16 keeps 8
bits, and the two frameworks round the matmul outputs at other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as jcfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.recsys import dlrm as jdlrm
from repro.models.recsys import embedding as jemb
from repro_torch import convert
from repro_torch.configs import dlrm_rm2 as tcfg
from repro_torch.configs import get_arch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps
from repro_torch.models.recsys import dlrm as tdlrm
from repro_torch.models.recsys import embedding as temb
from repro_torch.training import train_loop as ttl

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    """numpy f32 of a JAX or torch array (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bag_inputs(seed, b, bag, v, d):
    r = np.random.default_rng(seed)
    return (r.integers(0, v, (b, bag)).astype(np.int32),
            (r.random((b, bag)) > 0.3).astype(np.float32),
            r.standard_normal((v, d)).astype(np.float32))


# -- embedding_bag ------------------------------------------------------------

@pytest.mark.parametrize("b,bag,v,d", [
    (64, 4, 100, 128), (128, 16, 50, 256), (64, 1, 10, 128), (37, 3, 20, 48),
])
def test_embedding_bag_matches_reference_kernel_and_oracle(b, bag, v, d):
    ids, mask, table = _bag_inputs(b + bag, b, bag, v, d)
    tops.reset_launch_counts()
    got = tops.embedding_bag(*map(torch.from_numpy, (ids, mask, table)))
    assert tops.launch_counts()["embedding_bag"] == 0  # plain version
    assert got.shape == (b, d) and got.dtype == torch.float32
    want = jops.embedding_bag(jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(table), interpret=True)
    oracle = jref.embedding_bag_ref(jnp.asarray(ids), jnp.asarray(mask),
                                    jnp.asarray(table))
    for w in (want, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), tref.embedding_bag_ref(
            *map(torch.from_numpy, (ids, mask, table))).numpy(),
        rtol=1e-5, atol=1e-5)


def test_embedding_bag_out_of_range_ids_give_nan_rows():
    """As ``jnp.take``: an id in [-V, 0) counts from the end, any other id
    outside the table gives a NaN row, whatever its mask."""
    ids, mask, table = _bag_inputs(3, 6, 2, 20, 8)
    ids[0, 0] = 20             # past the end
    ids[1, 1] = -21            # before the start
    ids[2, 0] = -1             # the last row
    mask[:2] = 0.0
    got = tops.embedding_bag(*map(torch.from_numpy, (ids, mask, table)))
    want = np.asarray(jops.embedding_bag(
        jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(table),
        interpret=True))
    nan = np.isnan(want)
    assert nan[:2].all() and not nan[2:].any()
    assert np.array_equal(np.isnan(got.numpy()), nan)
    np.testing.assert_allclose(got.numpy()[~nan], want[~nan],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row,out", [("f32", "f32"), ("bf16", "f32"),
                                     ("bf16", "bf16")])
def test_embedding_bag_rounds_rows_then_sums_in_f32(row, out):
    """Each gathered row is rounded to ``row_dtype`` before the f32 sum,
    and only the sum is cast to ``out_dtype``."""
    ids, mask, table = _bag_inputs(5, 40, 5, 30, 24)
    rd, od = DTYPES[row][1], DTYPES[out][1]
    got = tops.embedding_bag(*map(torch.from_numpy, (ids, mask, table)),
                             row_dtype=rd, out_dtype=od)
    assert got.dtype == od
    rows = torch.from_numpy(table).to(rd).double()[
        torch.from_numpy(ids).long()]
    want = (rows * torch.from_numpy(mask).double()[..., None]).sum(1)
    np.testing.assert_allclose(_np(got), want.to(od).float().numpy(),
                               rtol=1e-5 if out == "f32" else 8e-3,
                               atol=1e-5)


@pytest.mark.parametrize("bag", [1, 3])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_embedding_bag_without_mask_is_the_reference_take(dt, bag):
    """``mask=None`` weighs every slot one: a bag of one is the reference's
    ``jnp.take`` of the table cast to the compute dtype, bit for bit, with
    negative ids counting from the end and ids outside ``[-V, V)`` NaN
    rows; a longer bag is the in-order sum of its slots' takes."""
    r = np.random.default_rng(21)
    table = r.standard_normal((40, 12)).astype(np.float32)
    ids = r.integers(-40, 40, (30, bag)).astype(np.int32)
    ids[:4, 0] = [40, 41, -41, -1]          # past the end, before the start
    jd, td = DTYPES[dt]
    got = _np(tops.embedding_bag(torch.from_numpy(ids), None,
                                 torch.from_numpy(table), row_dtype=td,
                                 out_dtype=td))
    rows = [_np(jemb.item_lookup(jnp.asarray(table), jnp.asarray(ids[:, i]),
                                 jd)) for i in range(bag)]
    want = rows[0]
    for x in rows[1:]:
        want = _np(jnp.asarray(want, jnp.float32) + jnp.asarray(x))
    want = _np(jnp.asarray(want).astype(jd))
    nan = np.isnan(want)
    assert nan[:3].all() and not nan[3:].any()
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def test_lookup_passes_no_mask(monkeypatch):
    """The one-hot ``lookup`` launches ``embedding_bag`` with no mask (no
    all-ones tensor is made): the launch the wrappers capture holds
    ``None`` in the mask's place.  The kernel is stood in for by its plain
    version, so the launch path runs on the CPU."""
    from repro_torch.kernels import embedding_bag as tbag

    jc, tc, jp, tp = _emb_case(6)
    ids = np.random.default_rng(7).integers(0, 30, (11, 5)).astype(np.int32)
    monkeypatch.setattr(tops, "_route", lambda name, t: True)
    monkeypatch.setattr(tbag, "embedding_bag_cuda", tbag.embedding_bag_plain)
    tops.reset_launch_counts()
    tops.capture_first_launches(True)
    try:
        got = temb.lookup(tc, tp, torch.from_numpy(ids), torch.bfloat16)
        (flat, mask, table), kwargs = tops.captured_launches()[
            "embedding_bag/main"]
    finally:
        tops.capture_first_launches(False)
    assert tops.launch_counts()["embedding_bag"] == 1
    assert mask is None and flat.shape == (11 * 5, 1)
    assert kwargs == dict(row_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    want = jemb.lookup(jc, jp, jnp.asarray(ids), jnp.bfloat16)
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("d", [16, 17, 48, 64, 128])
@pytest.mark.parametrize("rows", [1, 31, 33, 13_312, 6_815_744, 26_000_000])
def test_embedding_bag_launch_plan_covers_every_row_once(rows, d):
    """The kernel's walk (``csrc/embedding_bag.cu``), replayed on the plan:
    warp ``w`` of ``blocks * 8`` takes chunks ``w, w + W, ...``; lane
    ``l`` serves rows ``k * (32 / LPR) + l / LPR`` of a chunk (``k <
    chunk * LPR / 32``) at columns ``(l % LPR) * vec`` plus multiples of
    ``LPR * vec``.  Every chunk goes to one warp, every (row, column) of a
    chunk to one lane, and the chunks tile the rows; a small launch puts
    every chunk in flight at once on the card's resident warps (132 SMs, 3
    blocks of 8 warps each, as measured on an H100)."""
    from repro_torch.kernels import embedding_bag as tbag

    sms, per_sm = 132, 3
    vec = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    plan = tbag.launch_plan(rows, d, vec, sms, per_sm)
    lanes, chunk = plan.lanes_per_row, plan.chunk
    assert plan.vec == vec
    assert lanes == 32 or lanes * vec == d
    assert chunk & (chunk - 1) == 0
    assert plan.rows_per_instruction <= chunk <= tbag.MAX_CHUNK
    assert 1 <= plan.blocks <= sms * per_sm
    n_chunks = -(-rows // chunk)
    assert (n_chunks - 1) * chunk < rows <= n_chunks * chunk
    warps = plan.blocks * tbag.WARPS
    visits = (np.arange(warps)[:, None]
              + warps * np.arange(-(-n_chunks // warps))[None, :]).ravel()
    assert np.array_equal(np.bincount(visits[visits < n_chunks],
                                      minlength=n_chunks), np.ones(n_chunks))
    if chunk < tbag.MAX_CHUNK:      # shrunk: one wave, one chunk a warp
        assert n_chunks <= warps
    cells = np.zeros((chunk, d), np.int64)
    for lane in range(32):
        cols = np.arange((lane % lanes) * vec, d, lanes * vec)
        for k in range(chunk * lanes // 32):
            j = k * plan.rows_per_instruction + lane // lanes
            for c in cols:
                cells[j, c:c + vec] += 1
    assert (cells == 1).all()


# -- embedding lookups --------------------------------------------------------

def _emb_case(seed, nf=5, vocab=30, dim=24):
    jc = jemb.EmbeddingConfig(nf, vocab, dim)
    tc = temb.EmbeddingConfig(nf, vocab, dim)
    jp = jemb.init(jc, jax.random.PRNGKey(seed))
    tp = convert.dlrm_params_from_arrays(
        jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_lookup_bit_equal_to_reference(dt):
    jc, tc, jp, tp = _emb_case(0)
    ids = np.random.default_rng(1).integers(0, 30, (17, 5)).astype(np.int32)
    want = jemb.lookup(jc, jp, jnp.asarray(ids), DTYPES[dt][0])
    got = temb.lookup(tc, tp, torch.from_numpy(ids), DTYPES[dt][1])
    assert got.dtype == DTYPES[dt][1] and got.shape == (17, 5, 24)
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_bag_lookup_matches_reference(combiner, dt):
    """At bf16 compute the reference's bf16 rows times its f32 mask promote
    to f32: the port's output is f32 too, a sum of bf16-rounded rows."""
    jc, tc, jp, tp = _emb_case(2)
    jc = dataclasses.replace(jc, combiner=combiner)
    tc = dataclasses.replace(tc, combiner=combiner)
    r = np.random.default_rng(3)
    ids = r.integers(0, 30, (9, 5, 4)).astype(np.int32)
    mask = (r.random((9, 5, 4)) * (r.random((9, 5, 4)) > 0.3)).astype(
        np.float32)
    mask[0, 0] = 0.0           # an empty bag: the mean divides by 1
    want = jemb.bag_lookup(jc, jp, jnp.asarray(ids), jnp.asarray(mask),
                           DTYPES[dt][0])
    got = temb.bag_lookup(tc, tp, torch.from_numpy(ids),
                          torch.from_numpy(mask), DTYPES[dt][1])
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_item_lookup_matches_reference():
    _, _, jp, tp = _emb_case(4)
    ids = np.array([0, 5, 149, 150, -1], np.int32)   # 150 rows: one past
    want = _np(jemb.item_lookup(jp["table"], jnp.asarray(ids), jnp.bfloat16))
    got = _np(temb.item_lookup(tp["table"], torch.from_numpy(ids),
                               torch.bfloat16))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[~np.isnan(want)], want[~np.isnan(want)])


# -- DLRM ---------------------------------------------------------------------

def _dlrm_case(dt="f32", seed=0):
    jc = dataclasses.replace(jcfg.reduced(), compute_dtype=DTYPES[dt][0])
    tc = dataclasses.replace(tcfg.reduced(), compute_dtype=DTYPES[dt][1])
    jp = jdlrm.init(jc, jax.random.PRNGKey(seed))
    tp = convert.dlrm_params_from_arrays(
        jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _dlrm_batch(cfg, b, seed):
    r = np.random.default_rng(seed)
    return dict(
        dense=r.standard_normal((b, cfg.n_dense)).astype(np.float32),
        sparse_ids=r.integers(0, cfg.vocab_per_field,
                              (b, cfg.n_sparse)).astype(np.int32))


def _both(jfn, tfn, jc, tc, jp, tp, batch):
    want = jfn(jc, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tfn(tc, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == want.shape and got.dtype == tc.compute_dtype
    return _np(got), _np(want)


def test_interact_order_matches_reference():
    v = np.random.default_rng(5).standard_normal((3, 6, 4)).astype(np.float32)
    want = np.asarray(jdlrm._interact(jnp.asarray(v)))
    got = tdlrm._interact(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dlrm_forward_matches_reference_f32():
    jc, tc, jp, tp = _dlrm_case("f32")
    got, want = _both(jdlrm.forward, tdlrm.forward, jc, tc, jp, tp,
                      _dlrm_batch(jc, 64, 6))
    assert got.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dlrm_retrieval_matches_reference_f32():
    jc, tc, jp, tp = _dlrm_case("f32", seed=1)
    batch = _dlrm_batch(jc, 1, 7)
    batch["candidates"] = np.random.default_rng(8).integers(
        0, jc.vocab_per_field, 256).astype(np.int32)
    got, want = _both(jdlrm.retrieval_scores, tdlrm.retrieval_scores,
                      jc, tc, jp, tp, batch)
    assert got.shape == (256,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["forward", "retrieval_scores"])
def test_dlrm_matches_reference_bf16(fn):
    """Reduced widths at bf16 compute.  Measured on these inputs: the
    logits are bit-equal (max abs difference 0, logits up to 0.41 and
    0.20); the bound is atol = rtol = 3e-2, since the two frameworks may
    round bf16 products at other places."""
    jc, tc, jp, tp = _dlrm_case("bf16", seed=2)
    batch = _dlrm_batch(jc, 1 if fn != "forward" else 64, 9)
    if fn != "forward":
        batch["candidates"] = np.arange(0, 200, dtype=np.int32)
    got, want = _both(getattr(jdlrm, fn), getattr(tdlrm, fn),
                      jc, tc, jp, tp, batch)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


# -- steps and registry -------------------------------------------------------

@pytest.mark.parametrize("shape,n", [("serve_p99", 32), ("serve_bulk", 32),
                                     ("retrieval_cand", 256)])
def test_steps_build_reduced_on_cpu(shape, n):
    bundle = steps.build("dlrm-rm2", shape, reduced=True, device="cpu")
    assert bundle.kind == "serve" and bundle.model_flops_per_step > 0
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    for name, (shp, dtype) in bundle.batch_spec.items():
        assert batch[name].shape == shp and batch[name].dtype == dtype
    tops.reset_launch_counts()
    out = bundle.step_fn(params, batch)
    assert out.shape == (n,) and bool(torch.isfinite(out).all())
    assert tops.launch_counts()["embedding_bag"] == 0


def test_steps_full_config_is_dlrm_rm2():
    cfg = get_arch("dlrm-rm2").config
    assert cfg.embedding.total_rows == 26_000_000 and cfg.embed_dim == 64
    assert cfg.top_in == 415 and cfg.compute_dtype == torch.bfloat16
    assert cfg.param_count() == jcfg.full().param_count()
    assert steps._rec_dense_flops("dlrm", cfg, 1) == pytest.approx(
        1_613_440.0)


def test_rec_train_and_other_archs_are_not_ported():
    """DLRM RM2 trains (the name is from when training raised): two steps
    on one batch of the reduced ``train_batch``, the second loss below 1.5x
    the first.  Every architecture of the reference is ported now (the
    name is from when the large LMs raised): ``qwen1.5-32b``'s reduced
    ``train_4k`` builds; an arch the registry lacks raises."""
    bundle = steps.build("dlrm-rm2", "train_batch", reduced=True,
                         device="cpu")
    params = bundle.init_fn(0)
    state = ttl.init_state(bundle.opt_cfg, params)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    params, state, m1 = bundle.step_fn(params, state, batch)
    params, state, m2 = bundle.step_fn(params, state, batch)
    assert 0 < float(m2["loss"]) < 1.5 * float(m1["loss"])
    assert steps.build("qwen1.5-32b", "train_4k", reduced=True,
                       device="cpu").kind == "train"
    with pytest.raises(KeyError, match="unknown arch"):
        steps.build("no-such-arch", "train_4k", reduced=True, device="cpu")
