"""The port's training substrate against the JAX package, on the CPU.

* ``training/optimizer.py``: ``lr_schedule`` over steps 0-120 within 1 f32
  ulp, plus, late in the decay, what one ulp of ``cos`` becomes through
  ``1 + cos`` (XLA's and PyTorch's f32 ``cos`` differ by an ulp at about
  5% of arguments, and near ``cos = -1`` the sum cancels); ``update`` on
  random trees with f32 moments, bf16 moments and fp8 ``mu`` with bf16
  ``nu``, under a clip that binds and one that does not: the moments within
  2e-6 relative in f32 (about 16 ulp: an ulp of the clip is two of ``g *
  g``, and the moments carry them over steps) or 1e-6 of the leaf's
  largest (a moment near zero is a sum whose terms cancel), or one step of their bf16
  or fp8 dtype (a value an ulp from a rounding edge), the parameters within 1e-6 relative plus ``lr`` times
  that moment step (each step's ``lr``, clip and bias corrections may
  differ by an ulp: ``pow`` and ``cos`` again); ``sgd_update`` bit-equal.
* ``distributed/compression.py``: ``bf16`` and ``bf16_ef`` bit-equal;
  ``int8_ef`` within one quantization step at a few entries (``std``
  reduces in another order, which can move a value across a rounding
  edge) and the residual correspondingly; ``wire_bytes`` equal.
* ``distributed/elastic.py``: ``plan_mesh``, ``degraded_sequence`` and
  ``StepTimer`` equal field for field.
* The plain ``embedding_bag`` backward against ``jax.grad`` of the
  reference's ``lookup``, ``bag_lookup`` (sum and mean) and
  ``item_lookup``, bit-equal in f32 and bf16, including one id repeated
  1,000 times whose bf16 sum tells a one-rounding-per-add scatter from
  one that rounds once (the reference's is the former), negative ids and
  ids outside the table.
* DLRM RM2's train step in bf16 compute, 3 steps against the reference
  run op by op (``jax.disable_jit()``: its compiled scan skips roundings)
  under the rules of ``tests/test_torch_train_steps.py`` at 3e-2.
* Checkpoints of ``(params, AdamState)`` with bf16 leaves cross-load
  between the packages both ways (``like``, ``shard_fn``).
* ``launch/train.py`` on the CPU: a run with ``--simulate-failure`` ends
  bit-equal to an uninterrupted one, and a second invocation resumes from
  the latest checkpoint.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jckpt
from repro.distributed import compression as jcomp
from repro.distributed import elastic as jel
from repro.models.recsys import embedding as jemb
from repro.training import optimizer as jopt
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import elastic as tel
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.recsys import embedding as temb
from repro_torch.training import optimizer as topt
from repro_torch.tree import tree_leaves
from torch_train_parity import run_against_reference

torch.set_num_threads(1)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float8_e4m3fn: jnp.float8_e4m3fn}


def _tree_np(rng, shapes, scale=1.0):
    return {name: (rng.standard_normal(shp) * scale).astype(np.float32)
            for name, shp in shapes.items()}


def _nested(flat):
    """A nested tree (dict of dicts and a tuple) of the flat arrays."""
    return {"b": {"w": flat["w"], "v": flat["v"]}, "a": flat["a"],
            "t": (flat["s"], flat["m"])}


SHAPES = dict(w=(64, 48), v=(48,), a=(5, 7, 3), s=(), m=(300,))


def _to_t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _f32(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- optimizer ----------------------------------------------------------------

def test_lr_schedule_matches_reference():
    cfg_j = jopt.AdamWConfig(warmup_steps=10, total_steps=100)
    cfg_t = topt.AdamWConfig(warmup_steps=10, total_steps=100)
    s = np.arange(0, 121, dtype=np.int32)
    want = np.asarray(jopt.lr_schedule(cfg_j, jnp.asarray(s)))
    got = topt.lr_schedule(cfg_t, torch.from_numpy(s)).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    # one ulp of cos (<= 2**-24 near |cos| = 1) times d lr / d cos
    cos_ulp = cfg_j.lr * 0.5 * (1 - cfg_j.min_lr_ratio) * 2.0 ** -24
    assert np.all(np.abs(got - want) <= ulp + cos_ulp)
    assert np.mean(got == want) > 0.95


@pytest.mark.parametrize("moments", ["f32", "bf16", "fp8_mu"])
@pytest.mark.parametrize("clip", [1e-3, 1e3])
def test_adamw_update_matches_reference(moments, clip):
    dts = {"f32": (torch.float32, torch.float32),
           "bf16": (torch.bfloat16, torch.bfloat16),
           "fp8_mu": (torch.float8_e4m3fn, torch.bfloat16)}[moments]
    kw = dict(mu_dtype=dts[0], nu_dtype=dts[1], grad_clip=clip,
              warmup_steps=2, total_steps=50)
    cfg_t = topt.AdamWConfig(**kw)
    cfg_j = jopt.AdamWConfig(**{**kw, "mu_dtype": JDT[dts[0]],
                                "nu_dtype": JDT[dts[1]]})
    rng = np.random.default_rng(3)
    params = _nested(_tree_np(rng, SHAPES))
    jp, tp = jax.tree.map(jnp.asarray, params), _to_t(params)
    js, ts = jopt.init(cfg_j, jp), topt.init(cfg_t, tp)
    # the relative step of the coarser moment dtype (f32: none)
    rel = {"f32": 0.0, "bf16": 2.0 ** -8, "fp8_mu": 2.0 ** -3}[moments]
    lr_sum = 0.0
    for step in range(4):
        grads = _nested(_tree_np(rng, SHAPES, scale=0.3))
        jp, js, jm = jopt.update(cfg_j, jax.tree.map(jnp.asarray, grads), js,
                                 jp)
        tp, ts, tm = topt.update(cfg_t, _to_t(grads), ts, tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        lr_sum += float(jm["lr"])
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=4 * lr_sum * rel + 1e-9)
        for dt, tl, jl in ((dts[0], ts.mu, js.mu), (dts[1], ts.nu, js.nu)):
            for a, b in zip(tree_leaves(tl), jax.tree.leaves(jl)):
                assert a.dtype == dt
                b = _f32(b)
                if dt == torch.float32:
                    step_of = 2e-6 * np.abs(b) + 1e-6 * np.abs(b).max()
                else:   # one step of the moment's dtype
                    step_of = np.spacing(np.abs(b).astype(JDT[dt])).astype(
                        np.float32)
                assert np.all(np.abs(_f32(a) - b) <= step_of)
        # the bf16 and fp8 moments are mostly bit-equal
        if moments != "f32":
            b = _f32(jax.tree.leaves(js.mu)[0])
            assert np.mean(_f32(tree_leaves(ts.mu)[0]) == b) > 0.99


# f32 values about fp8 e4m3fn's edges: subnormals (2**-9 the least),
# halfway points (ties to even), 448 (its largest), the 464 tie that
# rounds down to it and what rounds past it (the reference: NaN; a bare
# PyTorch cast: 448), infinities and NaN
FP8_EDGES = np.array(
    [0.0, -0.0, 2.0 ** -10, 1.5 * 2.0 ** -10, 2.0 ** -9, 3 * 2.0 ** -10,
     0.0029296875, 1.0625, 1.1875, 300.0, 447.0, 448.0, 449.0, 464.0,
     464.01, 465.0, 479.9, 480.0, 1e4, 1e30, np.inf, -np.inf, np.nan,
     -447.0, -465.0], np.float32)


def test_fp8_moment_cast_matches_reference():
    """``optimizer.cast_moment`` into ``float8_e4m3fn``: the reference's
    ``astype`` bit for bit, at the format's edges and on random values of
    every magnitude it spans; into bf16 the plain cast."""
    rng = np.random.default_rng(7)
    x = np.concatenate([FP8_EDGES, (rng.standard_normal(4096) * np.exp2(
        rng.uniform(-14, 10, 4096))).astype(np.float32)])
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    got = topt.cast_moment(torch.from_numpy(x), torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    got = got.view(torch.uint8).numpy()
    assert np.array_equal(got, want)
    edges = got[:len(FP8_EDGES)]
    assert int(np.sum(edges & 0x7F == 0x7F)) == 10     # NaN, either sign
    bf = topt.cast_moment(torch.from_numpy(x), torch.bfloat16)
    assert np.array_equal(bf.float().numpy(), np.asarray(
        jnp.asarray(x).astype(jnp.bfloat16)).astype(np.float32),
        equal_nan=True)


def test_adamw_update_in_row_blocks_is_the_same(monkeypatch):
    """The update of a leaf in row blocks is the whole-leaf update."""
    cfg = topt.AdamWConfig(moment_dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    p = {"t": torch.from_numpy(rng.standard_normal((50, 8)).astype(
        np.float32))}
    g = {"t": torch.from_numpy(rng.standard_normal((50, 8)).astype(
        np.float32))}
    outs = []
    for rows in (1 << 21, 7):
        monkeypatch.setattr(topt, "UPDATE_ROWS", rows)
        q = {"t": p["t"].clone()}
        st = topt.init(cfg, q)
        q, st, m = topt.update(cfg, g, st, q)
        outs.append((q["t"], st.mu["t"], st.nu["t"]))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


ELEM_SHAPES = {"lead1": (1, 4, 6, 5), "lead3": (3, 2, 6, 5), "rows": (50, 8)}


def _bits(t):
    """A tensor's bytes as integers (bf16 and fp8 compared bit for bit)."""
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 else (
        t.view(torch.int16) if t.element_size() == 2 else t)


@pytest.mark.parametrize("part", ["update", "accumulate"])
@pytest.mark.parametrize("shape", list(ELEM_SHAPES.values()),
                         ids=list(ELEM_SHAPES))
def test_adamw_update_in_element_blocks_is_the_same(monkeypatch, shape,
                                                    part):
    """Under an :data:`UPDATE_ELEMS` cap below a row's size, ``update``
    (fp8 ``mu``, bf16 ``nu``) and ``make_train_step``'s in-place bf16
    accumulation of two microbatches give the whole-leaf bits: a leaf
    whose leading axis is 1 is split along its next axes in turn, a leaf
    of more rows in runs of rows and then within a row.  ``grad_norm``
    sums the blocks' sums of squares, so its last bits follow the
    blocking: 1e-6 relative (the clip does not bind, so the update reads
    it only through a factor of 1)."""
    from repro_torch.training import train_loop as ttl

    cfg = topt.AdamWConfig(mu_dtype=torch.float8_e4m3fn,
                           nu_dtype=torch.bfloat16, b1=0.5, grad_clip=1e3)
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4,) + shape).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def loss_fn(params, batch):
        return torch.sin(params["w"][None] * batch["x"]).square().sum()

    outs = []
    for cap in (1 << 28, 12):
        monkeypatch.setattr(topt, "UPDATE_ELEMS", cap)
        n_blocks = len(list(topt.leaf_blocks(w)))
        assert n_blocks == 1 if cap > w.numel() else n_blocks > 2
        q = {"w": w.clone()}
        st = topt.init(cfg, q)
        if part == "update":
            q, st, m = topt.update(cfg, {"w": g}, st, q)
        else:
            step = ttl.make_train_step(loss_fn, cfg, microbatches=2,
                                       accum_dtype=torch.bfloat16)
            q, st, m = step(q, st, {"x": x})
        outs.append((q["w"], st.mu["w"], st.nu["w"], m["grad_norm"]))
    assert outs[0][1].dtype == torch.float8_e4m3fn
    assert float(outs[0][1].float().abs().max()) > 0
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert abs(float(outs[0][3]) - float(outs[1][3])) <= 1e-6 * float(
        outs[0][3])


def test_sgd_update_matches_reference():
    rng = np.random.default_rng(5)
    p = _nested(_tree_np(rng, SHAPES))
    g = _nested(_tree_np(rng, SHAPES))
    want = jopt.sgd_update(jax.tree.map(jnp.asarray, p),
                           jax.tree.map(jnp.asarray, g), 0.05)
    got = topt.sgd_update(_to_t(p), _to_t(g), 0.05)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(b))


# -- compression ----------------------------------------------------------------

@pytest.mark.parametrize("method", ["none", "bf16", "bf16_ef", "int8_ef"])
def test_compression_matches_reference(method):
    rng = np.random.default_rng(6)
    grads = _nested(_tree_np(rng, SHAPES, scale=1e-3))
    cj = jcomp.CompressionConfig(method=method)
    ct = tcomp.CompressionConfig(method=method)
    rj = jcomp.init(jax.tree.map(jnp.asarray, grads))
    rt = tcomp.init(_to_t(grads))
    for _ in range(3):
        qj, rj = jcomp.compress(cj, jax.tree.map(jnp.asarray, grads), rj)
        qt, rt = tcomp.compress(ct, _to_t(grads), rt)
        for leaves in zip(tree_leaves(qt), jax.tree.leaves(qj),
                          tree_leaves(rt), jax.tree.leaves(rj)):
            qa, qb, ra, rb = (np.asarray(x) for x in leaves)
            if method != "int8_ef":
                assert np.array_equal(qa, qb) and np.array_equal(ra, rb)
                continue
            # one int8 step (6 sigma / 127) at a few entries at most;
            # elsewhere the scale's own rounding (std in another order),
            # on the quantized values and on the residuals alike
            step = float(np.abs(qb).max()) / 127.0 + 1e-12
            for a, b in ((qa, qb), (ra, rb)):
                off = np.abs(a - b) > 1e-5 * np.abs(qb).max() + 1e-12
                assert np.all(np.abs(a - b) <= 1.01 * step + 1e-9)
                assert off.mean() <= 0.01
        rt = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), rj)
    assert tcomp.wire_bytes(_to_t(grads), ct) == jcomp.wire_bytes(
        jax.tree.map(jnp.asarray, grads), cj)


# -- elastic ------------------------------------------------------------------

def test_elastic_planning_matches_reference():
    for n in (1, 7, 15, 16, 17, 100, 448, 512):
        for mp in (1, 4, 16):
            for prior in (None, 4, 16, 64):
                for pods in (1, 2):
                    kw = dict(model_parallel=mp, prior_data_parallel=prior,
                              pods=pods)
                    assert dataclasses.asdict(tel.plan_mesh(n, **kw)) == \
                        dataclasses.asdict(jel.plan_mesh(n, **kw))
    for fails in ((16,), (16, 32, 64), (500,)):
        assert [dataclasses.asdict(p) for p in
                tel.degraded_sequence(512, fails, model_parallel=16)] == \
            [dataclasses.asdict(p) for p in
             jel.degraded_sequence(512, fails, model_parallel=16)]
    times = [1.0] * 10 + [3.0, 1.0, 3.0, 3.0, 3.0, 1.0] + [0.5] * 40
    tj, tt = jel.StepTimer(window=12), tel.StepTimer(window=12)
    for t in times:
        assert tt.record(t) == tj.record(t)
        assert (tt.median, tt.slow_streak) == (tj.median, tj.slow_streak)


# -- the lookups' backward ----------------------------------------------------

def _table(rng, v, d):
    return rng.standard_normal((v, d)).astype(np.float32)


def _jgrad(fn, table, g):
    """``table``'s gradient of ``fn(table)`` against the cotangent ``g``."""
    out, vjp = jax.vjp(fn, jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(g).astype(out.dtype))[0])


def _tgrad(fn, table, g):
    t = torch.from_numpy(table).requires_grad_(True)
    out = fn(t)
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(
        np.asarray(g, np.float32)).to(out.dtype))
    return grad.numpy()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_backward_sums_duplicates_as_the_reference(dt):
    """One id 1,000 times among others: the reference's scatter adds each
    bf16 update into a bf16 sum, rounding after every add (not once at
    the end); the plain backward does the same, in slot order."""
    rng = np.random.default_rng(7)
    v, d = 6, 16
    ids = rng.integers(0, v, 1300).astype(np.int32)
    ids[::13] = v + 2                                   # outside: dropped
    ids[1::13] = -2                                     # from the end
    ids[2::3] = 1                                       # ~430 repeats
    ids[:1000] = np.where(np.arange(1000) % 4 == 0, 3, ids[:1000])
    table = _table(rng, v, d)
    g = rng.standard_normal((len(ids), d)).astype(np.float32)
    jdt = JDT[dt]
    want = _jgrad(lambda t: jemb.item_lookup(t, jnp.asarray(ids), jdt),
                  table, g)
    got = _tgrad(lambda t: temb.item_lookup(t, torch.from_numpy(ids), dt),
                 table, g)
    assert np.array_equal(got, want)
    if dt == torch.bfloat16:
        # the other scheme (one rounding of the f32 sum) differs here
        gb = np.asarray(jnp.asarray(g).astype(jnp.bfloat16), np.float32)
        once = np.zeros((v, d), np.float32)
        np.add.at(once, ids[(ids >= 0) & (ids < v)], gb[(ids >= 0)
                                                       & (ids < v)])
        once = once.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert not np.array_equal(once[3], want[3])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("how", ["lookup", "bag_sum", "bag_mean", "item"])
def test_backward_matches_jax_grad_of_lookups(dt, how):
    rng = np.random.default_rng(8)
    nf, vpf, d, b, bag = 3, 40, 24, 64, 5
    jdt = JDT[dt]
    table = _table(rng, nf * vpf, d)
    if how == "item":
        ids = rng.integers(-nf * vpf, nf * vpf + 5, (b, 7)).astype(np.int32)
        jfn = lambda t: jemb.item_lookup(t, jnp.asarray(ids), jdt)  # noqa
        tfn = lambda t: temb.item_lookup(  # noqa: E731
            t, torch.from_numpy(ids), dt)
        shape = (b, 7, d)
    elif how == "lookup":
        ids = rng.integers(0, vpf, (b, nf)).astype(np.int32)
        jc, tc = (jemb.EmbeddingConfig(nf, vpf, d),
                  temb.EmbeddingConfig(nf, vpf, d))
        jfn = lambda t: jemb.lookup(jc, {"table": t}, jnp.asarray(ids),  # noqa
                                    jdt)
        tfn = lambda t: temb.lookup(tc, {"table": t},  # noqa: E731
                                    torch.from_numpy(ids), dt)
        shape = (b, nf, d)
    else:
        comb = "sum" if how == "bag_sum" else "mean"
        ids = rng.integers(0, vpf, (b, nf, bag)).astype(np.int32)
        ids[:, :, 1] = ids[:, :, 0]                     # repeats in a bag
        # dyadic weights: the mean's divisor (a sum over the bag) is exact
        # in any order, so only the backward is compared
        mask = rng.choice(np.float32([0.0, 0.5, 1.0, 0.75]), (b, nf, bag))
        jc = jemb.EmbeddingConfig(nf, vpf, d, combiner=comb)
        tc = temb.EmbeddingConfig(nf, vpf, d, combiner=comb)
        jfn = lambda t: jemb.bag_lookup(jc, {"table": t},  # noqa: E731
                                        jnp.asarray(ids), jnp.asarray(mask),
                                        jdt)
        tfn = lambda t: temb.bag_lookup(tc, {"table": t},  # noqa: E731
                                        torch.from_numpy(ids),
                                        torch.from_numpy(mask), dt)
        shape = (b, nf, d)
    g = rng.standard_normal(shape).astype(np.float32)
    tops.reset_launch_counts()
    got = _tgrad(tfn, table, g)
    assert np.array_equal(got, _jgrad(jfn, table, g))
    # the CPU path runs the plain version: no kernel launch is counted
    assert tops.launch_counts()["embedding_bag_backward"] == 0


def test_backward_plain_matches_a_direct_sum():
    """The plain backward on its own: f32 sums in slot order, masks,
    negative and outside ids, untouched rows exactly zero."""
    rng = np.random.default_rng(9)
    v, d = 50, 9
    ids = rng.integers(-v - 3, v + 3, (40, 4)).astype(np.int32)
    mask = rng.random((40, 4)).astype(np.float32)
    g = rng.standard_normal((40, d)).astype(np.float32)
    want = np.zeros((v, d), np.float32)
    for r in range(40):
        for i in range(4):
            k = ids[r, i] + (v if ids[r, i] < 0 else 0)
            if 0 <= k < v:
                want[k] += g[r] * mask[r, i]
    got = tbag.embedding_bag_backward_plain(
        torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(g),
        v).numpy()
    assert np.array_equal(got, want)
    hit = np.unique(np.where(ids < 0, ids + v, ids))
    untouched = np.setdiff1d(np.arange(v), hit)
    assert untouched.size and not got[untouched].any()


def test_gradients_are_freed_without_the_cyclic_collector():
    """A step's gradients die with their last reference: no reference
    cycle (such as a nested function calling itself in the tree walks)
    keeps a 6.66 GB table gradient alive until the cyclic collector."""
    import gc
    import weakref

    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import dlrm as tdlrm
    from repro_torch.training import train_loop as ttl

    bundle = tsteps.build("dlrm-rm2", "train_batch", reduced=True,
                          device="cpu")
    cfg = get_arch("dlrm-rm2").reduced
    params = bundle.init_fn(0)
    batch = bundle.make_batch(torch.Generator().manual_seed(1))
    gc.disable()
    try:
        _, _, grads = ttl.value_and_grad(functools.partial(
            tdlrm.loss_fn, cfg))(params, batch)
        ref = weakref.ref(grads["embedding"]["table"])
        del grads
        assert ref() is None
        state = ttl.init_state(bundle.opt_cfg, params)
        bundle.step_fn(params, state, batch)
        del state
    finally:
        gc.enable()


def test_lookup_without_grad_keeps_the_serving_call():
    """Outside grad mode, or with a table that needs no gradient, the
    lookup is the plain call (no autograd node)."""
    table = torch.randn(10, 4)
    ids = torch.tensor([[1], [2]], dtype=torch.int32)
    out = tops.embedding_bag(ids, None, table)
    assert out.grad_fn is None
    t = table.clone().requires_grad_(True)
    with torch.no_grad():
        assert tops.embedding_bag(ids, None, t).grad_fn is None
    assert tops.embedding_bag(ids, None, t).grad_fn is not None


# -- a bf16 train step ---------------------------------------------------------

def test_train_step_bf16_matches_reference_op_by_op():
    run_against_reference("dlrm-rm2", overrides=dict(compute_dtype=torch.bfloat16),
         eager=True, tol=3e-2)


# -- checkpoints --------------------------------------------------------------

def test_training_checkpoint_cross_loads_both_ways(tmp_path):
    rng = np.random.default_rng(10)
    params = {"emb": {"table": rng.standard_normal((20, 4)).astype(
        np.float32)}, "w": rng.standard_normal((4, 3)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.AdamState(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda x: (x * 0.1).astype(jnp.bfloat16), jp),
        nu=jax.tree.map(lambda x: (x * x).astype(jnp.bfloat16), jp))
    tp = _to_t(params)
    tstate = topt.AdamState(
        step=torch.tensor(7, dtype=torch.int32),
        mu=jax.tree.map(lambda x: torch.from_numpy(np.asarray(
            x.astype(jnp.float32))).to(torch.bfloat16), jstate.mu),
        nu=jax.tree.map(lambda x: torch.from_numpy(np.asarray(
            x.astype(jnp.float32))).to(torch.bfloat16), jstate.nu))
    like_t = (_to_t(jax.tree.map(np.zeros_like, params)),
              topt.init(topt.AdamWConfig(moment_dtype=torch.bfloat16),
                        tp))
    like_j = (jax.tree.map(jnp.zeros_like, jp),
              jopt.init(jopt.AdamWConfig(moment_dtype=jnp.bfloat16), jp))

    # the reference writes, the port reads (and places with shard_fn)
    jckpt.Checkpointer(str(tmp_path / "j")).save(3, (jp, jstate),
                                                 extra=dict(data_step=3))
    placed = []
    (gp, gs), extra = tckpt.Checkpointer(str(tmp_path / "j")).restore(
        3, like=like_t, shard_fn=lambda t: placed.append(1) or t)
    assert placed == [1] and extra == {"data_step": 3}
    assert isinstance(gs, topt.AdamState) and int(gs.step) == 7
    for a, b in zip(tree_leaves((gp, gs)), tree_leaves((tp, tstate))):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)

    # the port writes, the reference reads
    tckpt.Checkpointer(str(tmp_path / "t")).save(5, (tp, tstate),
                                                 extra=dict(data_step=5))
    meta = tckpt.Checkpointer(str(tmp_path / "t")).read_meta(5)
    assert meta["dtypes"].count("bfloat16") == 4       # mu and nu
    (rp, rs), _ = jckpt.Checkpointer(str(tmp_path / "t")).restore(5, like_j)
    for a, b in zip(jax.tree.leaves((rp, rs)), jax.tree.leaves((jp, jstate))):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    hit = tckpt.Checkpointer(str(tmp_path / "t")).restore_latest(like=like_t)
    assert hit is not None and hit[0] == 5 and int(hit[1][1].step) == 7


def test_async_save_copies_cpu_tensors_before_returning(tmp_path):
    ck = tckpt.Checkpointer(str(tmp_path))
    x = {"w": torch.ones(1000)}
    ck.save(0, x, blocking=False)
    x["w"].mul_(3.0)                     # an in-place update right after
    ck.wait()
    got, _ = ck.restore(0)
    assert np.all(got["w"] == 1.0)


# -- the launcher -------------------------------------------------------------

def _final(arch, shape, tmp, **kw):
    bundle = tsteps.build(arch, shape, reduced=True, device="cpu")
    logs = []
    params, state, info = ttrain.run(bundle, ckpt_dir=str(tmp),
                                     log=logs.append, **kw)
    return tree_leaves((params, state)), info, logs


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("fail_at", [3, 4])
def test_launcher_resumes_bit_equal(tmp_path, fail_at):
    want, info, _ = _final("dlrm-rm2", "train_batch", tmp_path / "a",
                           steps=6, ckpt_every=2)
    assert info["resumed_from"] is None
    got, info, logs = _final("dlrm-rm2", "train_batch", tmp_path / "b",
                             steps=6, ckpt_every=2,
                             simulate_failure=fail_at)
    assert info["restored_at_failure"] == 3       # saves at steps 1, 3, 5
    assert any("[failure injected]" in s and "MeshPlan" in s for s in logs)
    assert _same(got, want)
    # a second invocation resumes from the latest checkpoint (step 5)
    more, info, logs = _final("dlrm-rm2", "train_batch", tmp_path / "b",
                              steps=8, ckpt_every=2)
    assert info["resumed_from"] == 5 and logs[0].startswith("resumed")
    longer, _, _ = _final("dlrm-rm2", "train_batch", tmp_path / "c",
                          steps=8, ckpt_every=2)
    assert _same(more, longer)


def test_launcher_cli_on_cpu(tmp_path, capsys):
    info = ttrain.main(["--device", "cpu", "--arch", "sasrec", "--shape",
                        "train_batch", "--steps", "3", "--ckpt-every", "2",
                        "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done at step 3" in out
    assert np.isfinite(info["loss"])
    assert tckpt.Checkpointer(str(tmp_path)).latest_step() == 1
    with pytest.raises(SystemExit, match="serving shape"):
        ttrain.main(["--device", "cpu", "--arch", "sasrec", "--shape",
                     "serve_p99", "--steps", "1", "--ckpt-dir",
                     str(tmp_path / "x")])


def test_train_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--arch", "dlrm-rm2", "--shape", "train_batch",
                     "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        tsteps.build("dlrm-rm2", "train_batch", reduced=True)
