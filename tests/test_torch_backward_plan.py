"""The host side of ``embedding_bag_backward``'s kernel
(``src/repro_torch/kernels/csrc/embedding_bag_backward.cu``), on the CPU.

* ``backward_layout``: the load width from D and the gradient pointer's
  alignment, the lanes a row and the passes, at every width the port uses
  and at D = 17 and 50, 4 and 8 bytes past alignment.
* ``backward_plan``: the tiles cover every gradient row once, each visited
  by one warp of the persistent grid; the lanes, passes and column blocks
  cover every column once; the tile stays within a warp's byte map.
* The kernel's walk replayed on the host (:func:`_walk`, the kernel's loop
  written out in Python): tile starts by binary search, 32 positions a
  batch, each group's run-aligned share, runs left open across batches
  handed to group 0, the rows no key hits written as +0.0 afterwards.  Its
  gradient is the plain version's bit for bit, and it writes every row
  exactly once, on the cases phase 2a runs on the card.
* The wrapper refuses what the kernel does not take, before any launch.
* ``ops.embedding_bag_backward`` on the CPU (the plain version) against
  ``jax.grad`` of the reference's ``item_lookup``, bit-equal in f32 and
  bf16, on the fused fill's cases: long gaps, no live id, every row hit,
  a hot row at a tile's first and last row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recsys import embedding as jemb
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import ops as tops
from repro_torch.models.recsys import embedding as temb

SMS, PER_SM = 132, 3   # an H100's SMs; resident blocks as the card reports


@pytest.mark.parametrize("d,elem,offset,want", [
    (64, 2, 0, (8, 8, 1)),      # DLRM, MIND: 8 lanes of 16 B
    (16, 2, 0, (8, 2, 1)),      # DCN-v2
    (50, 2, 0, (2, 32, 1)),     # SASRec: 4 B, 25 of 32 lanes
    (576, 2, 0, (8, 32, 4)),    # smollm-135m: 72 vectors in 3 passes
    (64, 4, 0, (4, 16, 1)),
    (17, 4, 0, (1, 32, 1)),
    (17, 2, 0, (1, 32, 1)),
    (50, 4, 0, (2, 32, 1)),
    (576, 4, 0, (4, 32, 4)),    # 144 vectors: two column blocks
    (64, 2, 4, (2, 32, 1)),     # 4 bytes past alignment
    (64, 2, 8, (4, 16, 1)),     # 8 bytes past
    (64, 4, 4, (1, 32, 4)),
    (64, 4, 8, (2, 32, 1)),
])
def test_backward_layout_from_width_and_alignment(d, elem, offset, want):
    vec, lanes, passes = tbag.backward_layout(d, elem, 256 + offset)
    assert (vec, lanes, passes) == want
    assert vec * elem <= 16 and d % vec == 0 and (256 + offset) % (
        vec * elem) == 0


@pytest.mark.parametrize("vocab,d,elem", [
    (26_000_000, 64, 2), (26_000_000, 16, 2), (1_000_000, 50, 2),
    (1_000_000, 64, 2), (49_152, 576, 2), (3_000, 16, 4), (3_001, 64, 2),
    (1, 17, 4), (100_003, 17, 2), (1_000_000, 576, 4), (5, 4096, 4),
])
def test_backward_plan_covers_every_row_and_column_once(vocab, d, elem):
    layout = tbag.backward_layout(d, elem, 0)
    plan = tbag.backward_plan(vocab, d, layout, SMS, PER_SM)
    rows = plan.rows_per_tile
    assert 1 <= rows <= tbag.BACKWARD_MAX_TILE_ROWS
    assert rows == 1 or rows * 4 * d <= tbag.BACKWARD_TILE_BYTES
    assert (plan.tiles - 1) * rows < vocab <= plan.tiles * rows
    resident = SMS * PER_SM
    assert 1 <= plan.blocks <= resident
    if rows * 4 * d >= 2 * tbag.BACKWARD_MIN_TILE_BYTES and rows * 2 <= min(
            tbag.BACKWARD_MAX_TILE_ROWS, tbag.BACKWARD_TILE_BYTES // (4 * d)):
        # halved: the base tile would leave warps without two tiles
        assert -(-vocab // (2 * rows)) < 2 * resident * tbag.BACKWARD_WARPS
    warps = plan.blocks * tbag.BACKWARD_WARPS
    visits = np.zeros(plan.tiles, np.int64)
    for w in range(min(warps, plan.tiles)):
        visits[w::warps] += 1
    assert (visits == 1).all()
    # lane l of a group: vectors cb + l + j * lanes, j < passes
    cover = np.zeros(d, np.int64)
    nv = d // plan.vec
    for cb in range(0, nv, plan.passes * plan.lanes_per_row):
        for lane in range(plan.lanes_per_row):
            for j in range(plan.passes):
                vi = cb + lane + j * plan.lanes_per_row
                if vi < nv:
                    cover[vi * plan.vec:(vi + 1) * plan.vec] += 1
    assert (cover == 1).all()
    # the zero fill's granules never straddle a row
    zw = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    assert d % zw == 0


def _first(starts, at, n):
    """The first run start at or after ``at`` among ``n`` positions."""
    hit = np.nonzero(starts[at:n])[0] if at < n else []
    return at + int(hit[0]) if len(hit) else n


def _walk(ids, mask, g, vocab, row_dtype, plan):
    """The kernel's walk, on the host, with the plain version's arithmetic
    (f32 products and sums, each rounded to ``row_dtype``): the gradient
    (NaN where nothing was written) and how often each row was written."""
    key, order = (x.numpy() for x in tbag.sort_slots(ids, vocab))
    bag = ids.shape[1]
    d = g.shape[1]
    rows = plan.rows_per_tile
    lanes = plan.lanes_per_row
    tile_starts = np.searchsorted(
        key, np.minimum(np.arange(plan.tiles + 1) * rows, vocab), "left")
    gf = g.to(torch.float32)
    w = None if mask is None else mask.reshape(-1).to(torch.float32)
    out = torch.full((vocab, d), float("nan"))
    writes = np.zeros(vocab, np.int64)

    def rnd(x):
        return x.to(row_dtype).to(torch.float32)

    def store(row, acc):
        out[row] = acc
        writes[row] += 1

    for tile in range(plan.tiles):
        r0 = tile * rows
        nrows = min(rows, vocab - r0)
        lo, hi = int(tile_starts[tile]), int(tile_starts[tile + 1])
        hit = np.zeros(nrows, bool)
        acc = {}             # group -> [row in the tile, running sum]
        carry, prev = -1, -1
        for p0 in range(lo, hi, 32):
            n = min(32, hi - p0)
            k = key[p0:p0 + n].astype(np.int64)
            starts = k != np.concatenate([[prev], k[:-1]])
            prev = int(k[-1])
            hit[k - r0] = True
            if carry >= 0:
                if starts[0]:
                    store(r0 + acc[carry][0], acc.pop(carry)[1])
                else:
                    acc[0] = acc.pop(carry)
            for gi in range(32 // lanes):
                c0 = 0 if gi == 0 else _first(starts, gi * lanes, n)
                c1 = _first(starts, (gi + 1) * lanes, n)
                for q in range(c0, c1):
                    if starts[q]:
                        if gi in acc:
                            store(r0 + acc[gi][0], acc[gi][1])
                        acc[gi] = [int(k[q]) - r0, torch.zeros(d)]
                    s = int(order[p0 + q])
                    x = gf[s // bag]
                    if w is not None:
                        x = x * w[s]
                    acc[gi][1] = rnd(acc[gi][1] + rnd(x))
            last = int(np.nonzero(starts)[0][-1]) if starts.any() else 0
            holder = last // lanes
            more = n == 32 and p0 + 32 < hi
            for gi in sorted(acc):
                if not (more and gi == holder):
                    store(r0 + acc[gi][0], acc.pop(gi)[1])
            carry = holder if more else -1
        assert not acc
        for r in np.nonzero(~hit)[0]:
            store(r0 + int(r), torch.zeros(d))
    return out, writes


def _case(name, rng):
    """``(ids, mask, grad_out, vocab)`` of phase 2a's fused-fill cases, at
    a size the host walk covers quickly."""
    vocab, rows, bag, d = 700, 1500, 1, 16
    ids = rng.integers(-vocab, vocab, (rows, bag))
    if name == "hot_crosses_batches":
        ids.flat[rng.choice(ids.size, 1000, replace=False)] = 7
    elif name == "bags_of_8_masked":
        rows, bag = 300, 8
        ids = rng.integers(0, vocab, (rows, bag))
        ids.flat[rng.choice(ids.size, 500, replace=False)] = 400
    elif name == "sparse":
        vocab = 200_000
        ids = rng.integers(0, vocab, (rows, bag))
    elif name == "ends_untouched":
        ids = rng.integers(1, vocab - 1, (rows, bag))
    elif name == "every_row":
        ids = np.concatenate([rng.permutation(vocab), rng.integers(
            0, vocab, rows - vocab)]).reshape(rows, bag)
    elif name == "no_live_id":
        ids = np.where(rng.random((rows, bag)) < 0.5, vocab + 3, -vocab - 9)
    elif name == "hot_at_tile_edges":
        ids.flat[rng.choice(ids.size, 600, replace=False)] = 256
        ids.flat[rng.choice(ids.size, 400, replace=False)] = 255
    elif name == "d17":
        d = 17
    elif name == "d50":
        d = 50
    ids.flat[:3] = [vocab, -vocab - 1, 2**31 - 1]
    g = rng.integers(-1024, 1025, (rows, d)).astype(np.float32) / 1024.0
    mask = (rng.choice(np.float32([0.0, 0.5, 1.0]), (rows, bag))
            if name == "bags_of_8_masked" else None)
    return (torch.from_numpy(ids.astype(np.int32)),
            None if mask is None else torch.from_numpy(mask),
            torch.from_numpy(g), vocab)


CASES = ("hot_crosses_batches", "bags_of_8_masked", "sparse",
         "ends_untouched", "every_row", "no_live_id", "hot_at_tile_edges",
         "d17", "d50")


@pytest.mark.parametrize("row_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_matches_the_plain_version(name, row_dtype):
    """Every group layout the card sees (2 lanes a row at D = 16 in bf16,
    4 in f32, whole warps at D = 17 and 50) on tiles of 256
    rows, so a hot row sits at a tile's last and first row."""
    ids, mask, g, vocab = _case(name, np.random.default_rng(CASES.index(name)))
    want = tbag.embedding_bag_backward_plain(ids, mask, g, vocab,
                                             row_dtype=row_dtype)
    for g_dt in (torch.float32, torch.bfloat16):
        gg = g.to(g_dt)
        layout = tbag.backward_layout(g.shape[1], gg.element_size(), 0)
        plan = tbag.BackwardPlan(*layout, 256, -(-vocab // 256), 1)
        got, writes = _walk(ids, mask, gg, vocab, row_dtype, plan)
        assert (writes == 1).all()
        want_g = tbag.embedding_bag_backward_plain(ids, mask, gg, vocab,
                                                   row_dtype=row_dtype)
        assert torch.equal(got.view(torch.int32), want_g.view(torch.int32))
    untouched = ~torch.isin(torch.arange(vocab), tbag.sort_slots(ids, vocab)[0])
    assert torch.equal(want[untouched].view(torch.int32),
                       torch.zeros_like(want[untouched]).view(torch.int32))


def test_kernel_walk_tile_plan_as_launched():
    """The same walk on the plan the wrapper computes for a small launch
    (tiles halved to 4 KB), a run of 300 crossing ten batches."""
    rng = np.random.default_rng(5)
    vocab, d = 3001, 64
    ids = rng.integers(0, vocab, (4000, 1))
    ids[100:400] = 1024
    ids = torch.from_numpy(ids.astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((4000, d)).astype(
        np.float32)).to(torch.bfloat16)
    layout = tbag.backward_layout(d, 2, 0)
    plan = tbag.backward_plan(vocab, d, layout, SMS, PER_SM)
    assert plan.rows_per_tile * 4 * d == tbag.BACKWARD_MIN_TILE_BYTES
    got, writes = _walk(ids, None, g, vocab, torch.bfloat16, plan)
    assert (writes == 1).all()
    want = tbag.embedding_bag_backward_plain(ids, None, g, vocab,
                                             row_dtype=torch.bfloat16)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bad", [
    "mask_dtype", "mask_shape", "grad_dtype", "grad_rows", "grad_1d",
    "row_dtype", "ids_1d", "out_shape", "out_dtype", "out_misaligned",
    "out_strided"])
def test_wrapper_rejects_bad_inputs(bad):
    """Each raises ``ValueError`` before a sort, a build or a launch (so on
    a machine with no card and no nvcc too)."""
    ids = torch.zeros((6, 2), dtype=torch.int32)
    mask = torch.ones((6, 2))
    g = torch.zeros((6, 8))
    kw = dict(row_dtype=torch.float32)
    vocab = 5
    if bad == "mask_dtype":
        mask = mask.double()
    elif bad == "mask_shape":
        mask = mask[:, :1]
    elif bad == "grad_dtype":
        g = g.half()
    elif bad == "grad_rows":
        g = g[:5]
    elif bad == "grad_1d":
        g = g.reshape(-1)
    elif bad == "row_dtype":
        kw["row_dtype"] = torch.float16
    elif bad == "ids_1d":
        ids = ids.reshape(-1)
    elif bad == "out_shape":
        kw["out"] = torch.empty((vocab + 1, 8))
    elif bad == "out_dtype":
        kw["out"] = torch.empty((vocab, 8), dtype=torch.float64)
    elif bad == "out_misaligned":
        kw["out"] = torch.empty(vocab * 8 + 1)[1:].view(vocab, 8)
    elif bad == "out_strided":
        kw["out"] = torch.empty((8, vocab)).t()
    with pytest.raises(ValueError):
        tbag.embedding_bag_backward_cuda(ids, mask, g, vocab, **kw)


def test_wrapper_rejects_more_slots_than_32_bits():
    ids = torch.empty((2**31 - 64, 1), dtype=torch.int32, device="meta")
    g = torch.empty((2**31 - 64, 4), device="meta")
    with pytest.raises(ValueError, match="32-bit"):
        tbag.embedding_bag_backward_cuda(ids, None, g, 10)


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["sparse", "no_live_id", "every_row",
                                  "hot_at_tile_edges", "d17"])
def test_ops_backward_matches_jax_grad_on_fill_cases(name, dt):
    """``ops.embedding_bag`` under autograd on the CPU (the plain backward)
    against ``jax.grad`` of the reference's ``item_lookup``, bit for bit."""
    ids, _, g, vocab = _case(name, np.random.default_rng(40 + len(name)))
    ids = ids.numpy()
    d = g.shape[1]
    table = np.random.default_rng(3).standard_normal((vocab, d)).astype(
        np.float32)
    out, vjp = jax.vjp(lambda t: jemb.item_lookup(t, jnp.asarray(ids),
                                                  JDT[dt]),
                       jnp.asarray(table))
    cot = g.numpy().reshape(ids.shape + (d,))
    want = np.asarray(vjp(jnp.asarray(cot).astype(out.dtype))[0])
    t = torch.from_numpy(table).requires_grad_(True)
    got_out = temb.item_lookup(t, torch.from_numpy(ids), dt)
    tops.reset_launch_counts()
    (got,) = torch.autograd.grad(got_out, t, torch.from_numpy(cot).to(dt))
    assert tops.launch_counts()["embedding_bag_backward"] == 0
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
