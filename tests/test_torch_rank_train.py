"""The reduced large LMs one shard a process (``RankMesh``) against the
stacked ``ShardMesh``, on the CPU.

One module fixture spawns four gloo ranks (``tests/torch_rank_train_worker
.py``), which join through a ``file://`` store and run the reduced dbrx
(capacity 1.0, so slots drop; remat on), grok (two experts split in two,
``ep_split`` 2), qwen (4 heads, QKV biases; remat on) and command-r (6
heads over 2 kv heads, its loss in chunks; 2 x 2 only) on 2 x 2 and 1 x 4
meshes: ``forward``, ``loss_fn``, ``decode_step`` at B = 2 (a token a
data shard) and B = 1 (replicated), the gradients of ``loss_fn`` and one
``make_train_step(mesh=)`` step of two microbatches under the large LMs'
published rules (fp8 ``mu``, bf16 ``nu``, bf16 accumulator).  Each rank
holds its block of every leaf in the reference's 2-D layout
(``sharding.rank_param_specs``: ``wq``/``wk``/``wv`` and the FFN's gate
and up column parallel over ``model``, ``wo`` and ``w_down`` row
parallel, every large leaf FSDP over ``data``, the embedding and head
split by the vocabulary) and its data shard's rows of each batch.

Everything is held bit for bit against the stacked mesh's result for the
rank's shard: no sum in a rank's backward runs in another order than the
stacked autograd's.  A value fanned out to the model shards (a normed
residual stream) has its cotangents summed over their stack on the
stacked mesh and over the gathered blocks on a rank, the same sum; a
weight gathered over ``data`` has its cotangents reduce-scattered in
shard order; the gates' and dispatch buffer's cotangents are gathered
over ``model`` from shards whose parts do not overlap (a sum with
zeros).  So a leaf whose gradient came out a whole multiple of the
stacked one (a cotangent summed once a shard) fails as any other
difference does.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_rank_train_worker as worker
from repro_torch.distributed import ShardMesh, sharding
from repro_torch.launch import ranks as ranks_mod
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = [(label, shape) for label in worker.CASES
         for shape in worker.meshes(label)]
IDS = [f"{label}-{shape[0]}x{shape[1]}" for label, shape in CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("rank_train")
    got, seconds = worker.run_ranks(out, timeout_s=120.0,
                                    join_timeout_s=300.0)
    return dict(ranks=got, seconds=seconds)


_STACKED = {}


def _stacked(label, shape):
    if (label, shape) not in _STACKED:
        _STACKED[label, shape] = worker.stacked(label, shape)
    return _STACKED[label, shape]


def _specs(label, shape=(2, 2)):
    cfg = worker.config(label)
    whole = tfm.init(cfg, worker.SEED, device="cpu")
    return dict(ranks_mod.leaf_paths(sharding.rank_param_specs(
        whole, cfg, ShardMesh(*shape, device="cpu"))))


def _mine(value, spec, shape, rank):
    """The rank's block of a stacked (whole) value under ``spec``."""
    if spec is None or sharding.is_replicated(spec):
        return value
    d, m = divmod(rank, shape[1])
    return sharding.shard(torch.from_numpy(value), spec,
                          ShardMesh(*shape, device="cpu"))[d, m].numpy()


def _equal(a, b):
    return a.shape == b.shape and np.array_equal(a, b)


def _check(ranks, label, shape, prefixes):
    want = _stacked(label, shape)
    specs = _specs(label, shape)
    tag = f"{label}/{shape[0]}x{shape[1]}/"
    seen = 0
    for r, got in enumerate(ranks["ranks"]):
        for k, v in want.items():
            if not k.startswith(prefixes) or k.endswith("@dtype"):
                continue
            head, _, name = k.partition("/")
            spec = specs.get(name) if head in ("grad", "grad3", "param",
                                               "mu", "nu") else None
            assert _equal(got[tag + k], _mine(v, spec, shape, r)), (r, k)
            assert str(got[tag + k + "@dtype"]) == str(want[k + "@dtype"])
            seen += 1
    return seen


@pytest.mark.parametrize("label,shape", CASES, ids=IDS)
def test_rank_forward_loss_and_decode_match_stacked(ranks, label, shape):
    """The hidden states and aux of ``forward``, the loss and its parts,
    and every decode step's logits, on every rank."""
    seen = _check(ranks, label, shape,
                  ("h", "aux", "loss", "ce", "decode/"))
    assert seen == 4 * (5 + sum(n for _, n in ranks_mod.CASE_DECODE))


@pytest.mark.parametrize("label,shape", CASES, ids=IDS)
def test_rank_gradients_match_stacked(ranks, label, shape):
    """Each leaf's gradient (an expert stack's: the rank's block), none
    zero; and at 3 tokens, which do not split over ``data`` (each data
    shard routes all of them, the output is the first's)."""
    seen = _check(ranks, label, shape, ("grad/", "grad3/"))
    assert seen == 2 * 4 * len(_specs(label, shape))
    tag = f"{label}/{shape[0]}x{shape[1]}/grad/"
    for got in ranks["ranks"]:
        for k in got:
            if k.startswith(tag) and not k.endswith("@dtype") and (
                    "layers/" in k):
                assert np.abs(got[k]).max() > 0, k


@pytest.mark.parametrize("label,shape", CASES, ids=IDS)
def test_rank_train_step_matches_stacked(ranks, label, shape):
    """One step of two microbatches (bf16 accumulator): the loss,
    ``grad_norm`` (taken over every rank's blocks, each replicated leaf
    once), the parameters and both moments in their dtypes."""
    seen = _check(ranks, label, shape,
                  ("step_loss", "grad_norm", "param/", "mu/", "nu/"))
    assert seen == 4 * (2 + 3 * len(_specs(label, shape)))
    got = ranks["ranks"][0]
    tag = f"{label}/{shape[0]}x{shape[1]}/"
    gate = "layers/w_gate" + ("" if worker.config(label).moe else "/w")
    assert str(got[f"{tag}mu/{gate}@dtype"]) == "torch.float8_e4m3fn"
    assert str(got[f"{tag}nu/{gate}@dtype"]) == "torch.bfloat16"
    assert np.mean(got[f"{tag}mu/{gate}"] != 0) > 0.2


@pytest.mark.parametrize("label,shape", CASES, ids=IDS)
def test_rank_params_digest_matches_stacked(ranks, label, shape):
    """``launch.ranks.params_digest`` of the stepped parameters (each
    expert stack's distinct blocks in shard order) is the stacked mesh's
    on every rank."""
    seen = _check(ranks, label, shape, ("digest",))
    assert seen == 4


def test_grok_1x4_holds_one_virtual_expert_a_rank(ranks):
    cfg = worker.config("grok")
    assert cfg.moe.n_experts * cfg.moe.ep_split == 4
    got = ranks["ranks"][2]["grok/1x4/param/layers/w_gate"]
    assert got.shape == (cfg.n_layers, 1, cfg.d_model,
                         cfg.d_ff // cfg.moe.ep_split)
    got = ranks["ranks"][2]["dbrx_cf1/2x2/param/layers/w_down"]
    cfg = worker.config("dbrx_cf1")
    assert got.shape == (cfg.n_layers, 2, cfg.d_ff, cfg.d_model // 2)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_rank_holds_its_blocks_of_the_2d_layout(ranks, shape):
    """After ``steps.build(mesh=)``'s ``init_fn`` on a rank, every leaf of
    the reduced qwen is its ``block_shape`` under
    ``sharding.rank_param_specs`` (the norms whole, every other leaf a
    block), and the rank's bytes are ``per_device_bytes``'s."""
    cfg = worker.config(worker.HOLDS)
    mesh = ShardMesh(*shape, device="cpu")
    whole = tfm.init(cfg, worker.SEED, device="cpu")
    specs = sharding.rank_param_specs(whole, cfg, mesh)
    assert specs == tfm.param_specs(cfg, mesh)
    spec_of = dict(ranks_mod.leaf_paths(specs))
    tag = f"holds/{shape[0]}x{shape[1]}/"
    n_sharded = 0
    for got in ranks["ranks"]:
        for path, leaf in ranks_mod.leaf_paths(whole):
            want = sharding.block_shape(leaf.shape, spec_of[path], mesh)
            assert tuple(got[f"{tag}shape/{path}"]) == want, path
            n_sharded += want != tuple(leaf.shape)
        assert int(got[tag + "bytes"]) == sharding.per_device_bytes(
            whole, specs, mesh)
    assert n_sharded == 4 * (len(spec_of) - 3)   # all but the three norms


@pytest.mark.parametrize("label", [*worker.CASES, worker.SMALL])
def test_rank_train_bundle_matches_stacked(ranks, label):
    """``launch.ranks.train_once`` (``steps.build(mesh=)``, whose
    ``init_fn`` keeps each rank's blocks as the stacks are drawn; a small
    LM's leaves whole) on 2 x 2 ranks: the loss, ``grad_norm`` and
    parameter digest of the stacked bundle's step."""
    want = worker.stacked_train_once(label)
    for got in ranks["ranks"]:
        for k, v in want.items():
            assert _equal(got[f"{label}/train_once/{k}"], v), k


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_small_lm_on_a_mesh_is_whole_and_matches_one_device(shape):
    """A small LM (``lm_is_small``: smollm-135m) on a mesh keeps every leaf
    whole, as the reference does, and splits its rows over ``data``
    (``transformer.data_parallel_loss_fn``): the stacked mesh's loss is
    within 1e-5 of the one-device bundle's and each leaf's gradient
    within 1e-5 of its norm (the sums over ``data`` round otherwise)."""
    from repro_torch.launch import steps
    from repro_torch.training import train_loop
    from repro_torch.tree import tree_leaves

    mesh = ShardMesh(*shape, device="cpu")
    on_mesh = ranks_mod.train_bundle(mesh, worker.SMALL, reduced=True)
    alone = steps.build(worker.SMALL, "train_4k", reduced=True,
                        device="cpu", published_rules=True)
    assert all(sharding.is_replicated(s) for s in
               sharding._spec_leaves(on_mesh.param_specs))
    params = alone.init_fn(worker.SEED)
    batch = alone.make_batch(torch.Generator().manual_seed(worker.SEED + 1))
    assert sharding.batch_split(batch["tokens"].shape[0], mesh)
    want = train_loop.value_and_grad(alone.loss_fn)(params, batch)
    got = train_loop.value_and_grad(on_mesh.loss_fn)(params, batch)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    for g, w in zip(tree_leaves(got[2]), tree_leaves(want[2])):
        assert float((g - w).norm()) <= 1e-5 * float(w.norm()) + 1e-12


def test_ranks_cli_stacked_train_prints_the_ranks_digest(ranks):
    """``python -m repro_torch.launch.ranks --train ... --stacked``: the
    same digest, loss and ``grad_norm`` as the ranks' bundle step."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.ranks", "--device", "cpu",
         "--data", "2", "--model", "2", "--train", "grok-1-314b",
         "--reduced", "--stacked"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    got = ranks["ranks"][0]
    assert line["params_digest"] == bytes(
        got["grok/train_once/digest"]).hex()
    assert np.float32(line["loss"]) == got["grok/train_once/loss"]
    assert np.float32(line["grad_norm"]) == got["grok/train_once/grad_norm"]
    assert line["mu"] == "float8_e4m3fn" and line["nu"] == "bfloat16"
