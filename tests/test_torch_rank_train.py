"""The reduced MoE LMs one shard a process (``RankMesh``) against the
stacked ``ShardMesh``, on the CPU.

One module fixture spawns four gloo ranks (``tests/torch_rank_train_worker
.py``), which join through a ``file://`` store and run the reduced dbrx
(capacity 1.0, so slots drop; remat on) and grok (two experts split in
two, ``ep_split`` 2) on 2 x 2 and 1 x 4 meshes: ``forward``, ``loss_fn``,
``decode_step`` at B = 2 (a token a data shard) and B = 1 (replicated),
the gradients of ``loss_fn`` and one ``make_train_step(mesh=)`` step of
two microbatches under the large MoE LMs' published rules (fp8 ``mu``,
bf16 ``nu``, bf16 accumulator).  Each rank holds its block of every
expert stack and the other leaves whole (``sharding.rank_param_specs``).

Everything is held bit for bit against the stacked mesh's result for the
rank's shard: no sum in a rank's backward runs in another order than the
stacked autograd's.  The router's gradient is a sum over ``data`` of two
blocks (``a + b`` either way), an expert stack's a sum over ``data`` of
the gathered weights' cotangents in shard order (the stacked expand's
order), and the gates' and dispatch buffer's cotangents are gathered over
``model`` from shards whose parts do not overlap (a sum with zeros).  So
a leaf whose gradient came out a whole multiple of the stacked one (a
cotangent summed once a shard) fails as any other difference does.
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
CASES = [(label, shape) for label in worker.CASES for shape in worker.MESHES]
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


def _specs(label):
    whole = tfm.init(worker.config(label), worker.SEED, device="cpu")
    return dict(ranks_mod.leaf_paths(sharding.rank_param_specs(whole)))


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
    specs = _specs(label)
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
    assert seen == 2 * 4 * len(_specs(label))
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
    assert seen == 4 * (2 + 3 * len(_specs(label)))
    got = ranks["ranks"][0]
    tag = f"{label}/{shape[0]}x{shape[1]}/"
    assert str(got[tag + "mu/layers/w_gate@dtype"]) == "torch.float8_e4m3fn"
    assert str(got[tag + "nu/layers/w_gate@dtype"]) == "torch.bfloat16"
    assert np.mean(got[tag + "mu/layers/w_gate"] != 0) > 0.2


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


@pytest.mark.parametrize("label", list(worker.CASES))
def test_rank_train_bundle_matches_stacked(ranks, label):
    """``launch.ranks.train_once`` (``steps.build(mesh=)``, whose
    ``init_fn`` keeps each rank's blocks as the stacks are drawn) on 2 x 2
    ranks: the loss, ``grad_norm`` and parameter digest of the stacked
    bundle's step."""
    want = worker.stacked_train_once(label)
    for got in ranks["ranks"]:
        for k, v in want.items():
            assert _equal(got[f"{label}/train_once/{k}"], v), k


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
