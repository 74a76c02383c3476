"""The dense large LMs in the reference's 2-D layout on a stacked
``ShardMesh``, against the JAX package and against the port's one-device
path, on the CPU.

The reduced qwen1.5-32b (4 heads, QKV biases; remat on) and
command-r-plus-104b (6 heads over 2 kv heads; its loss in chunks of 8)
run ``forward``, ``loss_fn`` and ``loss_fn``'s gradients with ``mesh=`` a
stacked 2 x 2 mesh: the rows split over ``data``, each layer tensor
parallel over ``model`` from weights gathered over ``data``, the lookup
and the loss split by the vocabulary.  The reference runs the same
functions jitted under ``jax.set_mesh`` on four fake host devices in a
subprocess (this file run as a script), ``act_shard`` set, its
parameters placed by its ``param_specs("lm", ...)`` and the batch by
``batch_spec_lm``.  The specs are asked for without the config: the
reduced configs are narrow enough for ``lm_is_small``, which would keep
every leaf whole, and they stand here for the published configs' layout.
Parameters come from the reference's ``init`` (biases and norm scales
made random) carried across by ``convert.params_from_arrays``.

Tolerances are ``tests/test_torch_moe.py``'s: 1e-5 on f32 outputs, each
gradient within 1e-5 of its leaf's norm.  A dense model has no per-shard
aux loss, so the mesh's outputs and gradients must also be the
one-device port's within the same bars, on 2 x 2 and (qwen) 1 x 4.
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

    from repro import configs as jconfigs
    from repro.models import transformer as jtfm
    from repro_torch import configs as tconfigs
    from repro_torch import convert
    from repro_torch.distributed import ShardMesh
    from repro_torch.models import transformer as ttfm
    from repro_torch.training import train_loop as ttl

# label -> (arch, config overrides)
CASES = {"qwen": ("qwen1.5-32b", dict(remat=True)),
         "command_r": ("command-r-plus-104b", dict(loss_chunk=8))}
BATCH = (4, 32)
TOL = 1e-5


def _configs(label):
    arch, over = CASES[label]
    return tuple(dataclasses.replace(reg.get_arch(arch).reduced, **over)
                 for reg in (jconfigs, tconfigs))


def _batch(vocab):
    r = np.random.default_rng(4)
    b, s = BATCH
    toks = r.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[2, 20:] = 0.0
    return dict(tokens=toks, labels=np.roll(toks, -1, axis=1), mask=mask)


def _params(label):
    """The reference's parameters as numpy arrays, biases and norm
    scales made random so each changes the output."""
    jc = _configs(label)[0]
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

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _reference(out_path):
    """Run in a subprocess with four fake host devices: each case's
    ``forward``, ``loss_fn`` and the gradients of its loss, jitted under
    a 2 x 2 mesh with the parameters and the batch placed by the
    reference's specs."""
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.distributed import sharding as jsharding

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    ash = jtfm.ActSharding(batch=("data",), model="model", mesh=mesh)
    out = {}
    for label in CASES:
        jc = dataclasses.replace(_configs(label)[0], act_shard=ash)
        tree = _params(label)
        jp = jax.device_put(
            jax.tree.map(jnp.asarray, tree),
            jsharding.named(mesh, jsharding.param_specs("lm", tree)))
        bspec = jsharding.batch_spec_lm(mesh, "lm_train", BATCH[0])
        b = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspec[k]))
             for k, v in _batch(jc.vocab).items()}
        with jax.set_mesh(mesh):
            h, aux = jax.jit(functools.partial(jtfm.forward, jc))(
                jp, b["tokens"])
            loss, m = jax.jit(functools.partial(jtfm.loss_fn, jc))(jp, b)
            grads = jax.jit(jax.grad(
                lambda p, bb: jtfm.loss_fn(jc, p, bb)[0]))(jp, b)
        out.update({f"{label}/h": np.asarray(h), f"{label}/aux": np.asarray(
            aux), f"{label}/loss": np.asarray(loss),
            f"{label}/ce": np.asarray(m["ce"])})
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"{label}/grad{jax.tree_util.keystr(path)}"] = np.asarray(g)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 2 x 2 results, made once a module."""
    out = tmp_path_factory.mktemp("dense_mesh") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


_PORT = {}


def _port(label, shape):
    """The port's forward, loss and gradients of ``label`` on the stacked
    ``shape`` mesh (``None``: one device), made once a test module."""
    if (label, shape) not in _PORT:
        tc = _configs(label)[1]
        tp = convert.params_from_arrays(_params(label), device="cpu")
        mesh = None if shape is None else ShardMesh(*shape, device="cpu")
        b = {k: torch.from_numpy(v) for k, v in _batch(tc.vocab).items()}
        h, aux = ttfm.forward(tc, tp, b["tokens"], mesh=mesh)
        loss, parts, grads = ttl.value_and_grad(functools.partial(
            ttfm.loss_fn, tc, mesh=mesh))(tp, b)
        _PORT[label, shape] = dict(h=h.detach(), aux=aux.detach(), loss=loss,
                                   ce=parts["ce"], grads=grads)
    return _PORT[label, shape]


def _leaf(tree, key):
    """The leaf of a nested dict at a ``keystr`` path (``['a']['b']``)."""
    for part in key.strip("[]'").split("']['"):
        tree = tree[part]
    return tree


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * min(1.0, float(np.abs(want).max())))


def _grads_close(got_tree, want_of):
    """Every leaf of ``got_tree`` within 1e-5 of the norm of
    ``want_of(keystr)``, its counterpart; returns the leaves checked."""
    n = 0
    for path, g in jax.tree_util.tree_flatten_with_path(got_tree)[0]:
        want = want_of(jax.tree_util.keystr(path))
        scale = max(float(np.linalg.norm(want)), 1e-30)
        err = float(np.linalg.norm(g.numpy() - want))
        assert err <= TOL * scale, (jax.tree_util.keystr(path), err / scale)
        n += 1
    return n


@pytest.mark.parametrize("label", list(CASES))
def test_stacked_mesh_forward_and_loss_match_reference(reference, label):
    """The hidden states (joined over ``data``), the zero aux, the loss
    and its CE on the stacked 2 x 2 mesh against the reference's under
    its mesh."""
    got = _port(label, (2, 2))
    _close(got["h"], reference[f"{label}/h"])
    assert float(got["aux"]) == float(reference[f"{label}/aux"]) == 0.0
    for k in ("loss", "ce"):
        assert float(got[k]) == pytest.approx(
            float(reference[f"{label}/{k}"]), rel=TOL), k


@pytest.mark.parametrize("label", list(CASES))
def test_stacked_mesh_gradients_match_reference(reference, label):
    """Every leaf's gradient of the loss on the stacked 2 x 2 mesh (the
    rows' CE summed over ``data`` before the divide, the vocabulary's
    ``logsumexp`` over ``model``) within 1e-5 of its norm of the
    reference's ``jax.grad`` under its mesh."""
    got = _port(label, (2, 2))["grads"]
    n = _grads_close(got, lambda k: reference[f"{label}/grad{k}"])
    assert n == len(jax.tree.leaves(got))


@pytest.mark.parametrize("label,shape", [("qwen", (2, 2)), ("qwen", (1, 4)),
                                         ("command_r", (2, 2))],
                         ids=["qwen-2x2", "qwen-1x4", "command_r-2x2"])
def test_stacked_mesh_matches_one_device(label, shape):
    """With no per-shard aux, the mesh's forward, loss and gradients are
    the one-device port's: within 1e-5."""
    got, want = _port(label, shape), _port(label, None)
    _close(got["h"], want["h"].numpy())
    for k in ("loss", "ce"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=TOL), k
    n = _grads_close(got["grads"], lambda k: _leaf(want["grads"], k).numpy())
    assert n == len(jax.tree.leaves(want["grads"]))


if __name__ == "__main__":
    import jax

    from repro import configs as jconfigs
    from repro.models import transformer as jtfm
    from repro_torch import configs as tconfigs

    _reference(sys.argv[1])
