"""The port's train steps (``repro_torch.launch.steps``, ``training/``)
against the JAX package's jitted ``train_loop.make_train_step``.

Each of the five train cells at its reduced config: the reference's
parameters (carried across with ``convert.params_from_arrays``) and
batches, 3 steps on both sides from the same state.  Compared each step:

* the loss and ``grad_norm`` within 1e-5 relative in f32 (3e-2 in bf16),
  ``lr`` within 2 f32 ulp (XLA's and PyTorch's ``cos`` and ``pow`` differ
  by an ulp);
* each gradient leaf (the port's ``train_loop.value_and_grad`` against
  ``jax.value_and_grad`` at each side's own parameters) within 1e-5 of the
  leaf's L2 norm in f32 (3e-2 in bf16);
* the parameters: within 1e-5 absolute, except where some step's
  reference gradient is below 1e-6 of its leaf's largest (in bf16: below
  3e-2 of it, the gradients' own tolerance): Adam scales such an
  element's rounding noise to a step of up to ``lr`` in either direction,
  so there the allowance is 2 ``lr`` a step (summed over the steps).

Also: ``microbatches=2``, a ``bf16_ef`` compression ``grad_transform``,
``loss_chunk`` and ``remat`` on the LM, and the bundles' specs, flops,
moment dtypes and microbatch counts at full size, computed without
allocating.  The bf16 compute case (3e-2, the reference run op by op) is
in ``tests/test_torch_training.py``.  The side-by-side runner is
``tests/torch_train_parity.py``.
"""

import dataclasses
import functools

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.launch import steps
from repro_torch.models import transformer as ttfm
from repro_torch.training import train_loop as ttl
from repro_torch.tree import tree_leaves
from torch_train_parity import CELLS, run_against_reference

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", list(CELLS))
def test_train_steps_match_reference(arch):
    run_against_reference(arch)


def test_train_step_microbatches_match_reference():
    run_against_reference("dlrm-rm2", microbatches=2)


def test_train_step_bf16_ef_compression_matches_reference():
    run_against_reference("dcn-v2", compress="bf16_ef")


@pytest.mark.parametrize("arch,overrides", [
    ("smollm-135m", dict(loss_chunk=8)),
    ("smollm-135m", dict(remat=True)),
])
def test_lm_train_step_variants_match_reference(arch, overrides):
    run_against_reference(arch, overrides=overrides)


def test_lm_remat_gives_the_same_bits():
    """``remat`` recomputes each layer in the backward: the same values."""
    cfg = get_arch("smollm-135m").reduced
    params = ttfm.init(cfg, 0, device="cpu")
    bundle = steps.build("smollm-135m", "train_4k", reduced=True,
                         device="cpu")
    batch = bundle.make_batch(torch.Generator().manual_seed(2))
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        outs.append(ttl.value_and_grad(functools.partial(ttfm.loss_fn, c))(
            params, batch))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(tree_leaves(outs[0][2]), tree_leaves(outs[1][2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(CELLS))
def test_train_bundles_match_reference_at_full_size(arch):
    """Batch specs, flops, the optimizer config and its moment dtypes and
    the microbatch count of the full-size train cell, without allocating
    (the bundles are built, nothing is initialized)."""
    jb = jsteps.build(jget_arch(arch), CELLS[arch])
    tb = steps.build(arch, CELLS[arch], device="cpu")
    assert tb.kind == jb.kind == "train"
    dt = {"float32": torch.float32, "int32": torch.int32,
          "bfloat16": torch.bfloat16}
    assert {k: (tuple(v.shape), dt[jnp.dtype(v.dtype).name]) for k, v in
            jb.batch_spec.items()} == tb.batch_spec
    assert tb.model_flops_per_step == jb.model_flops_per_step
    jo, to = jb.opt_cfg, tb.opt_cfg
    assert (to.mu_dt, to.nu_dt) == (dt[jnp.dtype(jo.mu_dt).name],
                                    dt[jnp.dtype(jo.nu_dt).name]) == (
        torch.bfloat16, torch.bfloat16)
    for f in ("lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
              "warmup_steps", "total_steps", "min_lr_ratio"):
        assert getattr(to, f) == getattr(jo, f)
    # one microbatch at these sizes: the reference's rule takes 2 above
    # 1.5e10 parameters
    cfg = get_arch(arch).config
    n = cfg.param_count()
    assert n < 1.5e10
    if arch == "smollm-135m":
        assert cfg.remat and not get_arch(arch).reduced.remat


# the published rules of the four large LMs: (parameters, microbatches,
# mu, nu, accumulator), the reference's thresholds at 1.5e10, 6e10, 1.2e11
LARGE_RULES = {
    "qwen1.5-32b": (2, torch.bfloat16, torch.bfloat16, torch.float32),
    "command-r-plus-104b": (4, torch.float8_e4m3fn, torch.bfloat16,
                            torch.bfloat16),
    "dbrx-132b": (8, torch.float8_e4m3fn, torch.bfloat16, torch.bfloat16),
    "grok-1-314b": (8, torch.float8_e4m3fn, torch.bfloat16, torch.bfloat16),
}


@pytest.mark.parametrize("layers", [None, 1, 2])
@pytest.mark.parametrize("arch", list(LARGE_RULES))
def test_large_lm_train_rules_come_from_the_published_config(arch, layers):
    """A depth-cut ``train_4k`` bundle of a large LM takes the published
    config's microbatches, moment dtypes and accumulator (its own
    ``param_count()`` at one or two layers is below every threshold), the
    same as the uncut reference bundle's; built, nothing initialized."""
    over = None if layers is None else dict(n_layers=layers)
    tb = steps.build(arch, "train_4k", device="cpu", config_overrides=over)
    mb, mu, nu, acc = LARGE_RULES[arch]
    assert (tb.microbatches, tb.opt_cfg.mu_dt, tb.opt_cfg.nu_dt,
            tb.accum_dtype) == (mb, mu, nu, acc)
    jb = jsteps.build(jget_arch(arch), "train_4k")
    dt = {"float8_e4m3fn": torch.float8_e4m3fn, "bfloat16": torch.bfloat16}
    assert (dt[jnp.dtype(jb.opt_cfg.mu_dt).name],
            dt[jnp.dtype(jb.opt_cfg.nu_dt).name]) == (mu, nu)
    if layers is not None:
        cut = dataclasses.replace(get_arch(arch).config, n_layers=layers)
        assert cut.param_count() < 1.5e10


@pytest.mark.parametrize("arch", list(LARGE_RULES))
def test_reduced_bundles_keep_their_rules_unless_published_forced(arch):
    """A reduced bundle takes the reduced config's rules (one microbatch,
    the smoke optimizer's f32 moments), as the reference's does;
    ``published_rules`` forces the published dtypes, and the published
    microbatches where they divide the reduced batch of 4."""
    tb = steps.build(arch, "train_4k", reduced=True, device="cpu")
    assert (tb.microbatches, tb.opt_cfg.mu_dt, tb.accum_dtype) == (
        1, torch.float32, torch.float32)
    fb = steps.build(arch, "train_4k", reduced=True, device="cpu",
                     published_rules=True)
    mb, mu, nu, acc = LARGE_RULES[arch]
    if acc == torch.float32:      # below 6e10: the moments are the opt's
        mu = nu = steps.SMOKE_OPT.moment_dtype
    assert (fb.microbatches, fb.opt_cfg.mu_dt, fb.opt_cfg.nu_dt,
            fb.accum_dtype) == (mb if 4 % mb == 0 else 1, mu, nu, acc)
    assert fb.opt_cfg.warmup_steps == steps.SMOKE_OPT.warmup_steps
