"""The port's training step against the JAX package's, for every
architecture's smoke config, on the same weights and batch.

Weights are drawn by the port (a seeded ``torch.Generator``) and carried
to the reference through ``params_to_jax``; the port trains on them
through ``params_from_jax(..., for_training=True)``, so both directions
of the conversion are exercised and the two sides start equal bit for
bit.  The reference's step is ``jax.jit(make_train_step(...))``; the
gradients it hands its optimizer are read from inside it (the call is
wrapped to return them too), so one trace and compile gives the loss,
the gradients and the update.

Tolerances (fp32 smoke configs):
- loss and grad_norm: rtol 1e-5;
- each gradient leaf: |Δ| <= 1e-4 · max|g| of the leaf + 1e-7 (the
  recurrent families' scans sum longest: zamba2's ``D`` differs by
  1.3e-5 of its leaf's max);
- each updated leaf against the reference optimizer applied to the
  port's own gradients: rtol 1e-5, atol 1e-2 · lr;
- each updated leaf against the reference's step, where |g| >= 1e-4 ·
  max|g| of the leaf or g is 0 (weight decay alone moves it): rtol
  1e-5, atol 1e-2 · lr.  Elsewhere Adam's normalised step sends a
  gradient difference at the 1e-7 level (the sums' order) to an update
  difference of a share of lr: there 0.25 · lr (the largest measured is
  0.038 · lr, an MLP's ``w_up``).
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro.training import make_train_step as jax_make_train_step
import repro.models.moe as jax_moe_mod
import repro.training.train_step as jax_train_step_module

import repro_torch.kernels.flash_attention.ops as flash_ops
import repro_torch.models.moe as moe_mod
from repro_torch.configs import ARCH_IDS, get_config, smoke_batch
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.training import (greedy_generate, init_training,
                                  make_train_step)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LR = OPT["lr"]


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """The port's random smoke weights in the reference's layout."""
    cfg = get_config(arch, smoke=True)
    p = build_model(cfg, "cpu", training=True).init(
        torch.Generator().manual_seed(0))
    return params_to_jax(p, cfg)


def _port(arch, cfg=None, moments="fp32"):
    cfg = cfg or get_config(arch, smoke=True)
    params = params_from_jax(_weights(arch), cfg, "cpu", for_training=True)
    return (build_model(cfg, "cpu", training=True), params,
            init_opt_state(params, moments))


def _port_grads(model, params, batch):
    """The port's loss and gradients in the reference's layout."""
    loss = model.loss(params, batch)
    loss.backward()
    grads = copy.deepcopy(params)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), params.parameters()):
            g.copy_(p.grad)
            p.grad = None
    return float(loss.detach()), params_to_jax(grads, model.cfg)


def _close_updates(got, want, grads, what):
    """Updated leaves against the reference's step: tight where the
    gradient is well above the level of the sums' rounding or is 0
    (weight decay alone), within 0.25 · lr elsewhere (module
    docstring)."""
    for path, a, b, g in zip(_paths(want), _leaves(got), _leaves(want),
                             _leaves(grads)):
        g = np.abs(g)
        held = (g >= 1e-4 * g.max()) | (g == 0)
        np.testing.assert_allclose(a[held], b[held], rtol=1e-5,
                                   atol=1e-2 * LR, err_msg=f"{what}{path}")
        assert np.abs(a - b).max() <= 0.25 * LR, (what, path)


def _reference_step_with_grads(monkeypatch, jmodel, jcfg):
    """``repro.training.make_train_step(jmodel, jcfg)`` whose metrics also
    carry the gradients it handed the optimizer: one trace and compile
    of the reference's loss and gradient gives both."""
    real = jax_train_step_module.adamw_update

    def update(cfg, params, grads, state):
        params, state, metrics = real(cfg, params, grads, state)
        return params, state, {**metrics, "grads": grads}

    monkeypatch.setattr(jax_train_step_module, "adamw_update", update)
    return jax_make_train_step(jmodel, jcfg)


@pytest.mark.parametrize("arch,groups", [(a, None) for a in ARCH_IDS]
                         + [("qwen3-moe-235b-a22b", 2)],
                         ids=ARCH_IDS + ["qwen3-moe-grouped-g2"])
def test_train_step_matches_reference(arch, groups, monkeypatch):
    """``groups``: the MoE's grouped dispatch at that group count, pinned
    in both packages (each reads it from its rules' mesh)."""
    jcfg_model = jax_get_config(arch, smoke=True)
    cfg = None
    if groups:
        for mod in (jax_moe_mod, moe_mod):
            monkeypatch.setattr(mod, "_dp_extent", lambda r: groups)
        jcfg_model = dataclasses.replace(jcfg_model, moe_grouped=True)
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  moe_grouped=True)
    jmodel = jax_build_model(jcfg_model)
    jparams = jax.tree.map(jnp.asarray, _weights(arch))
    model, params, opt = _port(arch, cfg)
    batch = smoke_batch(model.cfg, batch=2, seq=8)
    loss, grads = _port_grads(model, params, batch)
    jcfg = JaxAdamWConfig(**OPT)
    step = _reference_step_with_grads(monkeypatch, jmodel, jcfg)

    @jax.jit
    def reference(p, s, b, port_grads):
        # the reference optimizer on the port's own gradients beside it
        return step(p, s, b), jax_adamw_update(jcfg, p, port_grads, s)[0]

    (jp, _, jm), want = reference(
        jparams, jax_init_opt_state(jparams), batch,
        jax.tree.map(jnp.asarray, grads))
    jgrads = jm["grads"]
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
    for path, a, b in zip(_paths(jgrads), _leaves(grads), _leaves(jgrads)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-7,
                                   err_msg=f"grad {path}")

    params, opt, m = make_train_step(model, AdamWConfig(**OPT))(
        params, opt, batch)
    assert float(m["loss"]) == loss
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    got = params_to_jax(params, model.cfg)
    for path, a, b in zip(_paths(want), _leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-2 * LR,
                                   err_msg=f"update {path}")
    _close_updates(got, jp, jgrads, "step ")


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_microbatched_step_matches_full_batch_and_reference(moments):
    """Gradient accumulation over 4 chunks: the full batch's loss and
    update (the reference's own test's tolerances, loss 1e-4, leaves
    rtol 2e-3 and atol 2e-5), and the reference's microbatched step."""
    arch = "granite-8b"
    batch = smoke_batch(get_config(arch, smoke=True), batch=8, seq=8)
    cfg = AdamWConfig(**OPT, moments_dtype=moments)
    model, p_full, o_full = _port(arch, moments=moments)
    _, p_micro, o_micro = _port(arch, moments=moments)
    _, _, m_full = make_train_step(model, cfg)(p_full, o_full, batch)
    _, o_micro, m_micro = make_train_step(model, cfg, microbatch=4)(
        p_micro, o_micro, batch)
    assert abs(float(m_full["loss"]) - float(m_micro["loss"])) < 1e-4
    for a, b in zip(p_full.parameters(), p_micro.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)

    jmodel = jax_build_model(jax_get_config(arch, smoke=True))
    jparams = jax.tree.map(jnp.asarray, _weights(arch))
    step = jax.jit(jax_make_train_step(
        jmodel, JaxAdamWConfig(**OPT, moments_dtype=moments), microbatch=4))
    init = jax.jit(jax_init_opt_state, static_argnums=1)
    jp, js, jm = step(jparams, init(jparams, moments), batch)
    np.testing.assert_allclose(float(m_micro["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_micro["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _, grads = _port_grads(model, params_from_jax(
        _weights(arch), model.cfg, "cpu", for_training=True), batch)
    _close_updates(params_to_jax(p_micro, model.cfg), jp, grads, "micro ")
    assert int(o_micro["step"]) == int(js["step"]) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_equal_remat_off(arch):
    """Recomputation gives the same values: the loss and every gradient
    with remat 'dots' and 'nothing' equal those with remat off, bit for
    bit, on the CPU."""
    out = {}
    for name, over in [("off", dict(remat=False)),
                       ("dots", dict(remat=True, remat_policy="dots")),
                       ("nothing", dict(remat=True, remat_policy="nothing"))]:
        cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
        model, params, _ = _port(arch, cfg)
        loss = model.loss(params, smoke_batch(cfg, batch=2, seq=8))
        loss.backward()
        out[name] = [loss.detach()] + [p.grad for p in params.parameters()]
    for name in ("dots", "nothing"):
        assert all(torch.equal(a, b) for a, b in zip(out[name], out["off"]))


class _CountProducts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the products a region runs: 2-D (``mm``), batch of one
    (``bmm`` of a projection) and batched (``bmm`` of attention, experts)."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm_b1": 0, "bmm_batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func == aten.mm.default:
            self.n["mm"] += 1
        elif func == aten.bmm.default:
            self.n["bmm_b1" if args[0].shape[0] == 1 else "bmm_batched"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["granite-8b", "qwen3-moe-235b-a22b"])
def test_remat_dots_recomputes_only_batched_products(arch):
    """The backward of 'dots' runs the products of remat off plus the
    batched ones again (attention's two per layer; the experts' three per
    MoE layer): the unbatched projections and the router were saved.
    'nothing' also runs the unbatched ones again."""
    counts = {}
    for name, over in [("off", dict(remat=False)),
                       ("dots", dict(remat=True, remat_policy="dots")),
                       ("nothing", dict(remat=True, remat_policy="nothing"))]:
        cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
        model, params, _ = _port(arch, cfg)
        loss = model.loss(params, smoke_batch(cfg, batch=2, seq=8))
        with _CountProducts() as c:
            loss.backward()
        counts[name] = c.n
    off, dots, nothing = counts["off"], counts["dots"], counts["nothing"]
    cfg = get_config(arch, smoke=True)
    per_layer = 2 + (3 if cfg.is_moe else 0)
    assert dots["bmm_batched"] - off["bmm_batched"] == \
        per_layer * cfg.n_layers
    assert dots["bmm_b1"] == off["bmm_b1"] and dots["mm"] == off["mm"]
    # the unbatched products reach aten.mm (matmul) or a bmm of batch 1
    # (einsum): 'nothing' runs more of them than remat off
    assert nothing["bmm_b1"] + nothing["mm"] > off["bmm_b1"] + off["mm"]
    assert nothing["bmm_batched"] == dots["bmm_batched"]


def test_remat_is_off_without_grad():
    cfg = dataclasses.replace(get_config("granite-8b", smoke=True),
                              remat=True)
    model, params, _ = _port("granite-8b", cfg)
    batch = smoke_batch(cfg, batch=2, seq=8)
    with torch.no_grad(), _CountProducts() as c:
        model.forward(params, batch)
    with torch.no_grad():
        want, _ = model.forward(params, batch)
    assert c.n["bmm_batched"] == 2 * cfg.n_layers
    got, _ = build_model(dataclasses.replace(cfg, remat=False), "cpu"
                         ).forward(params, batch)
    assert torch.equal(got, want)


def test_loss_decreases_on_memorisation():
    cfg = get_config("granite-8b", smoke=True)
    model = build_model(cfg, "cpu", training=True)
    params, opt = init_training(model, torch.Generator().manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=1,
                                              total_steps=100))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16)
                                             ).astype(np.int32)
    losses = []
    for _ in range(10):
        params, opt, m = step(params, opt, {"tokens": toks, "labels": toks})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5


def test_training_weights_are_fp32_and_track_gradients():
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params, opt = init_training(build_model(cfg, "cpu", training=True),
                                torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.parameters())
    assert opt["step"].dtype == torch.int32
    served = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert served.layers[0].attn.wq.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in served.parameters())
    with pytest.raises(ValueError, match="training=True"):
        init_training(build_model(cfg, "cpu"),
                      torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="do not track gradients"):
        make_train_step(build_model(cfg, "cpu"), AdamWConfig())(
            served, init_opt_state(served), smoke_batch(cfg))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fp32_stored_weights_serve_as_bf16_stored(arch):
    """Serving from a trainer's fp32 weights computes what serving from
    the same weights stored in bf16 does: every use casts to the compute
    dtype.  bf16 compute, logits and greedy tokens equal bit for bit."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.bfloat16)
    model = build_model(cfg, "cpu")
    stored16 = params_from_jax(_weights(arch), cfg, "cpu")
    stored32 = params_from_jax(_weights(arch), cfg, "cpu",
                               for_training=True)
    batch = smoke_batch(cfg, batch=2, seq=8)
    with torch.no_grad():
        a, _ = model.forward(stored16, batch)
        b, _ = model.forward(stored32, batch)
    assert torch.equal(a, b)
    if cfg.family == "encdec":
        return                  # its prompts carry frames: forward only
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    np.testing.assert_array_equal(
        greedy_generate(model, stored16, prompt, max_new=3, max_len=24),
        greedy_generate(model, stored32, prompt, max_new=3, max_len=24))


def test_flash_kernel_raises_under_autograd():
    """The kernel has no backward: with grad enabled and an input that
    requires grad it raises, naming why, before looking at the device."""
    q = torch.zeros((1, 2, 8, 16), requires_grad=True)
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention_cuda(k, k, q)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, k)       # past the check: the device


@pytest.mark.parametrize("arch", ["granite-8b", "whisper-small",
                                  "zamba2-1.2b"])
def test_train_step_never_asks_for_the_flash_kernel(arch, monkeypatch):
    """Every config trains with use_flash=False, as the reference does:
    each attention call of a train step passes use_pallas=False, so the
    kernel is reached on no device."""
    assert not any(get_config(a, smoke=s).use_flash
                   for a in ARCH_IDS for s in (False, True))
    asked = []
    real = flash_ops.attention

    def spy(*args, use_pallas=False, **kw):
        asked.append(use_pallas)
        return real(*args, use_pallas=use_pallas, **kw)

    import repro_torch.models.kernels_glue as glue
    for mod in (glue, *[__import__(f"repro_torch.models.{m}",
                                   fromlist=["x"])
                        for m in ("attention", "transformer", "whisper")]):
        if hasattr(mod, "flash_attention"):
            monkeypatch.setattr(mod, "flash_attention", spy)
    model, params, opt = _port(arch)
    make_train_step(model, AdamWConfig(**OPT))(
        params, opt, smoke_batch(model.cfg, batch=2, seq=8))
    assert asked and not any(asked)
