"""The port's MoE, VLM, Zamba2, xLSTM and Whisper families against the
JAX package's on the same weights.

Every comparison loads the reference's parameters into the port through
``params_from_jax``; inputs are made with numpy.  The reference runs as
its own tests run it: with ``use_flash`` its attention is the Pallas
kernel in interpret mode.  Tolerances are those of tests/test_models.py:
rtol/atol 2e-4 on logits (its decode-vs-forward checks of the recurrent
families use 5e-4, and so do their mirrors here)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.moe as jax_moe_mod
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.attention import attention_fwd as jax_attention_fwd
from repro.models.attention import init_attention as jax_init_attention
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.mamba2 import _causal_conv as jax_causal_conv
from repro.models.ssd import chunked_linear_scan as jax_chunked_linear_scan
from repro.models.ssd import segsum as jax_segsum
from repro.models.whisper import encode as jax_encode
from repro.training import greedy_generate as jax_greedy_generate

import repro_torch.models.moe as moe_mod
from repro_torch.configs import get_config, smoke_batch
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.attention import Attention, attention_fwd
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mamba2 import _causal_conv
from repro_torch.models.moe import MoE, init_moe, moe_fwd, positions, route
from repro_torch.models.ssd import (chunked_linear_scan, reference_scan,
                                    segsum)
from repro_torch.models.whisper import encode
from repro_torch.training import greedy_generate

FAMILIES = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
            "llava-next-34b", "zamba2-1.2b", "xlstm-1.3b", "whisper-small"]
TOL = dict(rtol=2e-4, atol=2e-4)
RECURRENT_TOL = dict(rtol=5e-4, atol=5e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(arch: str, use_flash: bool):
    """(reference model, its params, port model, port params).

    Whisper with ``use_flash`` is held against the reference's plain
    path: the reference's Pallas kernel sizes the cross-attention's key
    grid by the decoder's length (src/repro/kernels/flash_attention/
    kernel.py:77-89), so its flash logits attend to the wrong frames and
    differ from its own plain path by up to 0.827 on the smoke config
    (T 16, S 8).  The port's kernel sweeps all T frames: the plain
    semantics."""
    jflash = use_flash and arch != "whisper-small"
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               use_flash=jflash)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               use_flash=use_flash)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jmodel, jparams, build_model(tcfg, device="cpu"), tparams


def _assert_tree_close(got, want, path="cache"):
    """A port cache (dicts, named tuples, tensors, a Python-int length)
    against the reference's pytree of the same structure."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for name in got:
            _assert_tree_close(got[name], want[name], f"{path}.{name}")
    elif isinstance(got, tuple):
        assert type(got).__name__ == type(want).__name__, path
        for i, (g, w) in enumerate(zip(got, want, strict=True)):
            _assert_tree_close(g, w, f"{path}[{i}]")
    elif isinstance(got, int):
        assert got == int(want), path
    else:
        assert tuple(got.shape) == tuple(np.shape(want)), path
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **TOL,
                                   err_msg=path)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch, use_flash):
    jmodel, jparams, tmodel, tparams = _pair(arch, use_flash)
    batch = smoke_batch(tmodel.cfg, batch=2, seq=16)
    want, jaux = jmodel.forward(jparams, batch)
    got, aux = tmodel.forward(tparams, batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    np.testing.assert_allclose(float(tmodel.loss(tparams, batch)),
                               float(jmodel.loss(jparams, batch)), **TOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax(arch, use_flash):
    """Prefill logits and cache, then two decode steps' logits and cache:
    the recurrent families' zero-state prefill included."""
    jmodel, jparams, tmodel, tparams = _pair(arch, use_flash)
    batch = smoke_batch(tmodel.cfg, batch=2, seq=8, seed=1)
    batch.pop("labels")
    want, jcache = jmodel.prefill(jparams, batch, 12)
    got, cache = tmodel.prefill(tparams, batch, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_tree_close(cache, jcache)
    for _ in range(2):
        nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, nxt, jcache)
        got, cache = tmodel.decode_step(tparams, nxt, cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _assert_tree_close(cache, jcache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_generate_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch, False)
    batch = smoke_batch(tmodel.cfg, batch=2, seq=8, seed=2)
    batch.pop("labels")
    want = jax_greedy_generate(jmodel, jparams, batch, max_new=5,
                               max_len=16)
    got = greedy_generate(tmodel, tparams, batch, max_new=5, max_len=16)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_decode_matches_forward(arch):
    """The reference's test_decode_matches_forward_zamba/_xlstm on the
    port: the whole sequence decoded token by token from an empty cache
    reproduces the full-sequence logits."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 8)).astype(
        np.int32)
    full_logits, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(1, 8)
    for t in range(7):
        logits, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full_logits[:, t].numpy(),
                                   **RECURRENT_TOL)
    assert cache["length"] == 7


def test_decode_matches_forward_whisper():
    """Teacher-forced decode after a one-token prefill reproduces the
    decoder's full-sequence logits (the self cache grows, the cross
    cache holds the encoded frames)."""
    cfg = get_config("whisper-small", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = smoke_batch(cfg, batch=2, seq=8, seed=3)
    full_logits, _ = model.forward(params, batch)
    _, cache = model.prefill(params, {"frames": batch["frames"],
                                      "tokens": batch["tokens"][:, :1]}, 8)
    for t in range(1, 8):
        logits, cache = model.decode_step(params,
                                          batch["tokens"][:, t:t + 1], cache)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full_logits[:, t].numpy(), **TOL)


# ------------------------------------------------------------------ MoE
def _moe_cfg(**kw) -> tuple[JaxModelConfig, ModelConfig]:
    """The reference's test MoE configuration, in both packages."""
    base = dict(arch_id="m", family="moe", n_layers=1, d_model=16,
                n_heads=2, n_kv_heads=2, d_ff=0, vocab=32, n_experts=4,
                top_k=2, moe_d_ff=32, moe_every=1, remat=False)
    base.update(kw)
    return (JaxModelConfig(**base, dtype=jnp.float32),
            ModelConfig(**base, dtype=torch.float32))


def _moe_pair(jcfg, tcfg, seed=0):
    from repro.models.moe import init_moe as jax_init_moe
    jp = jax_init_moe(jax.random.key(seed), jcfg)
    p = jax.tree.map(np.asarray, jp)
    tp = MoE(*(_t(p[n]) for n in ("router", "w_gate", "w_up", "w_down")))
    if "shared" in p:
        from repro_torch.models.mlp import MLP
        tp.shared = MLP(_t(p["shared"]["w_up"]), _t(p["shared"]["w_down"]),
                        _t(p["shared"]["w_gate"]))
    return jp, tp


def _pin_groups(monkeypatch, g):
    """The grouped dispatch's group count pinned to ``g`` in both
    packages (each reads it from its rules' mesh: 1 with none)."""
    for mod in (jax_moe_mod, moe_mod):
        monkeypatch.setattr(mod, "_dp_extent", lambda r: g)


GROUPED = dict(moe_grouped=True)


@pytest.mark.parametrize("kw,g,shape", [
    (dict(), 1, (2, 16)), (GROUPED, 1, (2, 16)),
    (dict(n_shared_experts=1), 1, (2, 16)),
    (dict(top_k=1, capacity_factor=0.1), 1, (2, 16)),
    (dict(n_experts=8, top_k=3), 1, (2, 16)),
    (GROUPED, 2, (2, 16)), (GROUPED, 4, (2, 16)),
    (dict(GROUPED, n_shared_experts=1), 2, (2, 16)),
    (dict(GROUPED, n_shared_experts=1), 4, (2, 16)),
    (dict(GROUPED, top_k=1, capacity_factor=0.1), 2, (2, 16)),
    (dict(GROUPED, top_k=1, capacity_factor=0.1), 4, (2, 16)),
    (dict(GROUPED, n_experts=8, top_k=3), 2, (2, 16)),
    (dict(GROUPED, n_experts=8, top_k=3), 4, (2, 16)),
    # 6 tokens: g = 4 halves to 2
    (GROUPED, 4, (1, 6)),
], ids=["flat", "grouped", "shared_expert", "capacity_drop", "e8_k3",
        "grouped_g2", "grouped_g4", "shared_expert_g2", "shared_expert_g4",
        "capacity_drop_g2", "capacity_drop_g4", "e8_k3_g2", "e8_k3_g4",
        "g4_halves_to_2"])
def test_moe_fwd_matches_jax(monkeypatch, kw, g, shape):
    """Output and aux against the reference's, flat and grouped; the
    grouped dispatch at the reference's group count ``g``."""
    _pin_groups(monkeypatch, g)
    jcfg, tcfg = _moe_cfg(**kw)
    jp, tp = _moe_pair(jcfg, tcfg)
    x = np.random.default_rng(0).normal(size=shape + (16,)).astype(
        np.float32)
    want, jaux = jax_moe_mod.moe_fwd(jp, jnp.asarray(x), jcfg)
    got, aux = moe_fwd(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_grouped_dispatch_is_the_flat_one_per_group(monkeypatch):
    """At g = 4 the grouped dispatch equals the flat dispatch applied to
    each quarter of the tokens on its own (each with its own capacity),
    and its aux is the flat aux over all tokens."""
    _, tcfg = _moe_cfg(moe_grouped=True, capacity_factor=0.5)
    _, tp = _moe_pair(*_moe_cfg(capacity_factor=0.5))
    x = _t(np.random.default_rng(3).normal(size=(4, 8, 16)).astype(
        np.float32))
    _pin_groups(monkeypatch, 4)
    got, aux = moe_fwd(tp, x, tcfg)
    flat = dataclasses.replace(tcfg, moe_grouped=False)
    want = torch.cat([moe_fwd(tp, q[None], flat)[0] for q in x])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(aux, moe_fwd(tp, x, flat)[1], rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("grouped,g", [(False, 1), (True, 1), (True, 2)],
                         ids=["False", "True", "grouped_g2"])
def test_moe_dispatch_chunks_match_jax(monkeypatch, grouped, g):
    """Past ``DISPATCH_CHUNK_TOKENS`` tokens the dispatch runs in
    sequence chunks, each with its own capacity: the constant set to 8
    in both packages gives 4 chunks of 8 tokens here."""
    for mod in (jax_moe_mod, moe_mod):
        monkeypatch.setattr(mod, "DISPATCH_CHUNK_TOKENS", 8)
    _pin_groups(monkeypatch, g)
    jcfg, tcfg = _moe_cfg(moe_grouped=grouped)
    jp, tp = _moe_pair(jcfg, tcfg, seed=1)
    x = np.random.default_rng(1).normal(size=(2, 16, 16)).astype(np.float32)
    want, jaux = jax_moe_mod.moe_fwd(jp, jnp.asarray(x), jcfg)
    got, aux = moe_fwd(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    monkeypatch.setattr(moe_mod, "DISPATCH_CHUNK_TOKENS", 65_536)
    whole, _ = moe_fwd(tp, _t(x), tcfg)
    assert not torch.allclose(whole, got)     # the chunks' capacities


def _planted_ties(tcfg, seed):
    """Router weights whose experts come in identical pairs (0 = 2,
    1 = 3), so every token's probabilities tie pairwise."""
    rng = np.random.default_rng(seed)
    half = rng.normal(size=(tcfg.d_model, tcfg.n_experts // 2))
    return np.concatenate([half, half], axis=1).astype(np.float32)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_routing_and_keep_mask_equal_jax_with_ties(monkeypatch, top_k):
    """Expert ids as ``jax.lax.top_k`` picks them (of tied experts, the
    lower id first; ``torch.topk`` does not promise that order) and the
    keep mask of the reference's positions (moe.py:176-186), exactly."""
    jcfg, tcfg = _moe_cfg(top_k=top_k, capacity_factor=0.5)
    jp, tp = _moe_pair(jcfg, tcfg)
    router = _planted_ties(tcfg, top_k)
    jp = dict(jp, router=jnp.asarray(router))
    tp.router.data = _t(router)
    seen = []
    real_top_k = jax.lax.top_k

    def recording_top_k(x, k):
        out = real_top_k(x, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    x = np.random.default_rng(2).normal(size=(2, 16, 16)).astype(np.float32)
    want, _ = jax_moe_mod.moe_fwd(jp, jnp.asarray(x), jcfg)
    (jids,) = seen
    probs, _, ids = route(tp, _t(x).reshape(32, 16), tcfg)
    assert (probs[..., :2] == probs[..., 2:]).all()   # the ties are there
    np.testing.assert_array_equal(ids.numpy(), jids)
    # the reference's positions, in jnp, from its own expert ids
    flat = jnp.asarray(jids).reshape(-1)
    onehot = jax.nn.one_hot(flat, 4, dtype=jnp.int32)
    jpos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot - 1, axis=-1)
    capacity = int(max(1, (32 * top_k * 0.5) // 4))
    pos, keep = positions(ids.reshape(-1), 4, capacity)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(),
                                  np.asarray(jpos < capacity))
    assert not keep.all() and keep.any()
    got, _ = moe_fwd(tp, _t(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_moe_routes_to_multiple_experts():
    """The reference's test on the port: outputs of the input's shape, a
    positive finite aux loss, several experts chosen."""
    _, cfg = _moe_cfg()
    p = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, 16)).astype(np.float32))
    out, aux = moe_fwd(p, x, cfg)
    assert out.shape == x.shape
    assert np.isfinite(float(aux)) and float(aux) > 0
    assert torch.isfinite(out).all()
    _, _, ids = route(p, x.reshape(16, 16), cfg)
    assert len(ids.unique()) > 1


def test_moe_capacity_drop_is_graceful():
    """Most choices past the capacity: zeros, not NaN."""
    _, cfg = _moe_cfg(top_k=1, capacity_factor=0.1)
    p = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 16, 16)).astype(np.float32))
    out, _ = moe_fwd(p, x, cfg)
    assert torch.isfinite(out).all()


def test_moe_decode_capacity_is_one_per_expert():
    """A 4-slot decode of qwen3-moe: capacity max(1, 4·8·1.25 // 128) =
    1, and every position is negative past the buffer, so the scatter
    drops every choice and the experts contribute nothing — the
    reference's behaviour, kept."""
    cfg = get_config("qwen3-moe-235b-a22b")
    t, k, e = 4, cfg.top_k, cfg.n_experts
    assert int(max(1, (t * k * cfg.capacity_factor) // e)) == 1
    ids = torch.arange(t * k) % e
    pos, keep = positions(ids, e, 1)
    assert keep.all() and (pos + 1 < 0).all()


# ------------------------------------------------------------------ SSD
@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16), (24, 16), (12, 5),
                                     (8, 64), (7, 4)])
def test_chunked_linear_scan_matches_reference_and_jax(s, chunk):
    """Chunks that divide S and chunks halved until they do (24 by 16
    -> 8, 12 by 5 -> 2, 7 by 4 -> 1), from a zero and a given state."""
    rng = np.random.default_rng(s * 100 + chunk)
    b, h, n, p = 2, 3, 4, 5
    q, k = (rng.normal(size=(b, s, h, n)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(b, s, h, p)).astype(np.float32)
    log_a = -np.abs(rng.normal(size=(b, s, h))).astype(np.float32)
    h0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    for init in (None, h0):
        ti = None if init is None else _t(init)
        y, hf = chunked_linear_scan(_t(q), _t(k), _t(v), _t(log_a),
                                    chunk=chunk, h0=ti)
        ry, rh = reference_scan(_t(q), _t(k), _t(v), _t(log_a), h0=ti)
        np.testing.assert_allclose(y.numpy(), ry.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(hf.numpy(), rh.numpy(), rtol=1e-4,
                                   atol=1e-4)
        jy, jh = jax_chunked_linear_scan(
            *map(jnp.asarray, (q, k, v, log_a)), chunk=chunk,
            h0=None if init is None else jnp.asarray(init))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(hf.numpy(), np.asarray(jh), rtol=1e-5,
                                   atol=1e-5)


def test_segsum_matches_jax(rng):
    a = -np.abs(rng.normal(size=(2, 3, 6))).astype(np.float32)
    got, want = segsum(_t(a)).numpy(), np.asarray(jax_segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_jax(rng, with_prev):
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    prev = rng.normal(size=(2, 3, 6)).astype(np.float32)
    got = _causal_conv(_t(x), _t(w), _t(b),
                       _t(prev) if with_prev else None)
    want = jax_causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           jnp.asarray(prev) if with_prev else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------------- Whisper
def test_cross_attention_kv_override_matches_jax(rng):
    """q from x, k/v from the encoder output (T 11 frames against S 5
    tokens), non-causal, through ``attention_fwd(kv_override=...)``."""
    jcfg = dataclasses.replace(jax_get_config("whisper-small", smoke=True),
                               use_flash=False)
    tcfg = get_config("whisper-small", smoke=True)
    jp = jax_init_attention(jax.random.key(0), jcfg)
    tp = Attention(*(_t(jp[n]) for n in ("wq", "wk", "wv", "wo")))
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    ctx = rng.normal(size=(2, 11, 64)).astype(np.float32)
    want = jax_attention_fwd(jp, jnp.asarray(x), jcfg,
                             kv_override=(jnp.asarray(ctx),))
    got = attention_fwd(tp, _t(x), tcfg, kv_override=(_t(ctx),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_own_key_length_on_cpu_matches_jax(rng):
    """The op with Sk != Sq, non-causal, on the CPU (its plain version)
    against the JAX package's plain attention."""
    from repro.kernels.flash_attention.ops import attention as jax_attention
    q = rng.normal(size=(2, 4, 3, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 70, 16)).astype(np.float32)
            for _ in range(2))
    got = attention(_t(q), _t(k), _t(v), causal=False, use_pallas=True)
    want = jax_attention(*map(jnp.asarray, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_cost_counts_both_lengths():
    from repro_torch.kernels.flash_attention.kernel import cost
    cross = cost(4, 12, 12, 4, 64, 2, causal=False, sk=1500)
    assert cross["flops"] == 4 * 4 * 12 * 64 * 4 * 1500
    assert cross["bytes"] == 2 * 4 * 64 * (2 * 12 * 4 + 2 * 12 * 1500)
    assert cost(1, 2, 1, 8, 16, 4) == cost(1, 2, 1, 8, 16, 4, True, 8)


def test_encoder_matches_jax():
    jmodel, jparams, tmodel, tparams = _pair("whisper-small", False)
    frames = np.random.default_rng(4).normal(size=(2, 16, 64)).astype(
        np.float32)
    want = jax_encode(jparams, jmodel.cfg, jnp.asarray(frames))
    got = encode(tparams, tmodel.cfg, _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encdec_without_frames_names_them_and_greedy_generate():
    _, _, tmodel, tparams = _pair("whisper-small", False)
    with pytest.raises(ValueError, match="frames.*greedy_generate"):
        tmodel.prefill(tparams, {"tokens": np.zeros((1, 4), np.int32)}, 8)


# ------------------------------------------------------------- convert
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_jax_keeps_shapes_and_fp32_leaves(arch):
    """Every reference leaf lands in the port with its shape (no
    transposes) and its values; the leaves the reference computes with
    in fp32 stay fp32 under a bf16 compute type."""
    jmodel, jparams, _, _ = _pair(arch, False)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, jparams)
    port = params_from_jax(tree, cfg, device="cpu")
    n_ref = sum(a.size for a in jax.tree.leaves(tree))
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_ref
    fp32 = {name.split(".")[-1] for name, p in port.named_parameters()
            if p.dtype == torch.float32}
    tables = {"embed", "unembed"}
    want = {"router"} if cfg.is_moe else {
        "hybrid": {"A_log", "dt_bias", "D"}, "ssm": {"r_gates"}}.get(
            cfg.family, set())
    assert fp32 - tables == want


def test_params_from_jax_refuses_a_wrong_depth():
    _, jparams, tmodel, _ = _pair("zamba2-1.2b", False)
    cfg = dataclasses.replace(tmodel.cfg, n_layers=11)
    with pytest.raises(ValueError, match="groups stacked"):
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
