"""The port's dense LM against the JAX package's on the same weights.

Every comparison loads the reference's parameters into the port through
``params_from_jax``; inputs are made with numpy.  The reference runs as
its own tests run it: with ``use_flash`` its attention is the Pallas
kernel in interpret mode.  Tolerances are those of tests/test_models.py
(rtol/atol 2e-4 on logits)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.layers import layer_norm as jax_layer_norm
from repro.models.layers import rms_norm as jax_rms_norm
from repro.models.layers import rope_freqs as jax_rope_freqs
from repro.models.layers import unembed as jax_unembed
from repro.models.mlp import mlp_fwd as jax_mlp_fwd

from repro_torch.configs import ARCH_IDS, get_config, smoke_batch
from repro_torch.models import ModelConfig, build_model, cross_entropy
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import apply_rope, embed_tokens, \
    layer_norm, rms_norm, rope_freqs, unembed
from repro_torch.models.transformer import lm_prefill_embeds
from repro_torch.models.mlp import MLP, mlp_fwd

DENSE = ["granite-8b", "granite-34b", "phi4-mini-3.8b", "chatglm3-6b"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(arch: str, use_flash: bool):
    """(reference model, its params, port model, port params)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               use_flash=use_flash)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               use_flash=use_flash)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jmodel, jparams, build_model(tcfg, device="cpu"), tparams


def _tokens(cfg, batch=2, seq=12, seed=0):
    return smoke_batch(cfg, batch=batch, seq=seq, seed=seed)["tokens"]


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, use_flash):
    jmodel, jparams, tmodel, tparams = _pair(arch, use_flash)
    batch = smoke_batch(tmodel.cfg, batch=2, seq=16)
    want, _ = jmodel.forward(jparams, batch)
    got, aux = tmodel.forward(tparams, batch)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(tmodel.loss(tparams, batch)),
                               float(jmodel.loss(jparams, batch)), **TOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, use_flash):
    jmodel, jparams, tmodel, tparams = _pair(arch, use_flash)
    toks = _tokens(tmodel.cfg)
    want, jcache = jmodel.prefill(jparams, {"tokens": toks}, 16)
    got, cache = tmodel.prefill(tparams, {"tokens": toks}, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    assert cache["length"] == int(jcache["length"]) == 12
    nxt = np.argmax(np.asarray(want), -1).astype(np.int32)
    want, jcache = jmodel.decode_step(jparams, nxt, jcache)
    got, cache = tmodel.decode_step(tparams, nxt, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)
    assert cache["length"] == int(jcache["length"]) == 13


@pytest.mark.parametrize("fraction", [1.0, 0.75, 0.5])
def test_rope_matches_jax(rng, fraction):
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32) * 37
    jcos, jsin = jax_rope_freqs(16, fraction, 10_000.0, jnp.asarray(pos))
    cos, sin = rope_freqs(16, fraction, 10_000.0, _t(pos))
    assert cos.shape == jcos.shape == (9, int(16 * fraction) // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-5)
    # the same tables through both rotations
    got = apply_rope(_t(x), _t(np.asarray(jcos)), _t(np.asarray(jsin)))
    want = jax_apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    rot = 2 * cos.shape[-1]
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(rng, dtype):
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = rms_norm(_t(x).to(tdt), _t(scale).to(tdt), 1e-5)
    want = jax_rms_norm(jnp.asarray(x).astype(jdt),
                        jnp.asarray(scale).astype(jdt), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1e-5 if dtype == "float32" else 1e-2,
                               atol=1e-5 if dtype == "float32" else 1e-2)


def test_layer_norm_matches_jax(rng):
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3 + 1
    scale, bias = (rng.normal(size=(32,)).astype(np.float32)
                   for _ in range(2))
    got = layer_norm(_t(x), _t(scale), _t(bias), 1e-5)
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_prefill_from_embeds_matches_prefill():
    _, _, tmodel, tparams = _pair("chatglm3-6b", False)
    toks = _t(_tokens(tmodel.cfg))
    want, wcache = tmodel.prefill(tparams, {"tokens": toks}, 16)
    got, cache = lm_prefill_embeds(
        tparams, tmodel.cfg,
        embed_tokens(tparams.embed, toks, tmodel.cfg.dtype), 16)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(cache["v"].numpy(), wcache["v"].numpy())


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "silu"])
def test_mlp_fwd_matches_jax(rng, kind):
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    p = {"w_up": rng.normal(size=(16, 24)).astype(np.float32) / 4,
         "w_down": rng.normal(size=(24, 16)).astype(np.float32) / 5}
    if kind == "swiglu":
        p["w_gate"] = rng.normal(size=(16, 24)).astype(np.float32) / 4
    act = "gelu" if kind == "gelu" else "silu"
    want = jax_mlp_fwd({k: jnp.asarray(a) for k, a in p.items()},
                       jnp.asarray(x), jnp.float32, act)
    mlp = MLP(_t(p["w_up"]), _t(p["w_down"]),
              _t(p["w_gate"]) if "w_gate" in p else None)
    got = mlp_fwd(mlp, _t(x), torch.float32, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_unembed_matches_jax(rng):
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    got = unembed(_t(table), _t(x).to(torch.bfloat16))
    want = jax_unembed(jnp.asarray(table),
                       jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_decode_matches_forward_dense():
    """Teacher-forced decode reproduces the full-sequence logits (the
    reference's strongest cache check, on the port alone)."""
    cfg = ModelConfig(arch_id="t", family="dense", n_layers=3, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                      dtype=torch.float32, remat=False)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, 64, (2, 10)).astype(np.int32)
    full_logits, _ = model.forward(params, {"tokens": toks})
    _, cache = model.prefill(params, {"tokens": toks[:, :4]}, max_len=10)
    for t in range(4, 10):
        logits, cache = model.decode_step(params, toks[:, t:t + 1], cache)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full_logits[:, t].numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_and_param_counts_match_jax(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    for smoke in (False, True):
        cfg, ref = get_config(arch, smoke=smoke), jax_get_config(
            arch, smoke=smoke)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(ref)
        for name in ("dtype", "param_dtype"):
            assert str(mine.pop(name)).split(".")[-1] == \
                jnp.dtype(theirs.pop(name)).name
        assert mine == theirs
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxModelConfig)]


def test_granite_8b_size():
    cfg = get_config("granite-8b")
    assert cfg.param_count() == 8_254_685_184
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (32, 8, 128)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_builds_every_architecture(arch):
    """Every configuration builds, initialises on the model's device and
    caches on it.  A transformer's weights hold as many values as the
    reference's ``param_count`` says and the final norm's d, which that
    count leaves out (its formula does not model the recurrent families'
    blocks)."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in params.parameters())
    cache = model.init_cache(2, 8)
    assert cache["length"] == 0
    if cfg.family in ("dense", "moe", "vlm"):
        assert sum(p.numel() for p in params.parameters()) == \
            cfg.param_count() + cfg.d_model


def test_params_from_jax_keeps_shapes_and_ties():
    _, jparams, tmodel, tparams = _pair("phi4-mini-3.8b", False)
    cfg = tmodel.cfg
    assert cfg.tie_embeddings and tparams.unembed is None
    assert tparams.out_table is tparams.embed
    assert len(tparams.layers) == cfg.n_layers
    attn = tparams.layers[1].attn
    assert attn.wq.shape == (cfg.d_model, cfg.n_heads, cfg.hd)
    assert attn.wo.shape == (cfg.n_heads, cfg.hd, cfg.d_model)
    np.testing.assert_array_equal(
        attn.wk.numpy(), np.asarray(jparams["layers"][0]["attn"]["wk"][1]))
    assert tparams.embed.dtype == torch.float32
    with pytest.raises(ValueError, match="unembed"):
        params_from_jax({**jax.tree.map(np.asarray, jparams),
                         "unembed": np.zeros((cfg.vocab, cfg.d_model))},
                        cfg, device="cpu")


def test_bf16_weights_stored_once_in_compute_dtype():
    cfg = dataclasses.replace(get_config("granite-8b", smoke=True),
                              dtype=torch.bfloat16)
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert params.embed.dtype == params.unembed.dtype == torch.float32
    assert {p.dtype for p in params.layers.parameters()} == {torch.bfloat16}
    assert not any(p.requires_grad for p in params.parameters())


def test_kv_cache_device_is_named_by_the_caller():
    from repro_torch.models.attention import init_cache
    cfg = get_config("granite-8b", smoke=True)
    with pytest.raises(TypeError, match="device"):
        init_cache(cfg, 2, 16)
    cache = init_cache(cfg, 2, 16, device="cpu")
    assert cache.k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, 16, cfg.hd)
    assert cache.k.device.type == "cpu" and cache.length == 0
    model_cache = build_model(cfg, device="cpu").init_cache(2, 16)
    assert model_cache["k"].device.type == "cpu"


def test_cross_entropy_matches_jax(rng):
    from repro.models import cross_entropy as jax_cross_entropy
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(cross_entropy(_t(logits), _t(labels))),
        float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
