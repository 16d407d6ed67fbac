"""The port's serving path against the JAX package's: greedy generation,
continuous batching and the serve step, on the same weights (loaded
through ``params_from_jax``) and the same numpy-made prompts; tokens
must be identical.  Then the port's serving entry point."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.training import ContinuousBatcher as JaxBatcher
from repro.training import Request as JaxRequest
from repro.training import greedy_generate as jax_greedy_generate
from repro.training import make_serve_step as jax_make_serve_step
from repro.training.serve_step import _splice_cache as jax_splice_cache

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.training import (ContinuousBatcher, Request,
                                  greedy_generate, make_serve_step)
from repro_torch.training.serve_step import _splice_cache

DENSE = ["granite-8b", "granite-34b", "phi4-mini-3.8b", "chatglm3-6b"]
#: the families a ContinuousBatcher serves beside the dense one (the VLM
#: serves token prompts as the dense family does; Whisper needs frames)
BATCHED_FAMILIES = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                    "llava-next-34b", "xlstm-1.3b", "zamba2-1.2b"]


@functools.lru_cache(maxsize=None)
def _pair(arch: str, use_flash: bool = False):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               use_flash=use_flash)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               use_flash=use_flash)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jmodel, jparams, build_model(tcfg, device="cpu"), tparams


def _serve_both(arch, prompt_lens, *, slots=2, max_new=4, max_len=24,
                use_flash=False):
    """Run the same requests through both batchers -> ({rid: tokens})*2."""
    jmodel, jparams, tmodel, tparams = _pair(arch, use_flash)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tmodel.cfg.vocab, (n,)).astype(np.int32)
               for n in prompt_lens]
    out = []
    for batcher, req in ((JaxBatcher(jmodel, jparams, slots=slots,
                                     max_len=max_len), JaxRequest),
                         (ContinuousBatcher(tmodel, tparams, slots=slots,
                                            max_len=max_len), Request)):
        for i, p in enumerate(prompts):
            batcher.submit(req(rid=i, prompt=p, max_new=max_new))
        out.append({r.rid: r.generated for r in batcher.run()})
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_matches_jax(arch):
    jmodel, jparams, tmodel, tparams = _pair(arch)
    toks = np.random.default_rng(1).integers(
        0, tmodel.cfg.vocab, (2, 8)).astype(np.int32)
    want = jax_greedy_generate(jmodel, jparams, {"tokens": toks}, max_new=5,
                               max_len=16)
    got = greedy_generate(tmodel, tparams, {"tokens": toks}, max_new=5,
                          max_len=16)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch,use_flash", [(a, False) for a in DENSE] +
                         [("granite-8b", True)])
def test_continuous_batcher_matches_jax(arch, use_flash):
    want, got = _serve_both(arch, [6] * 5, use_flash=use_flash)
    assert sorted(got) == list(range(5))
    assert all(len(t) == 4 for t in got.values())
    assert got == want


def test_continuous_batcher_unequal_prompts_matches_jax():
    """Unequal prompt lengths: the batch cache's one ``length`` is the
    newest request's, so other slots decode at its position — the
    reference's behaviour, which the port keeps."""
    want, got = _serve_both("granite-8b", [6, 9, 4, 7, 5], max_new=5)
    assert got == want


@pytest.mark.parametrize("arch", BATCHED_FAMILIES)
def test_continuous_batcher_families_match_jax(arch):
    """Five requests on two slots through both batchers: identical
    tokens.  The MoE decode dispatches two tokens at a time, so its
    capacity is the reference's small one."""
    want, got = _serve_both(arch, [6] * 5)
    assert sorted(got) == list(range(5))
    assert all(len(t) == 4 for t in got.values())
    assert got == want


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_continuous_batcher_recurrent_unequal_prompts_match_jax(arch):
    """Unequal prompts through the recurrent families: both packages
    prefill a zero state with length 0 (the prompt is not replayed into
    the cache), and the shared ``length`` is the newest request's."""
    want, got = _serve_both(arch, [6, 9, 4, 7, 5], max_new=5)
    assert got == want
    _, _, tmodel, tparams = _pair(arch)
    _, cache = tmodel.prefill(tparams, {"tokens": np.arange(
        6, dtype=np.int32)[None]}, 24)
    assert cache["length"] == 0
    for got, empty in zip(_tensors(cache),
                          _tensors(tmodel.init_cache(1, 24)), strict=True):
        assert torch.equal(got, empty)


def _tensors(tree):
    """The tree's tensors in ``jax.tree.leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _random_like(tree, rng, batch):
    """The same tree with every array leaf random, ``batch`` rows on its
    batch axis (the one after the stacked layer axes)."""
    if isinstance(tree, dict):
        return {k: _random_like(v, rng, batch) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_random_like(v, rng, batch) for v in tree))
    if isinstance(tree, torch.Tensor) and tree.dim():
        return torch.from_numpy(rng.normal(size=tree.shape).astype(
            np.float32)).to(tree.dtype)
    return tree


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b",
                                  "whisper-small"])
def test_splice_cache_walks_nested_caches_like_jax(arch):
    """xLSTM's (MLSTMCache/SLSTMCache) and Zamba2's (MambaCache) caches
    are trees: each leaf is spliced at the request's slot, as the
    reference's ``jax.tree.map`` does, and ``length`` is replaced."""
    _, _, tmodel, _ = _pair(arch)
    rng = np.random.default_rng(0)
    batch = _random_like(tmodel.init_cache(3, 8), rng, 3)
    one = _random_like(tmodel.init_cache(1, 8), rng, 1)
    batch["length"], one["length"] = 5, 2
    jbatch = jax.tree.map(lambda t: jnp.asarray(t.numpy()) if isinstance(
        t, torch.Tensor) else jnp.asarray(t, jnp.int32), batch)
    jone = jax.tree.map(lambda t: jnp.asarray(t.numpy()) if isinstance(
        t, torch.Tensor) else jnp.asarray(t, jnp.int32), one)
    want = jax_splice_cache(jbatch, jone, 1)
    got = _splice_cache(batch, one, 1)
    assert got["length"] == int(want["length"]) == 2
    got_leaves = _tensors(got)
    want_leaves = [a for a in jax.tree.leaves(want) if np.ndim(a)]
    assert len(got_leaves) == len(want_leaves) > 2
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(g is b for g, b in zip(got_leaves, _tensors(batch)))


def test_splice_cache_replaces_the_shared_length():
    batch = {"k": torch.zeros(2, 3, 1, 4, 2), "v": torch.zeros(2, 3, 1, 4, 2),
             "length": 7}
    one = {"k": torch.ones(2, 1, 1, 4, 2), "v": torch.ones(2, 1, 1, 4, 2),
           "length": 3}
    out = _splice_cache(batch, one, 1)
    assert out["length"] == 3
    assert out["k"] is batch["k"]                  # spliced in place
    assert out["k"][:, 1].eq(1).all() and out["k"][:, [0, 2]].eq(0).all()


def test_serve_step_roundtrip_matches_jax():
    jmodel, jparams, tmodel, tparams = _pair("granite-8b")
    jstep = jax.jit(jax_make_serve_step(jmodel))
    step = make_serve_step(tmodel)
    jtok, jcache = jnp.zeros((2, 1), jnp.int32), jmodel.init_cache(2, 16)
    tok, cache = torch.zeros((2, 1), dtype=torch.int32), \
        tmodel.init_cache(2, 16)
    for _ in range(3):
        jtok, jcache = jstep(jparams, jtok, jcache)
        tok, cache = step(tparams, tok, cache)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert cache["length"] == int(jcache["length"]) == 3
    assert tok.shape == (2, 1) and tok.dtype == torch.int32


def test_serve_entry_point_on_cpu(capsys):
    serve.main(["--device", "cpu", "--smoke", "--requests", "3",
                "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens in" in out
    assert "2 slots)" in out and "  req 0: [" in out


@pytest.mark.parametrize("arch", BATCHED_FAMILIES)
def test_serve_entry_point_serves_every_family_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--smoke",
                "--requests", "3", "--slots", "2", "--max-new", "3"])
    assert "served 3 requests, 9 tokens in" in capsys.readouterr().out


def test_serve_entry_point_names_whisper_frames():
    """The reference's batcher gives whisper-small no frames and its
    ``serve`` fails on ``batch["frames"]``; the port says so up front."""
    with pytest.raises(ValueError, match="frames.*greedy_generate"):
        serve.main(["--arch", "whisper-small", "--device", "cpu",
                    "--smoke", "--requests", "1"])


def test_serve_entry_point_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        serve.main(["--smoke", "--requests", "1"])
