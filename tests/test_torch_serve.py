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

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.training import (ContinuousBatcher, Request,
                                  greedy_generate, make_serve_step)
from repro_torch.training.serve_step import _splice_cache

DENSE = ["granite-8b", "granite-34b", "phi4-mini-3.8b", "chatglm3-6b"]


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


def test_serve_entry_point_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        serve.main(["--smoke", "--requests", "1"])
