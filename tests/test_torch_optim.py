"""The port's AdamW (fp32 and int8 moments), clip and schedule against
the JAX package's on the same numpy-seeded inputs.

Tolerances: rtol 1e-5 over k = 3 steps (fp32 arithmetic in the same op
order; XLA's and PyTorch's ``pow``/``cos`` may differ in the last bit).
The int8 codes and scales must be equal exactly: the arithmetic is the
reference's (round half to even, a scale per row of the last dim).  The
reference's own round-trip test bounds the error at 0.02 of the block
max over blocks of 256 (``tests/test_optim_extras.py``), a layout the
code does not use; its hypothesis example n=258, scale=1.0 exceeds that
bound, so the port's test holds the codes to the reference's instead.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_lr as jax_cosine_lr
from repro.optim import global_norm as jax_global_norm
from repro.optim import init_opt_state as jax_init_opt_state
from repro.optim.adamw import _dq8 as jax_dq8
from repro.optim.adamw import _q8 as jax_q8

from repro_torch.optim import (AdamWConfig, adamw_update,
                               clip_by_global_norm, cosine_lr, global_norm,
                               init_opt_state)
from repro_torch.optim.adamw import _dq8, _q8

RTOL = 1e-5


def _tree(rng):
    """A parameter tree with a matrix, a vector, a 0-d leaf and a bf16
    leaf (the update computes in fp32 and casts back)."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "s": np.float32(rng.normal()),
            "h": rng.normal(size=(4, 3)).astype(np.float32)}


def _jax(tree):
    out = {k: jnp.asarray(v) for k, v in tree.items()}
    out["h"] = out["h"].astype(jnp.bfloat16)
    return out


def _torch(tree):
    out = {k: torch.tensor(v) for k, v in tree.items()}
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=1),
    dict()])
def test_cosine_lr_matches_reference(kw):
    jc, tc = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jax_cosine_lr(jc, jnp.asarray(step, jnp.int32)))
        got = float(cosine_lr(tc, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=str(step))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_match_reference(rng, max_norm):
    tree = _tree(rng)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jax_global_norm(_jax(tree))),
                               rtol=RTOL)
    got, gn = clip_by_global_norm(_torch(tree), max_norm)
    want, wn = jax_clip(_jax(tree), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=RTOL)
    for k in tree:
        assert got[k].dtype == _torch(tree)[k].dtype
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_adamw_update_matches_reference(rng, moments):
    """k = 3 steps on the same parameters and gradients (the first above
    the clip norm), with warm-up and weight decay on every leaf."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              moments_dtype=moments)
    jc, tc = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    tree = _tree(rng)
    jp, tp = _jax(tree), _torch(tree)
    js, ts = jax_init_opt_state(jp, moments), init_opt_state(tp, moments)
    jax_step = jax.jit(jax_adamw_update, static_argnums=0)
    for k in range(3):
        g = {n: (rng.normal(size=np.shape(v)) * (3.0 if k == 0 else 0.1)
                 ).astype(np.float32) for n, v in tree.items()}
        jp, js, jm = jax_step(jc, jp, _jax(g), js)
        tp2, ts2, tm = adamw_update(tc, tp, _torch(g), ts)
        assert tp2 is tp and ts2 is ts                 # in place
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=RTOL, err_msg=name)
        for n in tree:
            assert tp[n].dtype == _torch(tree)[n].dtype
            np.testing.assert_allclose(_np(tp[n]), _np(jp[n]), rtol=RTOL,
                                       atol=1e-6, err_msg=f"step {k} {n}")
            for mom in ("m", "v"):
                a, b = ts[mom][n], js[mom][n]
                if moments == "int8":
                    np.testing.assert_array_equal(a["q"].numpy(),
                                                  np.asarray(b["q"]))
                    a, b = a["s"], b["s"]
                np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL,
                                           atol=1e-12, err_msg=f"{mom} {n}")
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert int(ts["step"]) == int(js["step"]) == 3


@pytest.mark.parametrize("n,scale", [(258, 1.0), (1, 1e-6), (256, 3.3),
                                     (2000, 1e3), (17, 0.02)])
def test_q8_codes_equal_reference(n, scale):
    """The reference's stored hypothesis example (n=258, scale=1.0) and a
    few more: codes, scales and dequantised values equal exactly."""
    x = (np.random.default_rng(n).normal(size=(n,)) * scale
         ).astype(np.float32)
    want, got = jax_q8(jnp.asarray(x)), _q8(torch.from_numpy(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(_dq8(got, (n,)).numpy(),
                                  np.asarray(jax_dq8(want, (n,))))


def test_q8_scale_keeps_last_dim_and_0d(rng):
    x = rng.normal(size=(3, 7)).astype(np.float32)
    got, want = _q8(torch.from_numpy(x)), jax_q8(jnp.asarray(x))
    assert tuple(got["s"].shape) == (3, 1) == np.shape(want["s"])
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    z = _q8(torch.tensor(np.float32(-0.5)))
    assert tuple(z["q"].shape) == (1,) and int(z["q"][0]) == -127
    assert _dq8(z, ()).shape == ()


def test_dynamic_int8_preserves_small_values():
    """Tiny v entries next to a large row max must not quantise to zero
    (the failure of linear int8)."""
    x = torch.tensor(np.array([1.0] + [1e-4] * 255, np.float32))
    xr = _dq8(_q8(x), x.shape).numpy()
    assert xr[1] > 0
    assert abs(xr[1] - 1e-4) / 1e-4 < 0.7


def test_int8_adam_matches_fp32_closely(rng):
    """The int8-moment update points the way the fp32 one does, at a
    similar scale (cosine > 0.98, norm within 10%: the reference's)."""
    w = rng.normal(size=(512,)).astype(np.float32)
    g = {"w": torch.tensor(rng.normal(size=(512,)).astype(np.float32))}
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=100, weight_decay=0.0)
    p32, p8 = {"w": torch.tensor(w)}, {"w": torch.tensor(w)}
    s32, s8 = init_opt_state(p32), init_opt_state(p8, "int8")
    for _ in range(5):
        adamw_update(AdamWConfig(**kw), p32, g, s32)
        adamw_update(AdamWConfig(**kw, moments_dtype="int8"), p8, g, s8)
    u32, u8 = p32["w"].numpy() - w, p8["w"].numpy() - w
    cos = (u32 @ u8) / (np.linalg.norm(u32) * np.linalg.norm(u8))
    assert cos > 0.98, cos
    assert abs(np.linalg.norm(u8) / np.linalg.norm(u32) - 1) < 0.1


def test_weight_decay_pulls_to_zero():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=1,
                      total_steps=10, clip_norm=1e9)
    params = {"w": torch.full((4,), 2.0)}
    state = init_opt_state(params)
    for _ in range(5):
        adamw_update(cfg, params, {"w": torch.zeros(4)}, state)
    assert float(params["w"].abs().max()) < 2.0


def test_update_refuses_mismatched_grads():
    params = {"w": torch.zeros(2), "b": torch.zeros(1)}
    with pytest.raises(ValueError, match="'b'"):
        adamw_update(AdamWConfig(), params, {"w": torch.zeros(2)},
                     init_opt_state(params))
    with pytest.raises(ValueError, match="moments_dtype"):
        init_opt_state(params, "fp16")
