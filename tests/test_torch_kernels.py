"""The port's kernels against the JAX package's on the same inputs.

On the CPU each op of the port runs its plain PyTorch version; the JAX
side runs as its own tests run it (Pallas in interpret mode, or its
reference).  Tolerances are those of tests/test_kernels.py.  The
kernels themselves are held against these plain versions on the card by
tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.backproject.kernel import backproject_pallas
from repro.kernels.backproject.ops import backproject as jax_backproject
from repro.kernels.backproject.ref import backproject_ref as jax_bp_ref
from repro.kernels.correction.kernel import correct_pallas
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import \
    mha_chunked_ref as jax_mha_chunked_ref
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro.kernels.sino_filter.kernel import scale_spectrum_pallas
from repro.kernels.sino_filter.ops import filter_sino as jax_filter_sino
from repro.kernels.sino_filter.ref import make_filter as jax_make_filter

from repro_torch.kernels.backproject import ref as bp_ref
from repro_torch.kernels.backproject.kernel import backproject_cuda
from repro_torch.kernels.backproject.ops import backproject
from repro_torch.kernels.correction.kernel import correct_cuda
from repro_torch.kernels.correction.ops import correct
from repro_torch.kernels.correction.ref import (correct_batched_ref,
                                                correct_ref)
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (mha_chunked_ref, mha_ref,
                                                     mha_tiled_ref)
from repro_torch.kernels.sino_filter.kernel import scale_spectrum_cuda
from repro_torch.kernels.sino_filter.ops import filter_sino
from repro_torch.kernels.sino_filter.ref import (filter_sino_ref, make_filter,
                                                 scale_spectrum_ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------- correction
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("shape", [(2, 8, 128), (5, 33, 64), (1, 16, 256)])
def test_correction_matches_jax(rng, dtype, shape):
    raw = rng.integers(50, 40000, size=shape).astype(dtype)
    dark = rng.integers(80, 120, size=shape[1:]).astype(dtype)
    flat = rng.integers(30000, 42000, size=shape[1:]).astype(dtype)
    want = correct_pallas(jnp.asarray(raw), jnp.asarray(dark),
                          jnp.asarray(flat), interpret=True)
    got = correct(_t(raw), _t(dark), _t(flat))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_correction_handles_dead_pixels():
    raw = np.full((1, 8, 128), 0, np.uint16)          # dead detector
    dark = np.full((8, 128), 100, np.uint16)
    flat = np.full((8, 128), 100, np.uint16)           # flat == dark!
    got = correct(_t(raw), _t(dark), _t(flat)).numpy()
    assert np.all(np.isfinite(got))
    want = correct_pallas(jnp.asarray(raw), jnp.asarray(dark),
                          jnp.asarray(flat), interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_correction_leading_dims(rng):
    raw = rng.integers(50, 40000, size=(2, 3, 4, 16)).astype(np.uint16)
    dark = rng.integers(80, 120, size=(4, 16)).astype(np.float32)
    flat = rng.integers(30000, 42000, size=(4, 16)).astype(np.float32)
    got = correct(_t(raw), _t(dark), _t(flat))
    assert got.shape == (2, 3, 4, 16)
    np.testing.assert_allclose(
        got.numpy()[1, 2],
        correct_ref(_t(raw[1, 2]), _t(dark), _t(flat)).numpy(),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("counts", [(5, 7, 1), (3, 0, 6), (9,)],
                         ids=["ragged", "empty_member", "one_member"])
def test_correction_batched_matches_jax_per_member(rng, dtype, counts):
    """A gang of scans in one call, each member with its own dark and
    flat and a frame count no run of 4 divides: each member's output
    equals the JAX kernel's on that member alone (interpret mode)."""
    y, x = 8, 24
    raw = rng.integers(50, 40000, size=(sum(counts), y, x)).astype(dtype)
    dark = rng.integers(80, 120, size=(len(counts), y, x)).astype(dtype)
    flat = rng.integers(30000, 42000,
                        size=(len(counts), y, x)).astype(dtype)
    flat[-1, ::3] = dark[-1, ::3]                      # dead pixels
    got = correct(_t(raw), _t(dark), _t(flat), counts=list(counts))
    assert got.dtype == torch.float32 and got.shape == raw.shape
    lo = 0
    for j, n in enumerate(counts):
        if n:
            want = correct_pallas(jnp.asarray(raw[lo:lo + n]),
                                  jnp.asarray(dark[j]), jnp.asarray(flat[j]),
                                  interpret=True)
            np.testing.assert_allclose(got.numpy()[lo:lo + n],
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
        lo += n


def test_correction_batched_rejects_bad_counts(rng):
    raw = _t(rng.integers(0, 100, size=(6, 2, 8)).astype(np.uint16))
    cal = _t(np.ones((2, 2, 8), np.float32))
    with pytest.raises(ValueError, match="split"):
        correct_batched_ref(raw, cal, cal, [2, 3])


# ----------------------------------------------------------- sino filter
@pytest.mark.parametrize("kind", ["ramlak", "shepp", "cosine", "hann"])
def test_make_filter_matches_jax(kind):
    for n_det in (32, 100, 2560):
        np.testing.assert_array_equal(make_filter(n_det, kind),
                                      jax_make_filter(n_det, kind))


@pytest.mark.parametrize("kind", ["ramlak", "shepp", "cosine", "hann"])
@pytest.mark.parametrize("F,D", [(6, 64), (3, 100), (16, 32)])
def test_sino_filter_matches_jax(rng, kind, F, D):
    sino = rng.normal(size=(F, D)).astype(np.float32)
    filt = make_filter(D, kind)
    want = jax_filter_sino(jnp.asarray(sino), jnp.asarray(filt),
                           use_pallas=True, interpret=True)
    got = filter_sino(_t(sino), _t(filt))
    assert got.dtype == torch.float32 and got.shape == (F, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_sino_filter_leading_dims(rng):
    sino = rng.normal(size=(2, 5, 40)).astype(np.float32)
    filt = _t(make_filter(40, "shepp"))
    got = filter_sino(_t(sino), filt)
    np.testing.assert_allclose(
        got.numpy()[1], filter_sino_ref(_t(sino[1]), filt).numpy(),
        rtol=1e-5, atol=1e-5)


def test_scale_spectrum_matches_jax(rng):
    re = rng.normal(size=(4, 65)).astype(np.float32)
    im = rng.normal(size=(4, 65)).astype(np.float32)
    filt = rng.normal(size=(1, 65)).astype(np.float32)
    fre, fim = scale_spectrum_pallas(jnp.asarray(re), jnp.asarray(im),
                                     jnp.asarray(filt), interpret=True)
    got = scale_spectrum_ref(torch.complex(_t(re), _t(im)), _t(filt[0]))
    np.testing.assert_allclose(got.real.numpy(), np.asarray(fre), rtol=1e-6)
    np.testing.assert_allclose(got.imag.numpy(), np.asarray(fim), rtol=1e-6)


# ----------------------------------------------------------- backprojection
@pytest.mark.parametrize("A,D,N,bh,bw,ba", [
    (16, 32, 32, 8, 16, 4),
    (32, 64, 64, 8, 32, 16),
    (24, 48, 48, 16, 16, 8),
    (8, 128, 64, 8, 64, 2),
])
def test_backproject_matches_jax_kernel(rng, A, D, N, bh, bw, ba):
    sino = rng.normal(size=(A, D)).astype(np.float32)
    angles = np.linspace(0, np.pi, A, endpoint=False).astype(np.float32)
    want = backproject_pallas(jnp.asarray(sino),
                              jnp.cos(jnp.asarray(angles)).reshape(-1, 1),
                              jnp.sin(jnp.asarray(angles)).reshape(-1, 1),
                              out_size=N, bh=bh, bw=bw, ba=ba, interpret=True)
    got = backproject(_t(sino), _t(angles), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


def test_backproject_batched_matches_jax(rng):
    sino = rng.normal(size=(3, 16, 32)).astype(np.float32)
    angles = np.linspace(0, np.pi, 16, endpoint=False).astype(np.float32)
    want = jax_backproject(jnp.asarray(sino), jnp.asarray(angles), 32)
    got = backproject(_t(sino), _t(angles), 32)
    assert got.shape == (3, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


def test_backproject_centre_offset_matches_jax(rng):
    sino = rng.normal(size=(16, 32)).astype(np.float32)
    angles = np.linspace(0, np.pi, 16, endpoint=False).astype(np.float32)
    want = jax_backproject(jnp.asarray(sino), jnp.asarray(angles), 32,
                           centre=17.5)
    got = backproject(_t(sino), _t(angles), 32, centre=17.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


def test_backproject_ragged_shapes_match_jax_ref(rng):
    """Odd angle counts and sizes no tile divides (the main path has
    1801 angles) against the JAX reference."""
    sino = rng.normal(size=(2, 17, 30)).astype(np.float32)
    angles = np.linspace(0, np.pi, 17, endpoint=False).astype(np.float32)
    got = backproject(_t(sino), _t(angles), 27)
    for i in range(2):
        want = jax_bp_ref(jnp.asarray(sino[i]), jnp.asarray(angles), 27)
        np.testing.assert_allclose(got.numpy()[i], np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


def test_backproject_angle_chunks_agree(rng, monkeypatch):
    """The plain version sums over angle chunks to bound memory; the
    chunking must not change the result."""
    sino = _t(rng.normal(size=(2, 24, 32)).astype(np.float32))
    angles = torch.linspace(0, np.pi, 25)[:-1]
    whole = bp_ref.backproject_ref(sino, angles, 32)
    monkeypatch.setattr(bp_ref, "CHUNK_ELEMS", 2 * 32 * 32 * 5)
    chunked = bp_ref.backproject_ref(sino, angles, 32)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                               rtol=2e-4, atol=2e-5)


# (A, D, N, centre, slices): the shapes above, a centre offset and a
# ragged batch
TILED_CASES = [(16, 32, 32, None, 1), (32, 64, 64, None, 1),
               (24, 48, 48, None, 1), (8, 128, 64, None, 1),
               (16, 32, 32, 17.5, 1), (17, 30, 27, None, 3)]


@pytest.mark.parametrize("A,D,N,centre,S", TILED_CASES)
def test_backproject_tiled_ref_matches_jax(rng, A, D, N, centre, S):
    """The kernel's arithmetic (exact position, fused lerp, one
    accumulator per slice over the angles in order) against the Pallas
    kernel in interpret mode (where its tiles divide the shape) and the
    JAX reference."""
    sino = rng.normal(size=(S, A, D)).astype(np.float32)
    angles = np.linspace(0, np.pi, A, endpoint=False).astype(np.float32)
    got = bp_ref.backproject_tiled_ref(_t(sino), _t(angles), N, centre)
    assert got.shape == (S, N, N) and got.dtype == torch.float32
    for i in range(S):
        want = jax_bp_ref(jnp.asarray(sino[i]), jnp.asarray(angles), N,
                          centre=centre)
        np.testing.assert_allclose(got.numpy()[i], np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
    if centre is None and S == 1 and N % 16 == 0 and A % 8 == 0:
        want = backproject_pallas(
            jnp.asarray(sino[0]), jnp.cos(jnp.asarray(angles)).reshape(-1, 1),
            jnp.sin(jnp.asarray(angles)).reshape(-1, 1), out_size=N, bh=8,
            bw=16, ba=8, interpret=True)
        np.testing.assert_allclose(got.numpy()[0], np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


def test_backproject_tiled_ref_rows(rng):
    """``rows`` picks image rows out of the whole image."""
    sino = _t(rng.normal(size=(2, 17, 30)).astype(np.float32))
    angles = torch.linspace(0, np.pi, 18)[:-1]
    whole = bp_ref.backproject_tiled_ref(sino, angles, 27, 15.25)
    part = bp_ref.backproject_tiled_ref(sino, angles, 27, 15.25,
                                        rows=[0, 13, 26])
    np.testing.assert_array_equal(part.numpy(), whole.numpy()[:, [0, 13, 26]])


#: the main path's geometry (D 2560, A 1801, N 2560) and full image rows
#: at the edges and the centre
MAIN_BP = {"D": 2560, "A": 1801, "N": 2560, "rows": [0, 5, 1280, 2555]}


def _reference_order_rows(sino, angles, n, rows):
    """backproject_ref's arithmetic for a few image rows: each term in
    float32 as the reference rounds it, summed over the angles in
    float64."""
    s, n_angles, d = sino.shape
    centre = np.float32((d - 1) / 2.0)
    c = np.float32((n - 1) / 2.0)
    xs = np.arange(n, dtype=np.float32) - c
    ys = np.asarray(rows, np.float32) - c
    theta = torch.from_numpy(angles)
    cos_t, sin_t = torch.cos(theta).numpy(), torch.sin(theta).numpy()
    padded = np.pad(sino, ((0, 0), (0, 0), (1, 1)))
    acc = np.zeros((s, len(rows) * n))
    for a in range(n_angles):
        t = ((xs[None, :] * cos_t[a] + ys[:, None] * sin_t[a])
             + centre).reshape(-1)
        tp = np.clip(t + np.float32(1), np.float32(0), np.float32(d + 1))
        t0 = np.floor(tp)
        frac = tp - t0
        i0 = np.clip(t0.astype(np.int64), 0, d)
        i1 = np.clip(i0 + 1, 0, d + 1)
        val = (padded[:, a, i0] * (np.float32(1) - frac)
               + padded[:, a, i1] * frac)
        acc += np.where((t > -1) & (t < d), val, np.float32(0))
    return (acc * (np.pi / n_angles)).reshape(s, len(rows), n)


@pytest.fixture(scope="module")
def main_bp_case():
    g = MAIN_BP
    sino = np.random.default_rng(0).standard_normal((2, g["A"], g["D"]),
                                                    dtype=np.float32)
    angles = np.linspace(0, np.pi, g["A"], endpoint=False).astype(np.float32)
    return sino, angles, _reference_order_rows(sino, angles, g["N"],
                                               g["rows"])


def _position_contracted(xs, ys, cos, sin, centre):
    """x·cos unrounded inside one FMA with fl(y·sin), then + centre"""
    ysn = (ys[:, None] * sin).double()
    return (xs[None, :].double() * cos.double() + ysn).float() + centre


def _position_stepped(xs, ys, cos, sin, centre):
    """exact at every 8th pixel, then t += cos across the next 7"""
    t = (xs[None, :] * cos + ys[:, None] * sin) + centre
    for k in range(1, 8):
        t[:, k::8] = t[:, k - 1::8] + cos
    return t


@pytest.mark.parametrize("position", ["exact", "contracted", "stepped"])
def test_backproject_tiled_ref_at_main_geometry(monkeypatch, main_bp_case,
                                                position):
    """The card check's tolerance (rtol 2e-4, atol 2e-5) held on the CPU
    at the main geometry, against the reference's rounding order: the
    kernel's arithmetic (exact position, fused lerp and sum) spends about
    1 % of it.  The position contracted into an FMA spends most of it on
    this data, and stepped from pixel to pixel falls outside: why the
    kernel computes it exactly for every (pixel, angle).  ``pytest -rP``
    shows each case's error."""
    if position != "exact":
        monkeypatch.setattr(bp_ref, "_position",
                            {"contracted": _position_contracted,
                             "stepped": _position_stepped}[position])
    sino, angles, want = main_bp_case
    got = bp_ref.backproject_tiled_ref(_t(sino), _t(angles), MAIN_BP["N"],
                                       rows=MAIN_BP["rows"]).double().numpy()
    err = np.abs(got - want)
    ratio = err / (2e-5 + 2e-4 * np.abs(want))
    share, outside = float(ratio.max()), int((ratio > 1).sum())
    print(f"position {position}: max abs err {err.max():.3e}, {share:.3f} "
          f"of the tolerance, {outside} of {err.size} outside")
    if position == "exact":
        assert share < 0.05
    elif position == "contracted":
        assert outside == 0 and share > 0.5
    else:
        assert outside > 0


# ----------------------------------------------------------- flash attention
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 4, 2, 64, 16),
    (1, 8, 1, 128, 32),
    (2, 4, 4, 32, 64),
    (1, 6, 2, 96, 16),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(rng, B, Hq, Hkv, S, D, causal):
    """The cases of the reference's test_flash_attention_sweep: the
    port's op (its plain version on the CPU) and its mha_ref against the
    Pallas kernel in interpret mode and the JAX mha_ref."""
    q = rng.normal(size=(B, Hq, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=32, bk=32, interpret=True))
    got = attention(_t(q), _t(k), _t(v), causal=causal, use_pallas=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        mha_ref(_t(q), _t(k), _t(v), causal=causal).numpy(),
        np.asarray(jax_mha_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)),
        rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16_matches_jax(rng):
    q, k, v = (rng.normal(size=(1, 2, 64, 32)).astype(np.float32)
               for _ in range(3))
    want = flash_attention_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=True, bq=32, bk=32, interpret=True)
    got = attention(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                    causal=True, use_pallas=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 4, 2, 64, 16),
    (1, 8, 1, 128, 32),
    (2, 4, 4, 32, 64),
    (1, 6, 2, 96, 16),
])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_ref_matches_jax_kernel_bf16(rng, B, Hq, Hkv, S, D, causal):
    """The bf16 kernel's arithmetic (64-key tiles, scale on the scores,
    P split into bf16 hi + lo) against the Pallas kernel in interpret
    mode on the reference's sweep shapes in bf16, at the reference's
    bf16 tolerance."""
    q = rng.normal(size=(B, Hq, S, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    want = flash_attention_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal, bq=32, bk=32, interpret=True)
    got = mha_tiled_ref(*(_t(a).to(torch.bfloat16) for a in (q, k, v)),
                        causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


#: P fed to the PV product in place of the kernel's split (the first part
#: into the fp32 accumulator, the second a zero): the reference's fp32 P,
#: and P rounded to bf16 as FlashAttention-2/3 feed it
P_TREATMENTS = {
    "fp32": lambda p: (p, torch.zeros_like(p)),
    "rounded": lambda p: (p.to(torch.bfloat16).float(), torch.zeros_like(p)),
}


@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal,p", [
    (1, 8, 2, 2048, 128, True, "split"),
    (2, 4, 2, 77, 64, False, "split"),
    (1, 48, 1, 200, 128, True, "split"),
    (1, 8, 2, 2048, 128, True, "fp32"),
    (1, 8, 2, 2048, 128, True, "rounded"),
], ids=["serving_width", "ragged", "mqa", "serving_width_p_fp32",
        "serving_width_p_rounded"])
def test_tiled_ref_matches_mha_ref_at_card_tolerance(rng, monkeypatch, B, Hq,
                                                     Hkv, S, D, causal, p):
    """The card check's tolerance (rtol 1e-2, atol 1e-3) held on the CPU:
    with P split (the kernel's) or in fp32 every output is inside it;
    with P rounded to bf16, near-cancelling outputs at S 2048 fall
    outside.  ``pytest -rP`` shows each case's error."""
    if p != "split":
        monkeypatch.setattr(flash_ref, "_split_p", P_TREATMENTS[p])
    q, k, v = (_t(rng.normal(size=(B, h, S, D)).astype(np.float32))
               .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    got = mha_tiled_ref(q, k, v, causal=causal).double().numpy()
    want = mha_ref(q, k, v, causal=causal).double().numpy()
    err = np.abs(got - want)
    outside = int((err > 1e-3 + 1e-2 * np.abs(want)).sum())
    print(f"P {p}: max abs err {err.max():.5f}, {outside} of {err.size} "
          f"outside rtol 1e-2 / atol 1e-3")
    assert (outside > 0) == (p == "rounded"), (p, outside, err.max())


def test_tiled_ref_takes_bf16_only():
    x = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        mha_tiled_ref(x, x, x)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(rng, causal):
    q = rng.normal(size=(2, 4, 128, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 128, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 128, 16)).astype(np.float32)
    got = mha_chunked_ref(_t(q), _t(k), _t(v), causal=causal, block_q=32)
    want = jax_mha_chunked_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), mha_ref(_t(q), _t(k), _t(v), causal=causal).numpy(),
        rtol=1e-5, atol=1e-5)


def test_attention_routes_long_sequences_to_chunked(monkeypatch):
    from repro_torch.kernels.flash_attention import ops
    calls = []
    monkeypatch.setattr(ops, "mha_chunked_ref",
                        lambda *a, **kw: calls.append("chunked"))
    monkeypatch.setattr(ops, "mha_ref", lambda *a, **kw: calls.append("ref"))
    x = torch.zeros(1, 1, ops.CHUNKED_THRESHOLD, 16)
    ops.attention(x, x, x)
    ops.attention(x[:, :, :64], x[:, :, :64], x[:, :, :64], use_pallas=True)
    assert calls == ["chunked", "ref"]


# ----------------------------------------------------------- wrappers
def test_plain_attention_launches_no_kernel():
    before = flash_attention_cuda.launches
    x = torch.zeros(1, 2, 8, 16)
    attention(x, x, x, use_pallas=True)
    assert flash_attention_cuda.launches == before


def test_plain_path_launches_no_kernel(rng):
    before = (correct_cuda.launches, scale_spectrum_cuda.launches,
              backproject_cuda.launches)
    correct(_t(rng.integers(0, 9, size=(1, 4, 8)).astype(np.uint16)),
            torch.zeros(4, 8), torch.ones(4, 8))
    filter_sino(torch.zeros(2, 8), _t(make_filter(8)))
    backproject(torch.zeros(4, 8), torch.zeros(4), 8)
    assert (correct_cuda.launches, scale_spectrum_cuda.launches,
            backproject_cuda.launches) == before


@pytest.mark.parametrize("call", [
    lambda: correct_cuda(torch.zeros(1, 4, 8), torch.zeros(4, 8),
                         torch.ones(4, 8)),
    lambda: scale_spectrum_cuda(torch.zeros(2, 5, dtype=torch.complex64),
                                torch.ones(5)),
    lambda: backproject_cuda(torch.zeros(1, 4, 8), torch.ones(4),
                             torch.zeros(4), 8),
    lambda: flash_attention_cuda(torch.zeros(1, 2, 8, 16),
                                 torch.zeros(1, 2, 8, 16),
                                 torch.zeros(1, 2, 8, 16)),
], ids=["correction", "spectrum_scale", "backprojection", "flash_attention"])
def test_kernel_wrapper_refuses_cpu_tensor(call):
    """A wrapper launches its kernel or raises: never the plain version."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
