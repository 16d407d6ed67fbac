"""The port's tomography substrate against the JAX package's: phantoms,
the projector, simulated scans, every plugin, and the whole standard
chain (the JAX side with its Pallas kernels in interpret mode) on the
same raw scan.  Plus the phantom-quality bounds of
tests/test_tomo_pipeline.py for the port's own chain on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro.tomo as JT
import repro.tomo.plugins as JP

from repro_torch.core import (ChunkedFileTransport, CudaTransport, DataSet,
                              InMemoryTransport, PluginRunner)
from repro_torch.tomo import (ParallelGeometry, forward_project,
                              phantom_stack, shepp_logan, simulate_raw_scan,
                              standard_chain)
import repro_torch.tomo.plugins as TP


def _quality(recon, truth):
    sl = slice(8, -8)
    t, x = truth[:, sl, sl], recon[:, sl, sl]
    return np.corrcoef(t.ravel(), x.ravel())[0, 1]


def _run(chain, transport):
    runner = PluginRunner(chain, transport)
    out = runner.run()
    recon = runner.transport.read(out["recon"])
    return recon, out["recon"].metadata["truth"], runner


def _with_scan(chain, scan):
    chain.entries[0].params["scan"] = scan
    return chain


# ------------------------------------------------------ data generation
def test_phantoms_match_jax():
    np.testing.assert_array_equal(shepp_logan(48), JT.shepp_logan(48))
    np.testing.assert_array_equal(phantom_stack(32, 3),
                                  JT.phantom_stack(32, 3))
    v = phantom_stack(32, 3)
    assert not np.allclose(v[0], v[2])


def test_forward_project_matches_jax():
    vol = phantom_stack(64, 2)
    geom = ParallelGeometry(48, 64, 2)
    want = JT.forward_project(vol, JT.ParallelGeometry(48, 64, 2))
    got = forward_project(vol, geom, device="cpu")
    assert got.shape == want.shape == (48, 2, 64)
    # float32 ray sums of up to 64 bilinear samples, in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_forward_projector_sanity():
    """Radon of a centred disc: projection mass ≈ π r² at every angle."""
    n = 64
    ys, xs = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    disc = ((xs ** 2 + ys ** 2) <= 0.5 ** 2).astype(np.float32)
    proj = forward_project(disc[None], ParallelGeometry(8, n, 1),
                           device="cpu").numpy()
    sums = proj.sum(axis=-1)[:, 0]
    assert sums.std() / sums.mean() < 0.02
    expected = np.pi * (0.5 * n / 2) ** 2
    assert abs(sums.mean() - expected) / expected < 0.05


@pytest.mark.parametrize("noise", [0.0, 4.0])
def test_simulated_scan_matches_jax(noise):
    """Same seed, same draws: the random numbers come from numpy in the
    JAX package's order, so dark and flat are identical and raw counts
    differ by at most one rounding step of the count (one noise quantum
    with Poisson noise) where the projectors round differently."""
    vol = phantom_stack(32, 2)
    want = JT.simulate_raw_scan(vol, JT.ParallelGeometry(16, 32, 2),
                                noise=noise, seed=3)
    got = simulate_raw_scan(vol, ParallelGeometry(16, 32, 2), noise=noise,
                            seed=3, device="cpu")
    assert got["data"].shape == (16, 2, 32)
    assert got["data"].dtype == np.uint16
    assert got["flat"].mean() > got["dark"].mean()
    np.testing.assert_array_equal(got["dark"], want["dark"])
    np.testing.assert_array_equal(got["flat"], want["flat"])
    diff = np.abs(got["data"].astype(np.int64) - want["data"])
    assert diff.max() <= max(1.0, noise)
    assert (diff > 0).mean() < 0.01


# --------------------------------------------------------------- plugins
def _scan_dataset(ns, data, **meta):
    d = ns.DataSet("tomo", data.shape, data.dtype,
                   ("rotation_angle", "detector_y", "detector_x"),
                   metadata=dict(meta))
    d.add_pattern("PROJECTION", core=("detector_y", "detector_x"),
                  slice_=("rotation_angle",))
    d.add_pattern("SINOGRAM", core=("rotation_angle", "detector_x"),
                  slice_=("detector_y",))
    return d


def _volume_dataset(ns, data):
    d = ns.DataSet("recon", data.shape, data.dtype,
                   ("voxel_y", "voxel_z", "voxel_x"))
    d.add_pattern("VOLUME_XZ", core=("voxel_z", "voxel_x"),
                  slice_=("voxel_y",))
    return d


def _plugin_case(name, rng):
    """(params, dataset builder, input block, rtol, atol) for one plugin."""
    a, y, x = 16, 2, 32
    raw = rng.integers(3000, 40000, size=(a, y, x)).astype(np.uint16)
    lin = rng.uniform(0.05, 2.0, size=(a, y, x)).astype(np.float32)
    meta = {"dark": rng.integers(80, 120, size=(y, x)).astype(np.uint16),
            "flat": rng.integers(39000, 41000, size=(y, x))
            .astype(np.uint16),
            "mu": 0.02}
    sino_block = rng.normal(size=(y, a, x)).astype(np.float32)
    vol = rng.normal(size=(3, 8, 8)).astype(np.float32)
    if name == "DarkFlatCorrection":
        return ({}, lambda ns: _scan_dataset(ns, raw, **meta), raw,
                1e-6, 1e-6)
    if name == "PaganinFilter":
        return ({"tau": 4.0}, lambda ns: _scan_dataset(ns, lin), lin,
                1e-5, 1e-5)
    if name == "RingRemoval":
        return ({"kernel": 5, "strength": 0.7},
                lambda ns: _scan_dataset(ns, lin), sino_block, 1e-6, 1e-6)
    if name == "SinogramFilter":
        return ({"kind": "hann", "cutoff": 0.8},
                lambda ns: _scan_dataset(ns, lin), sino_block, 1e-5, 1e-5)
    if name == "FBPRecon":
        # mu = 1 keeps the output in backprojection units, where the
        # backprojection tolerance applies (1/mu scales the error)
        return ({}, lambda ns: _scan_dataset(
            ns, lin, geometry=ns.ParallelGeometry(a, x, y), mu=1.0),
            sino_block, 2e-4, 2e-5)
    if name == "Downsample":
        return ({"factor": 2}, lambda ns: _volume_dataset(ns, vol), vol,
                1e-6, 1e-6)
    if name == "Quantify":
        return ({}, lambda ns: _volume_dataset(ns, vol), vol, 1e-5, 1e-5)
    raise AssertionError(name)


class _Jax:
    DataSet, ParallelGeometry, plugins = R.DataSet, JT.ParallelGeometry, JP


class _Port:
    DataSet, ParallelGeometry, plugins = DataSet, ParallelGeometry, TP


@pytest.mark.parametrize("name", ["DarkFlatCorrection", "PaganinFilter",
                                  "RingRemoval", "SinogramFilter",
                                  "FBPRecon", "Downsample", "Quantify"])
def test_plugin_matches_jax(rng, name):
    params, make_ds, block, rtol, atol = _plugin_case(name, rng)
    outs = []
    for ns in (_Jax, _Port):
        plugin = getattr(ns.plugins, name)(
            in_datasets=["tomo"], out_datasets=["out"], **params)
        (dout,) = plugin.setup([make_ds(ns)])
        frames = (jnp.asarray(block) if ns is _Jax
                  else torch.from_numpy(block))
        outs.append((dout, np.asarray(plugin.process_frames([frames]))))
    (jd, want), (pd, got) = outs
    assert pd.shape == jd.shape and np.dtype(pd.dtype) == np.dtype(jd.dtype)
    assert sorted(pd.patterns) == sorted(jd.patterns)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_unpadded_paganin_matches_jax(rng):
    """The port's Paganin filter with its edge pads given as 0 (the
    default) is the JAX package's filter, which has no pads."""
    params, make_ds, block, rtol, atol = _plugin_case("PaganinFilter", rng)
    jp = JP.PaganinFilter(in_datasets=["tomo"], out_datasets=["out"],
                          **params)
    tp = TP.PaganinFilter(in_datasets=["tomo"], out_datasets=["out"],
                          pad_y=0, pad_x=0, **params)
    jp.setup([make_ds(_Jax)])
    tp.setup([make_ds(_Port)])
    want = np.asarray(jp.process_frames([jnp.asarray(block)]))
    got = tp.process_frames([torch.from_numpy(block)]).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_loaders_and_saver_match_jax(rng):
    scan = JT.simulate_raw_scan(JT.phantom_stack(16, 2),
                                JT.ParallelGeometry(8, 16, 2))
    vol = rng.normal(size=(2, 4, 4)).astype(np.float32)
    for cls, params in (("SyntheticTomoLoader", {"scan": scan}),
                        ("UpstreamLoader", {"data": vol})):
        (jd,) = getattr(JP, cls)(out_datasets=["x"], **params).load()
        (pd,) = getattr(TP, cls)(out_datasets=["x"], **params).load()
        assert (pd.shape, pd.axis_labels, sorted(pd.patterns)) == \
            (jd.shape, jd.axis_labels, sorted(jd.patterns))
        np.testing.assert_array_equal(pd.materialise(), jd.materialise())
    assert pd.patterns["VOLUME_XZ"].core_dims == (1, 2)
    TP.HDF5LikeSaver(in_datasets=["x"]).save(pd)
    assert pd.metadata["saved"]


# ------------------------------------------------------ the whole chain
@pytest.mark.parametrize("variant", [
    {}, {"paganin": True, "ring": False}, {"noise": 4.0, "n_rows": 2}])
def test_chain_matches_jax_on_same_scan(variant):
    """The port's chain (plain versions on the CPU) against the JAX
    chain with its Pallas kernels in interpret mode, both fed the same
    JAX-made raw scan."""
    kw = {"n_det": 64, "n_angles": 64, "n_rows": 1, **variant}
    geom = JT.ParallelGeometry(kw["n_angles"], kw["n_det"], kw["n_rows"])
    scan = JT.simulate_raw_scan(JT.phantom_stack(kw["n_det"], kw["n_rows"]),
                                geom, noise=kw.get("noise", 0.0))
    jrunner = R.PluginRunner(_with_scan(JT.standard_chain(
        **kw, use_pallas=True), scan), R.InMemoryTransport())
    want = np.asarray(jrunner.transport.read(jrunner.run()["recon"]))
    got, _, _ = _run(_with_scan(standard_chain(**kw, device="cpu"), scan),
                     CudaTransport(device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("variant,bound", [
    ({"n_rows": 2}, 0.85),
    ({"n_rows": 1, "paganin": True, "ring": False}, 0.7),
    ({"n_rows": 1, "noise": 4.0}, 0.75),
])
def test_chain_reconstructs_phantom(variant, bound):
    recon, truth, _ = _run(standard_chain(n_det=64, n_angles=96,
                                          device="cpu", **variant),
                           CudaTransport(device="cpu"))
    assert recon.shape == truth.shape
    assert _quality(recon, truth) > bound


@pytest.mark.parametrize("make", [lambda: InMemoryTransport(device="cpu"),
                                  lambda: ChunkedFileTransport(device="cpu")],
                         ids=["inmemory", "chunked"])
def test_chain_on_host_transports(make):
    recon, truth, runner = _run(standard_chain(n_det=64, n_angles=96,
                                               n_rows=2, device="cpu"),
                                make())
    assert _quality(recon, truth) > 0.85
    if isinstance(runner.transport, ChunkedFileTransport):
        stats = runner.transport.total_stats()
        assert stats.chunk_reads > 0 and stats.chunk_writes > 0


