"""Built steps on the CPU: a step in a shared compile cache keeps none
of the data of the run that built it, and a per-frame step whose
declared working set does not fit its budget runs in blocks of frames,
equal to the one-call step bit for bit."""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import (CudaTransport, PluginRunner, ShardedTransport,
                              transport as T)
from repro_torch.service import CompileCache
from repro_torch.tomo import standard_chain

CHAIN = dict(n_det=32, n_angles=24, n_rows=5, device="cpu")


@pytest.mark.parametrize("make", [
    lambda cache: CudaTransport("cpu", compile_cache=cache),
    lambda cache: ShardedTransport(("cpu",) * 3, compile_cache=cache)],
    ids=["cuda", "sharded"])
def test_the_compile_cache_holds_no_result(make):
    """Once the caller drops its datasets, the volume is freed, whatever
    the shared compile cache holds: its built steps keep patterns,
    shapes and dtypes, and a copy of each plugin without its datasets
    or constants."""
    cache = CompileCache()
    for seed in (0, 1):
        datasets = PluginRunner(standard_chain(**CHAIN, seed=seed),
                                make(cache)).run()
        backing = datasets["recon"].backing
        held = [weakref.ref(t) for t in getattr(backing, "shards",
                                                [backing])]
        del datasets, backing
        gc.collect()
        assert [w() for w in held] == [None] * len(held)
    assert cache.stats()["entries"] == 4 and cache.stats()["hits"] == 4


def _filter_spans(runner):
    return [s for s in runner.profiler.trace.spans()
            if s.name.endswith(".process")]


@pytest.mark.parametrize("frames_a_block, blocks", [(1, 5), (2, 3), (5, 1)])
def test_a_step_in_frame_blocks_equals_the_one_call_step(
        monkeypatch, frames_a_block, blocks):
    """The spectrum scale's step declares its working set per sinogram;
    a budget (injected through the function that computes it) of
    ``frames_a_block`` sinograms' worth runs its 5 sinograms in
    ``blocks`` blocks, bit for bit the one-call step; plugins that
    declare nothing run in one call, and every ``process`` span says how
    many blocks its step ran.  Off a card there is no budget."""
    assert T.frame_budget(torch.device("cpu"), 1 << 40) is None
    one = PluginRunner(standard_chain(**CHAIN), CudaTransport("cpu"))
    want = one.transport.read(one.run()["recon"])
    assert {s.name: s.attrs["blocks"] for s in _filter_spans(one)} == {
        f"plugin.{p}.process": 1 for p in (
            "dark_flat_correction", "ring_removal", "sinogram_filter",
            "fbp_recon")}
    nf = 33                      # rfft bins of the filter (64-point FFT)
    per = CHAIN["n_angles"] * (64 * 4 + 2 * nf * 8)
    budgets = []
    monkeypatch.setattr(T, "frame_budget", lambda device, need: (
        budgets.append((device, need)), frames_a_block * per)[1])
    r = PluginRunner(standard_chain(**CHAIN), CudaTransport("cpu"))
    np.testing.assert_array_equal(r.transport.read(r.run()["recon"]), want)
    assert budgets and {(str(d), n) for d, n in budgets} == {
        ("cpu", CHAIN["n_rows"] * per)}
    got = {s.name: s.attrs["blocks"] for s in _filter_spans(r)}
    assert got.pop("plugin.sinogram_filter.process") == blocks
    assert set(got.values()) == {1}
