"""Whole runs of throwaway cells on the CPU, each in a fresh
interpreter: cells added by files alone are found by name; what the run
prints; the control and each fault of the timed path that a cell can
have read ``correct`` false; a run without the program, or with JAX or
the reference package loaded, prints no result."""
from __future__ import annotations

import shutil

import pytest

from tomobench.drivers.open_sweeps import schedule

from .tiny import LIMIT, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_added_cells_and_metric_are_found_by_name(tiny_root):
    r = run_cell(tiny_root, "tiny-band", 2**33 + 17, 1.0, trace=True)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["metrics"]["tiny.request_count"]["value"] >= 1
    assert set(res["metrics"]) == {"tiny.request_count",
                                   "runner.outside_steps_pct.chain",
                                   "backproject_roofline",
                                   "correction.raw_gbps"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["recon_max_rel_err"]["limit"] == LIMIT
    assert r["stderr"].rstrip().splitlines()[-1].startswith(
        "check recon_max_rel_err = ")
    assert not FORBIDDEN & set(r["modules"])


def test_end_to_end_run_of_the_open_loop(tiny_root):
    r = run_cell(tiny_root, "tiny-sweep", 11, 1.5)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True
    assert res["attempted"] == len(schedule(11, 8.0, 1.5))
    assert set(res["metrics"]) == {"slices_per_s", "setup_s"}
    assert not FORBIDDEN & set(r["modules"])


def test_sharded_cell_reads_its_all_to_all(tiny_root):
    r = run_cell(tiny_root, "tiny-mpi", 2**31 + 11, 0.5, trace=True)
    assert r["rc"] == 0, r["stderr"][-2000:]
    res = r["result"]
    assert res["correct"] is True
    assert res["metrics"]["transport.alltoall_gbps"]["value"] > 0
    assert not FORBIDDEN & set(r["modules"])


def test_the_control_reads_not_correct(tiny_root):
    r = run_cell(tiny_root, "tiny-band", 3, 0.5, control="bf16")
    assert r["rc"] == 0
    res = r["result"]
    assert res["correct"] is False
    assert res["checks"]["recon_max_rel_err"]["value"] > LIMIT


PLUGINS = "from repro_torch.tomo import plugins as P\n"
FAULTS = {
    # the ramp filter's step returns its state unchanged
    "state_unchanged": ("tiny-band", PLUGINS +
                        "P.SinogramFilter.process_frames = "
                        "lambda self, frames: frames[0]\n"),
    # half of a band's slices left out, the mean of the rest in their place
    "half_left_out": ("tiny-band", PLUGINS + """
_orig = P.FBPRecon.process_frames
def _half(self, frames):
    out = _orig(self, frames)
    h = out.shape[0] // 2
    out[h:] = out[:h].mean(dim=0)
    return out
P.FBPRecon.process_frames = _half
"""),
    # every slice altered where the backprojection produces it
    "answer_altered": ("tiny-band", PLUGINS + """
_orig = P.FBPRecon.process_frames
P.FBPRecon.process_frames = lambda self, frames: _orig(self, frames) * 1.05
"""),
    # a sweep's variants all filtered with the first one's cutoff
    "variants_share_a_filter": ("tiny-sweep", PLUGINS + """
from repro_torch.kernels.sino_filter.ops import filter_sino
def _one(self, frames, consts, counts):
    return filter_sino(frames[0], consts[0]["_filt"],
                       use_pallas=self.params["use_pallas"])
P.SinogramFilter.process_frames_batched = _one
"""),
    # the all-to-all left out: each slot keeps only its own block
    "exchange_left_out": ("tiny-mpi", """
import torch
from repro_torch.core import transport as T
_orig = T.ShardedTransport._resplit
def _own(self, st, dim, name, record=True):
    if st.dim is None or dim is None or st.dim == dim \\
            or st.devices != self.slots:
        return _orig(self, st, dim, name, record)
    local = self._local(name, st.shape, dim)
    shards = [torch.cat([T._narrow(src, dim, j * local[dim], local[dim])]
                        * len(self.slots), st.dim).contiguous()
              for j, src in enumerate(st.shards)]
    return T.ShardedTensor(shards, dim, self.slots)
T.ShardedTransport._resplit = _own
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_of_the_timed_path_reads_not_correct(tiny_root, fault):
    cell, patch = FAULTS[fault]
    r = run_cell(tiny_root, cell, 5, 0.5, patch=patch)
    assert r["rc"] == 0, r["stderr"][-2000:]
    assert r["result"]["correct"] is False
    assert r["result"]["checks"]["recon_max_rel_err"]["value"] is None or \
        r["result"]["checks"]["recon_max_rel_err"]["value"] > LIMIT


def test_a_run_that_loads_jax_prints_no_result(tiny_root):
    r = run_cell(tiny_root, "tiny-band", 5, 0.3,
                 patch="import types\nsys.modules['jax'] = "
                       "types.ModuleType('jax')\n")
    assert r["rc"] == 3 and r["result"] is None
    assert "jax" in r["stderr"]


def test_a_checkout_without_the_program_prints_no_result(tiny_root,
                                                         tmp_path):
    shutil.copytree(tiny_root / "tomobench", tmp_path / "tomobench")
    shutil.copy(tiny_root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = run_cell(tmp_path, "tiny-band", 5, 0.3)
    assert r["rc"] != 0 and r["result"] is None
    assert "src/repro_torch" in r["stderr"]
