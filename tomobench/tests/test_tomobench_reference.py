"""The plain reference against the port's plain CPU path at a small
geometry, and its lower-precision controls against the limit."""
from __future__ import annotations

import json

import numpy as np
import torch

from tomobench import program, scans
from tomobench.reference import chain as ref
from tomobench.reference.compare import slice_rel_err

from .tiny import LIMIT, REPO

CPU = torch.device("cpu")


def _config():
    c = json.loads((REPO / "tomobench" / "configs" /
                    "pco-edge-2560x1801.json").read_text())
    c.update(n_det=64, n_rows=4, n_angles=64)
    return c


def _program_volume(cfg, scan, overrides=None):
    prog = program.load(REPO)
    pl = program.chain(prog, cfg, scan, overrides)
    transport = prog.CudaTransport(CPU)
    datasets = prog.PluginRunner(pl, transport).run()
    return transport.read(datasets[cfg["result"]])


def test_reference_equals_the_ports_plain_path_at_64x64x4():
    cfg = _config()
    m = scans.ScanModel(2**35 + 1, 64, 4, 64, cfg["scan"])
    scan = m.raw(range(4), CPU)
    got = _program_volume(cfg, scan)
    params = ref.chain_params(cfg["process_list"])
    want = ref.reconstruct(scan, range(4), params, CPU)
    errs = [slice_rel_err(got[k], want[k]) for k in range(4)]
    assert max(errs) < 1e-5, errs
    # a sweep variant's own cutoff
    got = _program_volume(cfg, scan, {"sinogram_filter": {"cutoff": 0.5}})
    want = ref.reconstruct(scan, range(4), params, CPU, cutoff=0.5)
    assert max(slice_rel_err(got[k], want[k]) for k in range(4)) < 1e-5
    # the phantom is what comes back (the scan is physical; at 64 px
    # the noise and the rings keep the correlation near 0.83)
    truth = m.truth(2, 64)
    inner = np.s_[8:-8, 8:-8]
    assert np.corrcoef(got[2][inner].ravel(), truth[inner].ravel())[0, 1] \
        > 0.75


def test_the_controls_fail_the_limit():
    cfg = _config()
    m = scans.ScanModel(9, 64, 4, 64, cfg["scan"])
    scan = m.raw(range(4), CPU)
    params = ref.chain_params(cfg["process_list"])
    want = ref.reconstruct(scan, [1, 3], params, CPU)
    for mode in ("bf16", "bf16_storage"):
        got = ref.reconstruct(scan, [1, 3], params, CPU, mode)
        assert max(slice_rel_err(got[k], want[k]) for k in range(2)) \
            > LIMIT
