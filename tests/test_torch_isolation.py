"""The port stands alone: it imports neither jax nor the JAX package,
and its entry points never carry on on the CPU when the card is asked
for and absent."""
import ast
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core import ChunkedFileTransport, InMemoryTransport, \
    PluginRunner, ShardedTransport
from repro_torch.configs import get_config
from repro_torch.kernels.backproject.ops import backproject
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.launch import pipeline_serve, serve, train
from repro_torch.models import build_model
from repro_torch.service import (JobQueue, PipelineClient,
                                 PipelineScheduler, PipelineService)
from repro_torch.service.worker import main as worker_main
from repro_torch.service.worker import spawn_local_workers
from repro_torch.training import init_training
from repro_torch.tomo import ParallelGeometry, forward_project, \
    standard_chain

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
#: the families beside the dense one, one architecture each
FAMILIES = ["qwen3-moe-235b-a22b", "llava-next-34b", "zamba2-1.2b",
            "xlstm-1.3b", "whisper-small"]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_port_imports_with_jax_and_reference_blocked():
    ops = sorted(f"repro_torch.kernels.{p.parent.name}.ops"
                 for p in PORT.glob("kernels/*/ops.py"))
    assert len(ops) == 4
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import importlib",
        *[f"importlib.import_module({m!r})"
          for m in ["repro_torch", "repro_torch.core", "repro_torch.tomo",
                    "repro_torch.configs", "repro_torch.models",
                    "repro_torch.models.convert",
                    "repro_torch.models.moe", "repro_torch.models.ssd",
                    "repro_torch.models.mamba2", "repro_torch.models.zamba",
                    "repro_torch.models.xlstm",
                    "repro_torch.models.xlstm_model",
                    "repro_torch.models.whisper",
                    "repro_torch.models.model_zoo", "repro_torch.training",
                    "repro_torch.launch.serve", "repro_torch.obs",
                    "repro_torch.service", "repro_torch.service.server",
                    "repro_torch.service.client",
                    "repro_torch.service.sweep",
                    "repro_torch.service.workflow",
                    "repro_torch.service.worker",
                    "repro_torch.service.compile_cache",
                    "repro_torch.service.scheduler",
                    "repro_torch.kernels.build", "repro_torch.obs.slo",
                    "repro_torch.obs.export", "repro_torch.kernels.tally",
                    "repro_torch.launch.pipeline_serve",
                    "repro_torch.optim", "repro_torch.data",
                    "repro_torch.distributed", "repro_torch.models.remat",
                    "repro_torch.launch.train",
                    "repro_torch.models.sharding",
                    "repro_torch.distributed.param_sharding",
                    "repro_torch.distributed.compression",
                    "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                    "repro_torch.launch.dryrun_tomo",
                    "repro_torch.launch.perf", "repro_torch.roofline",
                    "repro_torch.roofline.analysis",
                    "repro_torch.roofline.counter",
                    "repro_torch.roofline.introspect",
                    "repro_torch.roofline.report", *ops]],
        "print('imported')"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_dry_run_modules_set_no_environment_and_start_no_group():
    """The reference sets XLA_FLAGS when its dry-runs are imported; the
    port's launch modules change nothing in the process at import."""
    code = "\n".join([
        "import os, sys",
        "sys.modules['jax'] = None",
        "before = dict(os.environ)",
        "import torch.distributed as dist",
        "import repro_torch.launch.mesh, repro_torch.launch.dryrun",
        "import repro_torch.launch.dryrun_tomo, repro_torch.launch.perf",
        "assert dict(os.environ) == before, set(os.environ) ^ set(before)",
        "assert not dist.is_initialized()",
        "print('clean')"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    """This host as it would be without a card, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_runner_without_transport_needs_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        PluginRunner(standard_chain())


@pytest.mark.parametrize("make", [
    lambda: resolve_device("cuda"),
    lambda: InMemoryTransport(),
    lambda: ChunkedFileTransport(),
    lambda: forward_project(np.zeros((1, 4, 4), np.float32),
                            ParallelGeometry(2, 4, 1)),
    lambda: build_model(get_config("granite-8b", smoke=True)),
    lambda: serve.main(["--smoke", "--requests", "1"]),
    lambda: PipelineScheduler(JobQueue()),
    lambda: pipeline_serve.main(["--jobs", "1"]),
    lambda: PipelineService(),
    lambda: pipeline_serve.main(["client", "--url", "http://127.0.0.1:9",
                                 "ingest", "scan", "--synthetic"]),
    lambda: worker_main(["--url", "http://127.0.0.1:9"]),
    lambda: spawn_local_workers("http://127.0.0.1:9", 1),
    lambda: PipelineService(workers_remote=True),
    lambda: pipeline_serve.main(["--workers-remote", "1"]),
    *[lambda a=a: build_model(get_config(a, smoke=True)) for a in FAMILIES],
    *[lambda a=a: serve.main(["--arch", a, "--smoke", "--requests", "1"])
      for a in FAMILIES],
    lambda: build_model(get_config("granite-8b", smoke=True),
                        training=True),
    lambda: init_training(build_model(get_config("granite-8b", smoke=True),
                                      training=True), None),
    lambda: train.main(["--steps", "1"]),
    lambda: ShardedTransport(),
    lambda: pipeline_serve.main(["--jobs", "1", "--transport", "sharded"]),
], ids=["resolve_device", "inmemory", "chunked", "forward_project",
        "build_model", "serve", "scheduler", "pipeline_serve",
        "pipeline_service", "client_ingest_synthetic", "worker_main",
        "spawn_local_workers", "pipeline_service_broker",
        "pipeline_serve_workers_remote",
        *[f"build_model_{a}" for a in FAMILIES],
        *[f"serve_{a}" for a in FAMILIES],
        "build_model_training", "init_training", "launch_train",
        "sharded_transport", "pipeline_serve_sharded"])
def test_entry_points_default_to_the_card(no_cuda, make):
    with pytest.raises(RuntimeError, match="cpu"):
        make()


def test_backproject_kernel_requested_off_the_card_raises():
    """A tensor that is not on the CPU and not on a card, with the
    kernel asked for: the op raises rather than run the plain version."""
    sino = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        backproject(sino, torch.zeros(4, device="meta"), 8)


def test_flash_kernel_requested_off_the_card_raises():
    q = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attention(q, q, q, use_pallas=True)


def test_pipeline_serve_runs_on_the_cpu_when_asked(capsys):
    summary = pipeline_serve.main(["--jobs", "2", "--workers", "1",
                                   "--batch", "--device", "cpu",
                                   "--n-det", "16", "--n-angles", "12"])
    assert summary["gangs_run"] == 1
    assert summary["max_abs_err_vs_serial"] < 1e-4   # verified in main
    assert summary["kernel_launches"] == {
        "correction": 0, "spectrum_scale": 0, "backprojection": 0}
    assert summary["gang_fallbacks"] == 0
    # the steps' busy time leaves out the loaders' scan simulation
    assert 0 < summary["process_s"] < summary["wall_s"]
    assert summary["process_jobs_per_s"] > summary["jobs_per_s"]
    assert '"pipeline_serve"' in capsys.readouterr().out


def test_pipeline_serve_batch_max_bounds_the_gang():
    """--batch-max is passed to the scheduler as given: three jobs with
    a bound of 2 on one worker make one gang of two and one solo job."""
    summary = pipeline_serve.main(["--jobs", "3", "--workers", "1",
                                   "--batch", "--batch-max", "2",
                                   "--device", "cpu", "--n-det", "16",
                                   "--n-angles", "12"])
    assert summary["gangs_run"] == 1
    assert summary["max_abs_err_vs_serial"] < 1e-4


def _broker_modes(mode, capsys):
    """Drive one broker mode of ``pipeline_serve`` on the CPU and return
    what it showed: the demo's summary, the served broker's scoreboard
    (a subprocess, read over HTTP), or the client's cluster table."""
    if mode == "workers_remote":
        return pipeline_serve.main(["--workers-remote", "2", "--jobs", "2",
                                    "--device", "cpu", "--n-det", "16",
                                    "--n-angles", "12"])
    if mode == "serve":
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.pipeline_serve",
             "--serve", "0", "--workers-remote", "1", "--device", "cpu"],
            stdout=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        try:
            line = proc.stdout.readline()
            url = line.split("listening on ")[1].split()[0]
            client = PipelineClient(url, timeout=30.0)
            jid = client.submit(standard_chain(n_det=16, n_angles=12,
                                               n_rows=1, device="cpu"))
            return line, client.wait(jid, timeout=120), client.cluster()
        finally:
            # an interrupt, as at a terminal: the server stops the
            # workers it spawned before it exits
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=60)
    svc = PipelineService(device="cpu", workers_remote=True)
    host, port = svc.serve(port=0)
    try:
        PipelineClient(f"http://{host}:{port}").register_worker(
            worker_id="w0", device="cpu", transport="cuda")
        pipeline_serve.main(["client", "--url", f"http://{host}:{port}",
                             "cluster", "--format", "text"])
        return capsys.readouterr().out
    finally:
        svc.stop()


@pytest.mark.parametrize("mode", ["serve", "workers_remote", "client"])
def test_pipeline_serve_broker_modes_on_the_cpu(mode, capsys):
    """Broker mode served (a broker and a spawned worker answering a
    job), in the demo (two worker processes, every job verified against
    a serial run), and the client's cluster view."""
    out = _broker_modes(mode, capsys)
    if mode == "workers_remote":
        assert out["jobs"] == 2 and out["max_abs_err_vs_serial"] == 0.0
        assert sum(out["per_worker_done"].values()) == 2
    elif mode == "serve":
        line, snap, cluster = out
        assert "pipeline broker listening" in line
        assert snap["state"] == "done", snap
        (w,) = cluster["workers"]
        assert (w["device"], w["transport"], w["jobs_done"]) == \
            ("cpu", "cuda", 1)
    else:
        assert out.splitlines()[0].split()[:3] == \
            ["WORKER", "DEVICE", "TRANSPORT"]
        assert out.splitlines()[1].split()[:3] == ["w0", "cpu", "cuda"]


def test_pipeline_service_broker_mode_on_the_cpu():
    """``workers_remote=True`` builds a broker instead of the scheduler;
    its stats say so, and the local-mode-only ``executables_dir`` check
    holds."""
    svc = PipelineService(device="cpu", workers_remote=True)
    try:
        assert svc.scheduler is None and svc.engine is svc.broker
        assert svc.stats()["mode"] == "broker"
    finally:
        svc.stop()
    with pytest.raises(ValueError, match="broker"):
        PipelineService(device="cpu", executables_dir="/nowhere")


def test_pipeline_serve_cost_analysis_on_the_cpu(capsys):
    """--cost-analysis runs (the demo's spans carry the step costs)."""
    summary = pipeline_serve.main(["--jobs", "1", "--workers", "1",
                                   "--device", "cpu", "--n-det", "16",
                                   "--n-angles", "12", "--cost-analysis"])
    assert summary["jobs"] == 1
    with pytest.raises(SystemExit, match="--transport cuda"):
        pipeline_serve.main(["--jobs", "1", "--device", "cpu",
                             "--transport", "inmemory", "--cost-analysis"])
