"""The port stands alone: it imports neither jax nor the JAX package,
and its entry points never carry on on the CPU when the card is asked
for and absent."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.core import ChunkedFileTransport, InMemoryTransport, \
    PluginRunner
from repro_torch.configs import get_config
from repro_torch.kernels.backproject.ops import backproject
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.tomo import ParallelGeometry, forward_project, \
    standard_chain

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


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
                    "repro_torch.models.convert", "repro_torch.training",
                    "repro_torch.launch.serve", *ops]],
        "print('imported')"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


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
], ids=["resolve_device", "inmemory", "chunked", "forward_project",
        "build_model", "serve"])
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
