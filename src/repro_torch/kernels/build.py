"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
with a plain C interface, all sources at once in parallel, and linked
into one shared library that ``ctypes`` loads.  The build happens at the
first launch, from the sources in the checkout, into ``build/kernels/``
at the repository root; the library's file name carries a hash of the
sources and flags, so an edited source is never served a stale build.

A process may instead be given a resolver (:func:`use_resolver`): a
callable that returns the path of the library to load.  A broker-mode
worker passes its compile cache's, which looks in the worker's own disk
tier, then asks the broker, and only then runs ``nvcc`` into that
directory (``service.compile_cache.CompileCache.kernel_library``).
Each ``nvcc`` build is counted (:data:`nvcc_runs`) and recorded as a
``kernels.build`` span on the current trace; the load is a
``kernels.load`` span.

Nothing here runs at import: the CPU tests import every module on a host
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import torch

from ..device import nvcc_path
from ..obs.trace import current_trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", *ARCH]

#: how many times this process ran ``nvcc`` (a library found on disk or
#: fetched from a broker is no run)
nvcc_runs = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join([nvcc, *FLAGS]).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built on this host")
    return nvcc


def digest() -> str:
    """The digest of this checkout's sources and flags and the compiler's
    path: what names one exact build of the library."""
    return _digest(_nvcc())


def build(directory: str | Path | None = None) -> Path:
    """Compile and link the kernel library into ``directory`` (default
    :data:`BUILD_DIR`) if this exact build is not there yet; returns its
    path.  Raises with the compiler's output when ``nvcc`` is missing or
    a source does not compile."""
    global nvcc_runs
    nvcc = _nvcc()
    directory = Path(directory) if directory is not None else BUILD_DIR
    lib = directory / f"libtomo_kernels-{_digest(nvcc)}.so"
    if lib.exists():
        return lib
    directory.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=directory))
    procs: list[subprocess.Popen] = []
    t0 = time.time()
    try:
        objs = [work / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", str(src), "-o",
                                   str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        with _LOCK:
            nvcc_runs += 1
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, log) for src, p, log
                  in zip(sources(), procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o",
                               str(work / lib.name), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        (directory / "build.log").write_text("\n".join(
            f"--- {src.name}\n{log}" for src, log in zip(sources(), logs)))
        os.replace(work / lib.name, lib)   # atomic for concurrent builders
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    tr = current_trace()
    if tr is not None:
        tr.record("kernels.build", t0, time.time(),
                  attrs={"library": lib.name, "sources": len(sources())})
    return lib


#: guards the first build and load: the service's worker threads may
#: make their first launches together, and each must find the one
#: library, built once
_LOCK = threading.RLock()
_LIB: ctypes.CDLL | None = None
_FUNCS: dict[tuple[str, tuple], ctypes._CFuncPtr] = {}
_RESOLVER: Callable[[], Path] | None = None


def use_resolver(resolver: Callable[[], str | Path] | None) -> None:
    """Have this process's first launch load the library at
    ``resolver()`` instead of building into :data:`BUILD_DIR` (None
    restores the default).  Set it before the first launch: the library
    is resolved and loaded once per process."""
    global _RESOLVER
    with _LOCK:
        _RESOLVER = resolver


def library() -> ctypes.CDLL:
    """The loaded kernel library (resolved or built on first use, once,
    whichever thread asks first; the others wait for it)."""
    global _LIB
    lib = _LIB
    if lib is not None:
        return lib
    with _LOCK:
        if _LIB is None:
            path = Path(_RESOLVER() if _RESOLVER is not None else build())
            t0 = time.time()
            lib = ctypes.CDLL(str(path))
            lib.tomo_error_string.argtypes = [ctypes.c_int]
            lib.tomo_error_string.restype = ctypes.c_char_p
            tr = current_trace()
            if tr is not None:
                tr.record("kernels.load", t0, time.time(),
                          attrs={"library": path.name,
                                 "nvcc_runs": nvcc_runs})
            _LIB = lib
        return _LIB


def function(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32
    bits); every entry point returns a ``cudaError_t`` as ``int``."""
    key = (name, argtypes)
    fn = _FUNCS.get(key)
    if fn is not None:
        return fn
    lib = library()
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
        return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned another code than cudaSuccess."""
    if err != 0:
        msg = library().tomo_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {err} ({msg})")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device`` (a tensor's
    device, so its index is set), for the launch: read raw, without
    building a ``torch.cuda.Stream`` on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def on(device: torch.device):
    """``device`` current for a launch.  A C entry's
    ``cudaFuncSetAttribute`` and its launch act on the current device, so
    a tensor on another card than the current one (a sharded transport's
    slot) must make its own card current first: launching onto another
    device's stream fails ("invalid resource handle")."""
    return torch.cuda.device(device)


def ptr(t: torch.Tensor) -> int:
    """A tensor's device address, for an argument declared ``c_void_p``."""
    return t.data_ptr()


def require(t: torch.Tensor, name: str, dtypes: tuple[torch.dtype, ...],
            shape: tuple[int | None, ...], device: torch.device | None = None
            ) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of one of
    ``dtypes`` whose shape matches ``shape`` (None: any size), on
    ``device`` when given."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA tensor, "
                         f"got {getattr(t, 'device', type(t))}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of "
                         f"{dtypes}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
