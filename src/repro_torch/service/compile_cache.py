"""Process-level built-step cache, with the kernel library's persistent
tier.

The paper's headline workload is "the same pipeline over many datasets":
at a facility, hundreds of scans a day run one tuned process list.  The
service keeps ONE cache for the whole process, shared by every job's
:class:`~repro_torch.core.transport.CudaTransport`, so a resubmitted
process list finds every plugin step already built.

Keys come from ``CudaTransport._plugin_key``: (plugin static identity,
in/out dataset shapes/dtypes/patterns, constants structure, driver,
device).  Values are built steps whose setup-derived constants
(dark/flat fields, filter banks...) are arguments, so a hit is valid
across jobs even when calibration data differs.

The cache also keeps each step's cost profile
(``CudaTransport.plugin_cost``), so with cost analysis on a distinct
step is measured once per process, not once per job.

Beyond the in-memory tier (valid for one process), an entry built with
``serializable=True`` is a file — the hand-written kernels' shared
library, the one artifact a cold process really pays for (``nvcc``;
the steps themselves are cheap Python closures).  Such an entry is
**persisted**: its bytes, framed with a header, go into an
:class:`ExecutableStore` under :func:`executable_signature` — a digest
of the cache key PLUS the toolchain and card fingerprint
(:func:`env_fingerprint`), so a library built under another torch, CUDA,
``nvcc`` or card is never loaded (its signature differs, and its header
is re-checked on load).  A fresh worker process pointed at the same
store — or prefetching from the broker's spool (``GET
/executables/{sig}``) — loads the library in milliseconds instead of
compiling it (docs/worker-protocol.md; :meth:`CompileCache.kernel_library`).

Thread-safety: one build per key even under concurrent misses — losers
of the build race block on the winner's per-key event rather than
building twice.  Cost measurements run one at a time, under their own
lock.  :meth:`CompileCache.clear` bumps a generation counter
so a build that was already in flight when the clear happened cannot
re-insert its (now unwanted) entry afterwards.

The port's counterpart of ``repro.service.compile_cache``; where the
JAX package serializes compiled executables, the payload here is the
built kernel library.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable

import torch

from ..device import nvcc_path
from ..kernels import build as kernel_build
from ..obs.trace import current_trace

#: on-disk payload framing: magic + one JSON header line + the library's
#: bytes (the JAX package frames its executables the same way; the
#: fingerprints never match, so neither package loads the other's)
_MAGIC = b"SAVUEXE1\n"

_HEX = frozenset("0123456789abcdef")


class StaleExecutable(Exception):
    """A persisted library payload cannot be loaded into THIS process:
    corrupted/truncated bytes, a header written under another toolchain
    or card, a signature mismatch, or a library ``ctypes`` cannot load.
    Always recoverable — the caller builds fresh."""


_fingerprint_cache: dict[str, Any] | None = None


def _nvcc_release() -> str | None:
    """The ``release ...`` part of ``nvcc --version`` (None without
    ``nvcc``)."""
    nvcc = nvcc_path()
    if nvcc is None:
        return None
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    m = re.search(r"release (.+)$", out, re.MULTILINE)
    return m.group(1).strip() if m else "unknown"


def env_fingerprint() -> dict[str, Any]:
    """The toolchain+hardware identity a built library is only valid
    under: torch and its CUDA version, the ``nvcc`` release, the cards'
    names and compute capabilities, and their count.  Baked into every
    payload header AND into :func:`executable_signature`, so stale
    entries are rejected twice over (different signature, and a header
    mismatch on load) rather than ever being silently loaded."""
    global _fingerprint_cache
    if _fingerprint_cache is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _fingerprint_cache = {
            "fmt": 1,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": _nvcc_release(),
            "devices": sorted({torch.cuda.get_device_name(i)
                               for i in range(n)}),
            "capability": sorted({"%d.%d" % torch.cuda.get_device_capability(i)
                                  for i in range(n)}),
            "n_devices": n,
        }
    return _fingerprint_cache


def executable_signature(key: Any) -> str:
    """Stable hex digest naming one persisted artifact across processes:
    sha256 over the cache key's repr (for the kernel library
    ``("kernels", <digest of sources and flags>)``) salted with
    :func:`env_fingerprint`.  This is the ``{sig}`` in ``GET/PUT
    /executables/{sig}``."""
    fp = json.dumps(env_fingerprint(), sort_keys=True)
    return hashlib.sha256(f"{fp}|{key!r}".encode()).hexdigest()


def serialize_payload(library: os.PathLike, sig: str) -> bytes:
    """Frame a built library file for disk/wire: magic + JSON header
    (signature + env fingerprint) + the file's bytes.  Raises TypeError
    for a value that is not a path object, OSError when the file cannot
    be read."""
    if not isinstance(library, os.PathLike):
        raise TypeError(f"not a library path: {type(library).__name__}")
    body = Path(library).read_bytes()
    header = json.dumps({"sig": sig, "fingerprint": env_fingerprint()},
                        sort_keys=True).encode()
    return _MAGIC + header + b"\n" + body


def deserialize_payload(payload: bytes, sig: str | None = None,
                        dest: str | os.PathLike | None = None) -> Path:
    """Write a framed payload's library to ``dest`` (default: a new
    temporary file) and check that ``ctypes`` loads it; returns its path.

    Every failure mode — bad magic, truncated bytes, unparseable
    header, a fingerprint from another toolchain or card, a signature
    mismatch, a library that cannot be loaded — raises
    :class:`StaleExecutable`; nothing is ever silently loaded wrong.
    """
    if not payload.startswith(_MAGIC):
        raise StaleExecutable("bad magic (not a framed library)")
    try:
        nl = payload.index(b"\n", len(_MAGIC))
        header = json.loads(payload[len(_MAGIC):nl])
    except (ValueError, UnicodeDecodeError) as e:
        raise StaleExecutable(f"unparseable header: {e}") from None
    if not isinstance(header, dict):
        raise StaleExecutable("header is not an object")
    if header.get("fingerprint") != env_fingerprint():
        raise StaleExecutable(
            f"toolchain mismatch: payload built under "
            f"{header.get('fingerprint')!r}, this process is "
            f"{env_fingerprint()!r}")
    if sig is not None and header.get("sig") != sig:
        raise StaleExecutable(
            f"signature mismatch: header says {header.get('sig')!r}")
    if dest is None:
        fd, dest = tempfile.mkstemp(suffix=".so")
        os.close(fd)
    dest = Path(dest)
    tmp = dest.with_name(f"{dest.name}.{os.getpid()}.tmp")
    try:
        tmp.write_bytes(payload[nl + 1:])
        os.replace(tmp, dest)           # a reader never sees a torn file
        ctypes.CDLL(str(dest))
    except OSError as e:
        for path in (tmp, dest):
            try:
                os.unlink(path)
            except OSError:
                pass
        raise StaleExecutable(f"unloadable library: {e}") from None
    return dest


def _safe_sig(sig: str) -> str:
    """A signature that may become a filename: lowercase hex only."""
    if not (isinstance(sig, str) and 8 <= len(sig) <= 128
            and set(sig) <= _HEX):
        raise ValueError(f"not a hex executable signature: {sig!r}")
    return sig


class ExecutableStore:
    """Disk spool of framed library payloads keyed by signature.

    Used on both ends of the warm-pool protocol: a worker's local disk
    tier (payloads it built or prefetched, beside the libraries loaded
    from them) and the broker's spool (payloads uploaded by workers,
    served to newly registered ones).  Raw payload bytes only — the
    broker never loads a library.

    Retention is LRU by total bytes (``max_bytes``); use counts feed
    :meth:`hot` — the "prefetch these first" list a registration reply
    carries.  All writes are atomic (tmp + rename), so a reader never
    sees a torn payload.
    """

    def __init__(self, directory: str, max_bytes: int = 512 << 20):
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        #: per-signature use count (puts + gets) — the heat signal
        self._uses: dict[str, int] = {}
        #: insertion/use order for LRU eviction
        self._order: list[str] = []
        self.puts = 0
        self.evictions = 0
        for name in sorted(os.listdir(self.dir)):   # adopt prior spool
            if name.endswith(".exe"):
                sig = name[:-4]
                self._uses.setdefault(sig, 0)
                self._order.append(sig)

    def _path(self, sig: str) -> str:
        return os.path.join(self.dir, f"{_safe_sig(sig)}.exe")

    def library_path(self, sig: str) -> str:
        """Where the library of ``sig`` is written when it is loaded."""
        return os.path.join(self.dir, f"{_safe_sig(sig)}.so")

    def _unlink(self, sig: str) -> None:
        """Remove an entry's payload and the library loaded from it."""
        for ext in (".exe", ".so"):
            try:
                os.unlink(os.path.join(self.dir, f"{sig}{ext}"))
            except OSError:
                pass

    def _touch_locked(self, sig: str) -> None:
        self._uses[sig] = self._uses.get(sig, 0) + 1
        if sig in self._order:
            self._order.remove(sig)
        self._order.append(sig)

    def has(self, sig: str) -> bool:
        try:
            return os.path.exists(self._path(sig))
        except ValueError:
            return False

    def get_bytes(self, sig: str) -> bytes | None:
        """The raw payload for ``sig`` (None if absent).  Counts a use
        — repeated fetches mark the signature hot."""
        try:
            path = self._path(sig)
        except ValueError:
            return None
        try:
            with open(path, "rb") as fh:
                payload = fh.read()
        except OSError:
            return None
        with self._lock:
            self._touch_locked(sig)
        return payload

    def put_bytes(self, sig: str, payload: bytes) -> bool:
        """Store one payload (idempotent: re-putting an existing
        signature just marks it hot).  Only framed payloads are
        accepted — arbitrary bytes can't enter the spool.  Evicts LRU
        entries beyond ``max_bytes``.  Returns True if stored/present.
        """
        try:
            path = self._path(sig)
        except ValueError:
            return False
        if not payload.startswith(_MAGIC):
            return False
        with self._lock:
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                try:
                    with open(tmp, "wb") as fh:
                        fh.write(payload)
                    os.replace(tmp, path)
                except OSError:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    return False
                self.puts += 1
            self._touch_locked(sig)
            self._evict_locked()
        return True

    def discard(self, sig: str) -> None:
        """Drop one entry (e.g. a payload that failed to load — no
        point re-reading it on every miss)."""
        try:
            _safe_sig(sig)
        except ValueError:
            return
        with self._lock:
            self._unlink(sig)
            self._uses.pop(sig, None)
            if sig in self._order:
                self._order.remove(sig)

    def _evict_locked(self) -> None:
        while self.total_bytes() > self.max_bytes and len(self._order) > 1:
            victim = self._order.pop(0)
            self._uses.pop(victim, None)
            self._unlink(victim)
            self.evictions += 1

    def total_bytes(self) -> int:
        total = 0
        try:
            for name in os.listdir(self.dir):
                if name.endswith(".exe"):
                    try:
                        total += os.path.getsize(
                            os.path.join(self.dir, name))
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    def signatures(self) -> list[str]:
        with self._lock:
            return list(self._order)

    def hot(self, n: int = 8) -> list[str]:
        """The ``n`` most-used signatures, hottest first — what a
        registration reply tells a fresh worker to prefetch."""
        with self._lock:
            ranked = sorted(self._uses.items(),
                            key=lambda kv: (-kv[1],
                                            -self._order.index(kv[0])
                                            if kv[0] in self._order
                                            else 0))
        return [sig for sig, _ in ranked[:n] if self.has(sig)]

    def clear(self) -> None:
        """Drop every entry (a cache invalidation must reach disk too —
        otherwise a cleared library would come straight back on the
        next miss)."""
        with self._lock:
            for sig in list(self._order):
                self._unlink(sig)
            self._order.clear()
            self._uses.clear()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            n = len(self._order)
        return {"entries": n, "bytes": self.total_bytes(),
                "puts": self.puts, "evictions": self.evictions}


class CompileCache:
    """Process-level built-step cache (paper §I: "the same pipeline,
    many datasets" — resubmission must not rebuild), with an optional
    persistent tier for the kernel library that survives the process."""

    def __init__(self, max_entries: int | None = None,
                 store: ExecutableStore | str | None = None,
                 fetch: Callable[[str], bytes | None] | None = None,
                 publish: Callable[[str, bytes], Any] | None = None):
        """Args:
            max_entries: FIFO-evict beyond this many built steps (None =
                unbounded).
            store: disk tier — an :class:`ExecutableStore` or a
                directory path (None = in-memory only).  Only entries
                built with ``serializable=True`` use it.
            fetch: optional ``sig -> payload bytes | None`` callback
                consulted on a disk miss BEFORE building (the worker
                wires ``GET /executables/{sig}`` here).  Failures fall
                back to a fresh build.
            publish: optional ``(sig, payload) -> None`` callback run
                after a fresh serializable build (the worker wires
                ``PUT /executables/{sig}`` here).  Best-effort.

        Note: an EMPTY cache is falsy (``__len__``) — test ``is None``,
        never truthiness, when defaulting."""
        self.max_entries = max_entries
        self.store = (ExecutableStore(store) if isinstance(store, str)
                      else store)
        self.fetch = fetch
        self.publish = publish
        self._entries: dict[Any, Any] = {}
        self._building: dict[Any, threading.Event] = {}
        self._lock = threading.Lock()
        self._generation = 0
        self._costs: dict[Any, Any] = {}
        self._cost_lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.build_s = 0.0               # total wall spent building
        self.disk_hits = 0               # loaded instead of built
        self.disk_misses = 0             # persisted tier had nothing usable
        self.disk_rejects = 0            # stale/corrupt payloads refused
        self.uploads = 0                 # payloads handed to ``publish``

    def get_or_build(self, key, builder: Callable[[], Any],
                     serializable: bool = False):
        """Return the cached value for ``key``, building it (once) on a
        miss.

        Args:
            key: hashable identity (``CudaTransport._plugin_key``, or
                ``("kernels", digest)`` for the kernel library).
            builder: zero-arg callable producing the value; invoked at
                most once per key even under concurrent misses — losers
                of the build race block on the winner.
            serializable: the builder produces a file (the kernel
                library) — on a memory miss the persistent tier is
                consulted first (disk, then the ``fetch`` callback), and
                a fresh build is framed back out (disk + ``publish``).

        Returns: the cached/built value.  A ``builder`` that raises
        propagates to its caller; waiting losers retry (and one of them
        becomes the next builder).
        """
        while True:
            with self._lock:
                if key in self._entries:
                    self.hits += 1
                    return self._entries[key]
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    self.misses += 1
                    # snapshot the generation BEFORE building: a clear()
                    # issued mid-build bumps it, and the late winner
                    # below must then be dropped, not re-inserted
                    gen = self._generation
                    break
            ev.wait()                    # someone else is building this key
        try:
            fn = None
            sig = None
            if serializable and self.store is not None:
                sig = executable_signature(key)
                fn = self._load_persisted(sig)
            if fn is None:
                t0 = time.perf_counter()
                t0_epoch = time.time()
                fn = builder()
                dt = time.perf_counter() - t0
                tr = current_trace()
                if tr is not None and not serializable:
                    # actual step builds (never hits) show up as
                    # ``compile`` spans on whichever job triggered them;
                    # the library's build records its own kernels.build
                    tr.record("compile", t0_epoch, t0_epoch + dt,
                              attrs={"kind": key[0] if isinstance(key, tuple)
                                     and key else "plugin"})
                with self._lock:
                    self.build_s += dt
                if sig is not None:
                    self._persist(sig, fn)
            with self._lock:
                if self._generation != gen:
                    # cleared while we were building: hand the value to
                    # the caller (it is still correct for THIS call) but
                    # never cache it
                    return fn
                self._entries[key] = fn
                if (self.max_entries is not None
                        and len(self._entries) > self.max_entries):
                    # FIFO eviction — steps are all roughly the same
                    # size; recency tracking is not worth the locking
                    oldest = next(iter(self._entries))
                    del self._entries[oldest]
                    self.evictions += 1
            return fn
        finally:
            with self._lock:
                self._building.pop(key).set()

    def kernel_library(self) -> Path:
        """The path of the kernel library this process should load: the
        memory tier, then the store on disk, then the ``fetch``
        callback, and only then ``nvcc`` into the store's directory
        (framed into the store and handed to ``publish``).  Without a
        store, the library built into ``build/kernels/``.  What a worker
        hands ``kernels.build.use_resolver``."""
        if self.store is None:
            return kernel_build.build()
        directory = self.store.dir
        return Path(self.get_or_build(
            ("kernels", kernel_build.digest()),
            lambda: kernel_build.build(directory), serializable=True))

    # -- persistent tier ------------------------------------------------
    def _load_persisted(self, sig: str) -> Path | None:
        """A loadable library for ``sig`` from the persistent tier —
        local disk first, then the broker ``fetch`` callback — or None
        (count a disk miss; the caller builds).  Loads record
        ``executable.fetch`` + ``executable.deserialize`` spans on the
        current trace, as a real build records ``kernels.build``."""
        tr = current_trace()
        t0 = time.time()
        payload = self.store.get_bytes(sig)
        source = "disk"
        if payload is None and self.fetch is not None:
            try:
                payload = self.fetch(sig)
            except Exception:            # noqa: BLE001 — network is advisory
                payload = None
            source = "broker"
            if payload is not None:
                self.store.put_bytes(sig, payload)
        if payload is None:
            with self._lock:
                self.disk_misses += 1
            return None
        if tr is not None:
            tr.record("executable.fetch", t0, time.time(),
                      attrs={"sig": sig[:16], "source": source,
                             "bytes": len(payload)})
        t1 = time.time()
        try:
            path = deserialize_payload(payload, sig,
                                       self.store.library_path(sig))
        except StaleExecutable:
            # never silently loaded: corrupt/version-mismatched payloads
            # are dropped from disk and the caller builds fresh
            with self._lock:
                self.disk_rejects += 1
                self.disk_misses += 1
            self.store.discard(sig)
            return None
        if tr is not None:
            tr.record("executable.deserialize", t1, time.time(),
                      attrs={"sig": sig[:16]})
        with self._lock:
            self.disk_hits += 1
        return path

    def _persist(self, sig: str, fn: Any) -> None:
        """Frame a fresh build into the store and hand it to
        ``publish``.  Best-effort on both counts: a value that is no
        file (or a broker that refuses the upload) must never fail the
        job that built it."""
        try:
            payload = serialize_payload(fn, sig)
        except (TypeError, OSError):     # not a file: nothing to persist
            return
        self.store.put_bytes(sig, payload)
        if self.publish is not None:
            try:
                self.publish(sig, payload)
                with self._lock:
                    self.uploads += 1
            except Exception:            # noqa: BLE001 — upload is advisory
                pass

    def prefetch(self, sigs: list[str]) -> int:
        """Warm-pool fill: fetch every signature not already on disk
        via the ``fetch`` callback (the broker's hottest list, carried
        on the registration reply).  Returns how many payloads landed.
        Purely additive — failures are skipped."""
        if self.store is None or self.fetch is None:
            return 0
        n = 0
        for sig in sigs or ():
            if not isinstance(sig, str) or self.store.has(sig):
                continue
            try:
                payload = self.fetch(sig)
            except Exception:            # noqa: BLE001
                continue
            if payload and self.store.put_bytes(sig, payload):
                n += 1
        return n

    def cost(self, key, measure: Callable[[], Any]):
        """The cost profile of step ``key``: ``measure()`` on a miss,
        run while no other measurement runs (a measurement is an extra
        run of the step), then kept for every later caller."""
        with self._cost_lock:
            if key not in self._costs:
                self._costs[key] = measure()
            return self._costs[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        """Drop every cached step (counters are kept) — including the
        persistent tier, and including builds currently in flight: the
        generation bump makes a pre-clear builder's late insert a
        no-op."""
        with self._lock:
            self._generation += 1
            self._entries.clear()
        if self.store is not None:
            self.store.clear()

    def stats(self) -> dict[str, Any]:
        """Counters: ``hits``, ``misses``, ``entries``, ``evictions``,
        total ``build_s``, the clear ``generation`` and — when a
        persistent tier is configured — a ``disk`` block with its
        hit/miss/reject/upload counters and store occupancy."""
        with self._lock:
            out: dict[str, Any] = {
                "hits": self.hits, "misses": self.misses,
                "entries": len(self._entries),
                "evictions": self.evictions,
                "build_s": round(self.build_s, 4),
                "generation": self._generation}
            disk = {"hits": self.disk_hits, "misses": self.disk_misses,
                    "rejects": self.disk_rejects, "uploads": self.uploads}
        if self.store is not None:
            out["disk"] = {**disk, **self.store.stats()}
        return out
