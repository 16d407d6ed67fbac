"""The kernel library as the port's persistent executable, against
tests/test_executables.py, on the CPU.

Where the JAX package serializes compiled executables, the port persists
the one thing a cold process pays for: the hand-written kernels' shared
library (``nvcc``).  Covers: payload framing (corrupt, truncated,
other-toolchain, mis-signed and unloadable payloads are ALWAYS rejected,
never loaded — and neither package loads the other's), the
``ExecutableStore`` spool (LRU retention, heat ranking), the
``CompileCache`` disk tier (a second store-backed cache loads the library
instead of building it: the build is replaced by a counting fake that
copies a loadable shared object, so this runs without ``nvcc``), the
clear()-during-build generation guard, the monotonic lease clock,
per-worker secrets over HTTP, the broker warm pool end to end (a cold
worker prefetches the library at registration and resolves it with
``executable.fetch`` spans and no ``kernels.build``), and
``kernels.build.build`` itself driven by a stand-in ``nvcc``: one run
per build, a ``kernels.build`` span, and two processes building into one
directory at once ending with one library.
"""
import _ctypes
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest

from repro.service import compile_cache as jax_cc

from repro_torch.kernels import build
from repro_torch.obs.trace import Trace, use_trace
from repro_torch.service import (CompileCache, PipelineClient,
                                 PipelineService, PipelineWorker,
                                 ServiceError)
from repro_torch.service import scheduler as sched_mod
from repro_torch.service.compile_cache import (_MAGIC, ExecutableStore,
                                               StaleExecutable,
                                               deserialize_payload,
                                               env_fingerprint,
                                               executable_signature,
                                               serialize_payload)

#: a shared object ``ctypes`` loads on any host with CPython: what the
#: fake builds hand out as "the library"
LOADABLE = _ctypes.__file__
ROOT = Path(__file__).resolve().parents[1]


def _framed(sig: str, body: bytes = b"opaque-library-bytes") -> bytes:
    """A payload that passes the store's framing check (the store never
    loads, so the body can be anything)."""
    header = json.dumps({"sig": sig, "fingerprint": env_fingerprint()},
                        sort_keys=True).encode()
    return _MAGIC + header + b"\n" + body


def _spec(seed=0):
    """The standard tomo chain as a wire spec (matches test_torch_worker)."""
    return {"version": 1, "plugins": [
        {"plugin": "synthetic_tomo_loader",
         "params": {"n_det": 16, "n_angles": 8, "n_rows": 1,
                    "seed": seed},
         "out_datasets": ["tomo"]},
        {"plugin": "dark_flat_correction",
         "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["tomo"]},
        {"plugin": "fbp_recon", "params": {"use_pallas": False},
         "in_datasets": ["tomo"], "out_datasets": ["recon"]},
        {"plugin": "hdf5_saver", "in_datasets": ["recon"]},
    ]}


@pytest.fixture
def broker(tmp_path):
    svc = PipelineService(device="cpu", workers_remote=True, lease_ttl=30.0,
                          sweep_interval=999.0,
                          executables_dir=str(tmp_path / "spool"))
    host, port = svc.serve(port=0)
    client = PipelineClient(f"http://{host}:{port}", timeout=60.0)
    try:
        yield svc, client
    finally:
        svc.stop()


@pytest.fixture
def fake_build(monkeypatch):
    """``build.build`` replaced by a counting fake that "compiles" by
    copying a loadable shared object into the directory it is given,
    under a fixed digest; returns the list of directories it built
    into."""
    calls = []

    def fake(directory=None):
        calls.append(directory)
        lib = Path(directory) / "libtomo_kernels-fake.so"
        lib.write_bytes(Path(LOADABLE).read_bytes())
        return lib

    monkeypatch.setattr(build, "build", fake)
    monkeypatch.setattr(build, "digest", lambda: "fake")
    return calls


# ======================================================== signatures
def test_executable_signature_stable_hex_and_key_sensitive():
    a = executable_signature(("kernels", "0123abcd"))
    assert a == executable_signature(("kernels", "0123abcd"))
    assert a != executable_signature(("kernels", "0123abce"))
    assert len(a) == 64 and set(a) <= set("0123456789abcdef")
    fp = env_fingerprint()
    assert {"torch", "cuda", "nvcc", "devices", "capability",
            "n_devices"} <= set(fp)


def test_deserialize_rejects_every_bad_payload(tmp_path):
    """No payload that isn't exactly a framed, fingerprint-matching,
    loadable library may ever load."""
    good_sig = "ab" * 16
    with pytest.raises(StaleExecutable):
        deserialize_payload(b"not a library at all")
    with pytest.raises(StaleExecutable):        # truncated mid-header
        deserialize_payload(_MAGIC + b'{"sig": "abc')
    dest = tmp_path / "lib.so"
    with pytest.raises(StaleExecutable):        # ctypes cannot load it
        deserialize_payload(_framed(good_sig, b"\x00garbage"), dest=dest)
    assert not dest.exists()                    # never left behind
    stale = dict(env_fingerprint())
    stale["torch"] = "0.0.1"                    # another toolchain
    header = json.dumps({"sig": good_sig, "fingerprint": stale}).encode()
    with pytest.raises(StaleExecutable):
        deserialize_payload(_MAGIC + header + b"\n" + b"body")
    with pytest.raises(StaleExecutable):        # signature mismatch
        deserialize_payload(_framed("cd" * 16), sig=good_sig)
    # a framed, loadable library round-trips byte for byte
    path = deserialize_payload(serialize_payload(Path(LOADABLE), good_sig),
                               good_sig, dest)
    assert path == dest and dest.read_bytes() == Path(LOADABLE).read_bytes()


def test_payloads_never_cross_packages(tmp_path):
    """A JAX executable is refused by the port and a port library by the
    JAX package — as StaleExecutable, never loaded."""
    sig = "ab" * 16
    jax_header = json.dumps({"sig": sig,
                             "fingerprint": jax_cc.env_fingerprint()},
                            sort_keys=True).encode()
    jax_payload = jax_cc._MAGIC + jax_header + b"\n" + b"pickled-exe"
    with pytest.raises(StaleExecutable, match="toolchain mismatch"):
        deserialize_payload(jax_payload, sig, tmp_path / "x.so")
    assert not (tmp_path / "x.so").exists()
    with pytest.raises(jax_cc.StaleExecutable, match="toolchain mismatch"):
        jax_cc.deserialize_payload(serialize_payload(Path(LOADABLE), sig),
                                  sig)


# ==================================================== ExecutableStore
def test_store_framing_lru_and_heat(tmp_path):
    store = ExecutableStore(str(tmp_path / "s"), max_bytes=4096)
    sig_a, sig_b = "aa" * 8, "bb" * 8
    assert store.put_bytes(sig_a, b"raw junk") is False    # unframed
    assert store.put_bytes("NOT-HEX!", _framed("aa" * 8)) is False
    assert store.put_bytes(sig_a, _framed(sig_a)) is True
    assert store.put_bytes(sig_b, _framed(sig_b)) is True
    assert store.get_bytes(sig_a) == _framed(sig_a)
    assert store.get_bytes("ee" * 8) is None
    # heat: every put/get counts a use; sig_a has 2, sig_b has 1
    assert store.hot(2) == [sig_a, sig_b]
    # LRU: a payload pushing past max_bytes evicts the least recent
    big = _framed("cc" * 8, b"x" * 4096)
    assert store.put_bytes("cc" * 8, big) is True
    assert not store.has(sig_b)                 # b was least recent
    assert store.has(sig_a) or store.evictions >= 1
    # a new store over the same directory adopts surviving entries
    adopted = ExecutableStore(str(tmp_path / "s"), max_bytes=4096)
    assert set(adopted.signatures()) == set(store.signatures())
    store.clear()
    assert store.signatures() == [] and store.total_bytes() == 0


# ================================================== CompileCache tiers
def test_disk_tier_second_cache_loads_instead_of_building(tmp_path,
                                                          fake_build):
    """Two caches over one store directory = two worker processes over
    a shared disk tier: the second loads the library the first built —
    zero builds — and it is the same library byte for byte."""
    store_dir = str(tmp_path / "exe")
    warm = CompileCache(store=store_dir)
    lib1 = warm.kernel_library()
    assert fake_build == [store_dir]            # built once, into the tier
    assert warm.stats()["disk"]["hits"] == 0    # nothing persisted yet
    assert warm.stats()["disk"]["puts"] == 1    # the library landed
    assert warm.kernel_library() == lib1        # memory tier: no rebuild
    assert len(fake_build) == 1

    cold = CompileCache(store=store_dir)
    lib2 = cold.kernel_library()
    st = cold.stats()
    assert st["disk"]["hits"] == 1 and st["disk"]["rejects"] == 0
    assert st["build_s"] == 0.0 and len(fake_build) == 1   # ZERO builds
    assert lib2.read_bytes() == lib1.read_bytes()


def test_corrupt_store_entries_fall_back_to_fresh_build(tmp_path):
    """Corrupted/truncated/unloadable disk entries must never crash or
    load: the cache rejects them, drops them from disk, and builds
    fresh."""
    store_dir = str(tmp_path / "exe")
    key = ("kernels", "0123abcd")
    sig = executable_signature(key)
    builds = []

    def builder():
        builds.append(1)
        return "freshly-built"                  # no file: not persisted

    for bad in (b"not even framed",
                _framed(sig)[:20],              # truncated
                _framed(sig, b"\x00junk")):     # unloadable library
        cache = CompileCache(store=store_dir)
        cache.store.put_bytes(sig, _framed(sig))   # seed a file...
        with open(os.path.join(store_dir, f"{sig}.exe"), "wb") as fh:
            fh.write(bad)                          # ...then corrupt it
        got = cache.get_or_build(key, builder, serializable=True)
        assert got == "freshly-built"
        if bad.startswith(_MAGIC):              # framed-but-broken ones
            assert cache.disk_rejects == 1      # counted + dropped
            assert not cache.store.has(sig)
    assert len(builds) == 3                     # built fresh each time


def test_clear_generation_guard_blocks_inflight_reinsert():
    """clear() during a build: the build still returns its value to the
    caller, but may NOT re-enter the cache afterwards."""
    cache = CompileCache()
    entered, release = threading.Event(), threading.Event()
    out = []

    def slow_builder():
        entered.set()
        release.wait(5)
        return "stale-step"

    t = threading.Thread(target=lambda: out.append(
        cache.get_or_build("k", slow_builder)))
    t.start()
    assert entered.wait(5)
    cache.clear()                               # invalidate mid-build
    release.set()
    t.join(5)
    assert out == ["stale-step"]                # caller still served
    assert len(cache) == 0                      # ...but never cached
    builds = []
    cache.get_or_build("k", lambda: builds.append(1) or "fresh")
    assert builds == [1]                        # next call rebuilds


def test_clear_invalidates_disk_tier(tmp_path, fake_build):
    cache = CompileCache(store=str(tmp_path / "exe"))
    lib = cache.kernel_library()
    sig = cache.store.signatures()[0]
    cold = CompileCache(store=str(tmp_path / "exe"))
    loaded = cold.kernel_library()              # the <sig>.so beside it
    assert cache.store.has(sig) and loaded.exists() and lib.exists()
    cache.clear()
    assert not cache.store.has(sig)             # cleared through to disk
    assert not loaded.exists()


# ================================================= lease clock
def test_lease_survives_wall_clock_step_but_not_monotonic(broker):
    """Lease expiry uses the monotonic clock: a wall-clock step of +2h
    may not expire a live lease; genuine monotonic passage beyond the
    TTL must."""
    svc, client = broker
    b = svc.broker
    client.register_worker(worker_id="cw")
    jid = client.submit(_spec(seed=1))
    assert client.lease("cw")
    real_wall, real_mono = sched_mod._wall, sched_mod._mono
    try:
        sched_mod._wall = lambda: real_wall() + 7200    # +2h step
        b._expire_locked_sweep()
        assert client.status(jid)["state"] != "queued"  # NOT requeued
        assert client.progress(jid, "cw")["verdict"] == "ok"
        assert client.stats()["leases_expired"] == 0

        sched_mod._mono = lambda: real_mono() + svc.broker.lease_ttl + 1
        b._expire_locked_sweep()
        assert client.stats()["leases_expired"] == 1
        assert client.status(jid)["state"] == "queued"  # requeued
        assert client.progress(jid, "cw")["verdict"] == "lost"
    finally:
        sched_mod._wall, sched_mod._mono = real_wall, real_mono


# ============================================ worker identity
def test_worker_secret_required_and_rotated(broker):
    """lease/complete demand the secret minted at registration: a rogue
    client reusing a worker_id gets 403; re-registration rotates the
    secret."""
    svc, client = broker
    client.register_worker(worker_id="sw")
    old_secret = client.worker_secret("sw")
    jid = client.submit(_spec(seed=2))

    rogue = PipelineClient(client.base_url, timeout=30.0)
    with pytest.raises(ServiceError) as ei:     # no secret at all
        rogue.lease("sw")
    assert ei.value.status == 403
    rogue.adopt_worker_secret("sw", "deadbeef" * 4)
    with pytest.raises(ServiceError) as ei:     # wrong secret
        rogue.lease("sw")
    assert ei.value.status == 403
    with pytest.raises(ServiceError) as ei:     # unregistered worker
        rogue.lease("ghost")
    assert ei.value.status == 404

    assert client.lease("sw")                   # the real holder works
    with pytest.raises(ServiceError) as ei:     # rogue can't complete it
        rogue.complete(jid, "sw", "done")
    assert ei.value.status == 403

    # re-registration mints a FRESH secret — the old one dies with it
    client.register_worker(worker_id="sw")
    assert client.worker_secret("sw") != old_secret
    rogue.adopt_worker_secret("sw", old_secret)
    with pytest.raises(ServiceError) as ei:
        rogue.lease("sw")
    assert ei.value.status == 403


# =========================================== executable endpoints (HTTP)
def test_executable_upload_fetch_and_hot_list(broker):
    svc, client = broker
    client.register_worker(worker_id="ew")
    sig = executable_signature(("kernels", "wire-test"))
    payload = _framed(sig)

    out = client.upload_executable(sig, "ew", payload)
    assert out["stored"] is True and out["bytes"] == len(payload)
    assert client.fetch_executable(sig) == payload
    assert sig in client.hot_executables()
    with pytest.raises(ServiceError) as ei:     # unknown signature
        client.fetch_executable("ee" * 16)
    assert ei.value.status == 404
    with pytest.raises(ServiceError) as ei:     # unframed payload
        client.upload_executable(sig, "ew", b"arbitrary junk")
    assert ei.value.status == 400

    rogue = PipelineClient(client.base_url, timeout=30.0)
    rogue.adopt_worker_secret("ew", "f00d" * 8)
    with pytest.raises(ServiceError) as ei:     # bad secret
        rogue.upload_executable(sig, "ew", payload)
    assert ei.value.status == 403
    # a fresh registration's reply advertises the hot list
    reply2 = client.register_worker(worker_id="ew2")
    assert sig in reply2["hot_executables"]
    assert svc.metrics.gauge("executables.spool.bytes").value \
        == len(payload)


def test_executable_reads_are_token_authed(tmp_path):
    """Unlike the read-only job endpoints, /executables is token-authed
    (a library is code)."""
    svc = PipelineService(device="cpu", workers_remote=True, token="sesame",
                          executables_dir=str(tmp_path / "spool"))
    host, port = svc.serve(port=0)
    url = f"http://{host}:{port}"
    try:
        bare = PipelineClient(url, timeout=30.0)
        for call in (bare.hot_executables,
                     lambda: bare.fetch_executable("ab" * 16)):
            with pytest.raises(ServiceError) as ei:
                call()
            assert ei.value.status == 401
        armed = PipelineClient(url, timeout=30.0, token="sesame")
        assert armed.hot_executables() == []
    finally:
        svc.stop()


# ================================================= warm pool end-to-end
def test_cold_worker_prefetches_and_skips_the_build(broker, tmp_path,
                                                    fake_build):
    """Worker A builds the library (the counting fake) and uploads it; a
    brand-new worker B prefetches it at registration, records the
    prefetch on its first job's trace, and resolves the library with
    ``executable.fetch`` spans and NO ``kernels.build`` — zero builds,
    the same bytes."""
    svc, client = broker
    url = client.base_url

    def make_worker(wid, sub):
        cache = CompileCache(store=str(tmp_path / sub / "exe"))
        return PipelineWorker(url, device="cpu", worker_id=wid, poll=0.01,
                              compile_cache=cache)

    hot = make_worker("hot-w", "wA")
    hot.register()
    assert hot.prefetched == 0                  # spool was empty
    tr_a = Trace()
    with use_trace(tr_a):
        lib_a = hot.compile_cache.kernel_library()
    assert len(fake_build) == 1
    assert hot.compile_cache.uploads == 1       # published to the broker
    assert svc.broker.executables.stats()["entries"] == 1

    cold = make_worker("cold-w", "wB")
    cold.register()
    assert cold.prefetched == 1                 # warm pool landed
    jid = client.submit(_spec(seed=3))
    assert cold.run_once() is True
    assert client.wait(jid, timeout=60)["state"] == "done"
    names = [s["name"] for s in client.trace(jid)["spans"]]
    assert "executable.prefetch" in names       # on the first job's trace
    assert client.cluster()["workers"][0]["prefetched"] == 1

    tr_b = Trace()
    with use_trace(tr_b):
        lib_b = cold.compile_cache.kernel_library()
    names = [s.name for s in tr_b.spans()]
    assert "executable.fetch" in names and "kernels.build" not in names
    assert len(fake_build) == 1                 # B built nothing
    assert cold.compile_cache.stats()["disk"]["hits"] == 1
    assert lib_b.read_bytes() == lib_a.read_bytes()


def test_cold_cache_fetches_from_the_broker_on_a_disk_miss(broker, tmp_path,
                                                           fake_build):
    """Without a prefetch, a disk miss asks the broker (``fetch``) before
    building: source ``broker`` on the ``executable.fetch`` span."""
    svc, client = broker
    a = PipelineWorker(client.base_url, device="cpu", worker_id="a",
                       compile_cache=CompileCache(store=str(tmp_path / "a")))
    a.register()
    a.compile_cache.kernel_library()
    cache = CompileCache(store=str(tmp_path / "b"),
                         fetch=client.fetch_executable)
    tr = Trace()
    with use_trace(tr):
        cache.kernel_library()
    (fetch,) = [s for s in tr.spans() if s.name == "executable.fetch"]
    assert fetch.attrs["source"] == "broker"
    assert len(fake_build) == 1 and cache.disk_hits == 1


# ============================================ the build, with a stand-in nvcc
FAKE_NVCC = textwrap.dedent(f"""\
    #!{sys.executable}
    # Stand-in for nvcc: "compiles" by writing each object, "links" by
    # copying a loadable shared object, after a pause so that two
    # builders overlap.
    import shutil, sys, time
    args = sys.argv[1:]
    if "--version" in args:
        print("Cuda compilation tools, release 12.4, V12.4.131")
        sys.exit(0)
    out = args[args.index("-o") + 1]
    time.sleep(0.3)
    if "-shared" in args:
        shutil.copy({LOADABLE!r}, out)
    else:
        open(out, "w").write("object")
    """)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` first on PATH."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return nvcc


def test_build_counts_nvcc_runs_and_records_a_span(tmp_path, fake_nvcc):
    """A build runs nvcc once per source into the directory it is given,
    counts one ``nvcc_runs`` and records ``kernels.build`` on the current
    trace; a second call finds the library and runs nothing."""
    before = build.nvcc_runs
    tr = Trace()
    with use_trace(tr):
        lib = build.build(tmp_path / "k")
    assert lib.parent == tmp_path / "k" and lib.exists()
    assert lib.name == f"libtomo_kernels-{build.digest()}.so"
    assert build.nvcc_runs == before + 1
    (span,) = [s for s in tr.spans() if s.name == "kernels.build"]
    assert span.attrs == {"library": lib.name,
                          "sources": len(build.sources())}
    assert build.build(tmp_path / "k") == lib
    assert build.nvcc_runs == before + 1
    assert (tmp_path / "k" / "build.log").exists()


def test_two_processes_build_into_one_directory(tmp_path, fake_nvcc):
    """Two processes build into one empty directory at once: both end
    with the same library path, one library is there (the atomic
    ``os.replace``), no work directory is left, and it loads."""
    code = ("import sys; from repro_torch.kernels import build; "
            "print(build.build(sys.argv[1]))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "k")], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    assert sorted(os.listdir(tmp_path / "k")) == \
        sorted(["build.log", Path(outs[0]).name])
    import ctypes
    ctypes.CDLL(outs[0])


def test_library_given_a_resolver_loads_what_it_returns(monkeypatch):
    """``use_resolver`` replaces the default build: the first launch asks
    the resolver for the path (once) and never builds into
    ``BUILD_DIR``."""
    asked = []
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_RESOLVER", None)
    monkeypatch.setattr(build, "build", lambda *a: pytest.fail("built"))
    build.use_resolver(lambda: asked.append(1) or Path(LOADABLE))
    with pytest.raises(AttributeError, match="tomo_error_string"):
        build.library()          # the stand-in has no kernels to bind
    assert asked == [1]
    build.use_resolver(None)
    assert build._RESOLVER is None
