"""Multi-dataset pipeline service launcher — the paper's headline claim
("simultaneous processing of multiple ... datasets") as a running
service: submit N tomography jobs, process them over shared workers with
one built-step cache, report per-job status and aggregate throughput,
and verify every reconstruction against a serial ``PluginRunner``.

Three modes:

* **demo** (default) — submit ``--jobs`` synthetic scans in-process,
  drain, verify; with ``--workers-remote N`` the same scans go over HTTP
  to a broker and N worker processes pull them::

      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve --jobs 4
      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve --jobs 8 \\
          --workers 1 --batch --n-det 2560 --n-angles 1801 --n-rows 8
      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve --jobs 4 \\
          --workers-remote 2

* **server** — bind the JSON-over-HTTP front end and serve until
  interrupted (``--serve 0`` picks a free port and prints it)::

      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve \\
          --serve 8973 --batch
      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve \\
          --serve 8973 --workers-remote 2      # broker + 2 workers

* **client** — talk to a running server (the port's or the JAX
  package's), including parameter sweeps, which the service runs as one
  gang of variants::

      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve client \\
          --url http://127.0.0.1:8973 submit --demo-chain --wait
      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve client \\
          sweep --demo-chain --param sinogram_filter.cutoff=0.4:1.0:4 \\
          --metric sharpness --wait --out sweep.npy

Jobs run on the card unless ``--device cpu`` is given (spawned workers
take the same ``--device``, ``--transport`` and ``--slots``).
``--transport sharded`` splits every job over the host's cards, or over
``--slots N`` repeats of ``--device`` (``--device cpu --slots 4`` on the
CPU)::

      PYTHONPATH=src python -m repro_torch.launch.pipeline_serve \\
          --device cpu --transport sharded --slots 4 --jobs 2 --batch
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Any

import numpy as np

from ..core import (ChunkedFileTransport, CudaTransport, InMemoryTransport,
                    PluginRunner, ShardedTransport)
from ..core.transport import slots_on, to_numpy
from ..device import resolve_device
from ..kernels.backproject.kernel import backproject_cuda
from ..kernels.correction.kernel import correct_cuda
from ..kernels.sino_filter.kernel import scale_spectrum_cuda
from ..service import (METRICS, CheckpointStore, CompileCache, JobQueue,
                       PipelineClient, PipelineScheduler, PipelineService,
                       ServiceError, to_spec)
from ..service.worker import spawn_local_workers
from ..tomo import standard_chain

_EPILOG = """\
transport notes:
  --transport cuda      datasets stay on the device; every plugin step
                        is built once into the process-level cache and
                        runs the hand-written kernels (the default)
  --transport chunked   every dataset lives in a chunk-addressed file
                        (RAM is O(frames), never O(dataset)); with
                        --checkpoint-dir the checkpointer HARD-LINKS
                        those chunk files and writes only dirty-chunk
                        increments
  --transport inmemory  host storage, one group of frames at a time
  --transport sharded   Savu's MPI mode: every dataset split over the
                        host's cards (or --slots N repeats of --device)
                        along its pattern's first slice dim, each kernel
                        launched once per slot, the pattern transition
                        an all-to-all between the slots

scheduling notes:
  --batch gangs queued jobs with identical chain signatures: each
  plugin step runs as ONE call over all gang members (one launch of
  each kernel for the gang), driven by the single worker that popped
  the gang — so for identical-chain workloads --workers does NOT
  multiply gang throughput.
"""

#: the kernels of the chain, by the name the launch counts are reported
KERNELS = {"correction": correct_cuda, "spectrum_scale": scale_spectrum_cuda,
           "backprojection": backproject_cuda}


def _chain(args, seed: int):
    return standard_chain(n_det=args.n_det, n_angles=args.n_angles,
                          n_rows=args.n_rows, seed=seed,
                          use_pallas=args.pallas, device=args.device)


def _busy_s(jobs) -> float:
    """Seconds in which at least one job was in a plugin step's process
    phase; a gang's shared step, and steps that overlap on several
    workers, count once."""
    spans = sorted((e.start, e.end) for j in jobs
                   for e in j.runner.profiler.events if e.phase == "process")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.pipeline_serve",
        description=__doc__.split("\n\n")[0],
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=4,
                    help="number of synthetic scans to submit")
    ap.add_argument("--workers", type=int, default=2,
                    help="scheduler worker threads (see scheduling notes)")
    ap.add_argument("--transport", default="cuda",
                    choices=("cuda", "sharded", "inmemory", "chunked"),
                    help="execution transport (see transport notes)")
    ap.add_argument("--slots", type=int, default=None,
                    help="--transport sharded: N slots on --device "
                         "(default: every card on the card, 1 on the "
                         "CPU)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--batch", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="gang identical chains into one call per plugin "
                         "step (see scheduling notes)")
    ap.add_argument("--batch-max", type=int, default=4,
                    help="--batch: gang size bound")
    ap.add_argument("--verify", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="compare each job against a serial PluginRunner "
                         "(rtol 1e-3, atol 1e-4)")
    ap.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the hand-written kernels (the JAX package's flag "
                         "name); --no-pallas runs the plain versions")
    ap.add_argument("--n-det", type=int, default=48)
    ap.add_argument("--n-angles", type=int, default=48)
    ap.add_argument("--n-rows", type=int, default=2)
    ap.add_argument("--max-pending", type=int, default=64,
                    help="admission bound: submissions past this many "
                         "non-terminal jobs get QueueFull")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist per-plugin checkpoints here; a killed "
                         "job resubmitted with the same id resumes at "
                         "the last finished plugin")
    ap.add_argument("--max-history", type=int, default=256,
                    help="retained terminal jobs (older results are "
                         "evicted)")
    ap.add_argument("--serve", type=int, metavar="PORT", default=None,
                    help="serve the HTTP front end on PORT (0: a free "
                         "one) instead of running the demo (POST /jobs, "
                         "POST /sweeps, GET /jobs/{id}/result, ...)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --serve")
    ap.add_argument("--token", default=None,
                    help="--serve: require this bearer token on every "
                         "mutating request (Authorization: Bearer ...)")
    ap.add_argument("--trace-spool", default=None, metavar="DIR",
                    help="--serve: spool evicted terminal-job traces to "
                         "this directory (bounded ring)")
    ap.add_argument("--workers-remote", type=int, default=None,
                    metavar="N",
                    help="broker mode: spawn N worker SUBPROCESSES "
                         "pulling jobs over HTTP (demo), or serve the "
                         "broker for external workers (--serve; N may "
                         "be 0)")
    ap.add_argument("--lease-ttl", type=float, default=15.0,
                    help="broker mode: seconds a lease survives "
                         "without a worker heartbeat before the job is "
                         "requeued")
    ap.add_argument("--shared-fs", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="broker mode: workers write results straight "
                         "into the broker's results_dir instead of "
                         "uploading over HTTP")
    ap.add_argument("--cost-analysis",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="--transport cuda or sharded: attach per-step "
                         "flops, bytes accessed and peak memory to the "
                         "process spans (each distinct step runs once "
                         "more, before its first timer)")
    return ap


def _transport_factory(args, cache: CompileCache):
    dev = resolve_device(args.device)
    if args.transport == "cuda":
        return lambda job: CudaTransport(dev, compile_cache=cache,
                                         cost_analysis=args.cost_analysis)
    if args.transport == "sharded":
        slots = slots_on(dev, args.slots)
        return lambda job: ShardedTransport(
            slots, compile_cache=cache, cost_analysis=args.cost_analysis)
    if args.cost_analysis:
        raise SystemExit("--cost-analysis needs --transport cuda or "
                         "sharded")
    if args.transport == "chunked":
        return lambda job: ChunkedFileTransport(device=dev)
    return lambda job: InMemoryTransport(dev)


def _demo_main(args) -> dict[str, Any]:
    cache = CompileCache()
    factory = _transport_factory(args, cache)
    queue = JobQueue(max_pending=args.max_pending,
                     max_history=args.max_history)
    checkpoints = (CheckpointStore(args.checkpoint_dir)
                   if args.checkpoint_dir else None)
    sched = PipelineScheduler(
        queue, transport_factory=factory, n_workers=args.workers,
        checkpoints=checkpoints, batch_identical=args.batch,
        batch_max=args.batch_max, compile_cache=cache)

    jobs = [queue.submit(_chain(args, seed=i), priority=0,
                         job_id=f"tomo-{i:03d}", metadata={"seed": i})
            for i in range(args.jobs)]
    before = {k: w.launches for k, w in KERNELS.items()}
    t0 = time.time()
    sched.start()
    try:
        ok = sched.drain(timeout=600)
    finally:
        sched.shutdown()
    wall = time.time() - t0
    launches = {k: w.launches - before[k] for k, w in KERNELS.items()}
    if not ok:
        raise SystemExit("timed out waiting for jobs")

    failed = [j for j in jobs if j.state.value != "done"]
    for j in jobs:
        extra = (f" (resumed at plugin {j.resumed_from})"
                 if j.resumed_from else "")
        print(f"  {j.job_id}: {j.status:>10s}  wall={j.wall:.2f}s{extra}")
    if failed:
        for j in failed:
            print(j.metadata.get("traceback", j.error))
        raise SystemExit(f"{len(failed)}/{len(jobs)} jobs failed")

    worst = None
    if args.verify:
        worst = 0.0
        for j in jobs:
            ref = PluginRunner(_chain(args, seed=j.metadata["seed"]),
                               CudaTransport(args.device))
            want = ref.transport.read(ref.run()["recon"])
            got = j.runner.transport.read(j.runner.datasets["recon"])
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
            worst = max(worst, float(np.max(np.abs(got - want))))
        print(f"verified {len(jobs)} reconstructions against serial "
              f"PluginRunner (max |Δ|={worst:.2e})")

    st = sched.stats()
    busy = _busy_s(jobs)
    print(f"{len(jobs)} jobs in {wall:.2f}s -> {len(jobs) / wall:.2f} "
          f"jobs/s with the scans' loading  ({args.workers} workers, "
          f"transport={args.transport}"
          f"{', gang-batched' if args.batch else ''})")
    print(f"plugin steps busy {busy:.4f}s -> {len(jobs) / busy:.2f} jobs/s "
          f"processing")
    print(f"compile cache: {cache.stats()}")
    if st.get("gangs_run"):
        print(f"gangs executed: {st['gangs_run']}")
    summary = {"jobs": len(jobs),
               # from start to drain, the loaders' scan simulation included
               "wall_s": wall, "jobs_per_s": len(jobs) / wall,
               # the time some job was in a plugin step: the service's
               # processing, without the loaders
               "process_s": busy, "process_jobs_per_s": len(jobs) / busy,
               "job_wall_s": [j.wall for j in jobs],
               "resumed_from": [j.resumed_from for j in jobs],
               "max_abs_err_vs_serial": worst,
               # a gang's members share each step's wall
               "step_s": jobs[0].runner.profiler.totals("process"),
               "gangs_run": st.get("gangs_run", 0),
               "gang_fallbacks": st.get("gang_fallbacks", 0),
               "compile_cache": cache.stats(),
               "kernel_launches": launches}
    print(json.dumps({"pipeline_serve": summary}))
    return summary


def _spawn(args, url: str, n: int) -> list:
    """``n`` worker processes for the broker at ``url``, on the demo's
    device and transport (gangs of up to ``--batch-max`` with
    ``--batch``)."""
    return spawn_local_workers(
        url, n, transport=args.transport, device=args.device,
        slots=args.slots,
        checkpoint_dir=args.checkpoint_dir, shared_fs=args.shared_fs,
        token=args.token,
        max_batch=args.batch_max if args.batch else 1,
        cost_analysis=args.cost_analysis)


def _stop(workers: list) -> None:
    """Terminate spawned workers; kill any that outlive 10 s."""
    for p in workers:
        if p.poll() is None:
            p.terminate()
    for p in workers:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _serve_main(args) -> None:
    """Serve the HTTP front end until interrupted: the local scheduler,
    or with ``--workers-remote N`` a broker and N spawned workers."""
    workers: list = []
    if args.workers_remote is not None:
        service = PipelineService(
            device=args.device, workers_remote=True,
            max_pending=args.max_pending, max_history=args.max_history,
            lease_ttl=args.lease_ttl, token=args.token,
            trace_spool=args.trace_spool)
        host, port = service.serve(host=args.host, port=args.serve)
        workers = _spawn(args, f"http://{host}:{port}", args.workers_remote)
        print(f"pipeline broker listening on http://{host}:{port}  "
              f"({len(workers)} local worker processes, transport="
              f"{args.transport}, device={service.device}, lease_ttl="
              f"{args.lease_ttl}s; attach more with `python -m "
              f"repro_torch.service.worker --url http://{host}:{port}`)",
              flush=True)
    else:
        cache = CompileCache()
        checkpoints = (CheckpointStore(args.checkpoint_dir)
                       if args.checkpoint_dir else None)
        service = PipelineService(
            device=args.device,
            transport_factory=_transport_factory(args, cache),
            n_workers=args.workers, max_pending=args.max_pending,
            max_history=args.max_history, checkpoints=checkpoints,
            batch_identical=args.batch, batch_max=args.batch_max,
            compile_cache=cache, token=args.token,
            trace_spool=args.trace_spool)
        host, port = service.serve(host=args.host, port=args.serve)
        print(f"pipeline service listening on http://{host}:{port}  "
              f"({args.workers} workers, transport={args.transport}, "
              f"device={service.device}"
              f"{', gang-batched' if args.batch else ''}"
              f"{', checkpointed' if checkpoints else ''}"
              f"{', cost analysis' if args.cost_analysis else ''})",
              flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        _stop(workers)
        service.stop()


def _remote_demo(args) -> dict[str, Any]:
    """The multi-host demo: one queue, N worker processes.  Submit
    ``--jobs`` scans over HTTP, let the worker subprocesses pull them,
    verify every reconstruction against a serial ``PluginRunner``."""
    if args.workers_remote < 1:
        raise SystemExit("the demo needs --workers-remote >= 1")
    service = PipelineService(
        device=args.device, workers_remote=True,
        max_pending=max(args.max_pending, args.jobs),
        lease_ttl=args.lease_ttl)
    host, port = service.serve(port=0)
    url = f"http://{host}:{port}"
    workers = _spawn(args, url, args.workers_remote)
    client = PipelineClient(url)
    try:
        t0 = time.time()
        ids = [client.submit(_chain(args, seed=i), job_id=f"tomo-{i:03d}",
                             metadata={"seed": i})
               for i in range(args.jobs)]
        snaps = [client.wait(jid, timeout=600) for jid in ids]
        wall = time.time() - t0
        for sn in snaps:
            extra = (f" (resumed at plugin {sn['resumed_from']})"
                     if sn["resumed_from"] else "")
            print(f"  {sn['job_id']}: {sn['status']:>10s}  "
                  f"worker={sn['worker_id']}  wall={sn['wall']:.2f}s"
                  f"{extra}")
        failed = [sn for sn in snaps if sn["state"] != "done"]
        if failed:
            for sn in failed:
                print(sn["error"])
            raise SystemExit(f"{len(failed)}/{len(snaps)} jobs failed")
        worst = None
        if args.verify:
            worst = 0.0
            for sn in snaps:
                got = client.result(sn["job_id"])
                ref = PluginRunner(_chain(args, seed=sn["metadata"]["seed"]),
                                   CudaTransport(args.device))
                want = ref.transport.read(ref.run()["recon"])
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
                worst = max(worst, float(np.max(np.abs(got - want))))
            print(f"verified {len(snaps)} reconstructions against serial "
                  f"PluginRunner (max |Δ|={worst:.2e})")
        st = client.stats()
        per_worker = {w: ws["jobs_done"] for w, ws in st["workers"].items()}
        print(f"{args.jobs} jobs in {wall:.2f}s -> {args.jobs / wall:.2f} "
              f"jobs/s  ({args.workers_remote} worker processes, "
              f"transport={args.transport})")
        print(f"per-worker jobs done: {per_worker}  "
              f"requeues: {st['jobs_requeued']}")
        summary = {"jobs": args.jobs, "wall_s": wall,
                   "jobs_per_s": args.jobs / wall,
                   "workers": args.workers_remote,
                   "per_worker_done": per_worker,
                   "jobs_requeued": st["jobs_requeued"],
                   "leases_expired": st["leases_expired"],
                   "max_abs_err_vs_serial": worst}
        print(json.dumps({"pipeline_serve_remote": summary}))
        return summary
    finally:
        _stop(workers)
        service.stop()


# ----------------------------------------------------------------------
def _client_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.pipeline_serve client",
        description="Talk to a running pipeline service over HTTP.")
    ap.add_argument("--url", default="http://127.0.0.1:8973",
                    help="service base URL")
    ap.add_argument("--token", default=None,
                    help="bearer token for a token-armed service")
    sub = ap.add_subparsers(dest="action", required=True)

    def chain_args(p):
        p.add_argument("--n-det", type=int, default=48)
        p.add_argument("--n-angles", type=int, default=48)
        p.add_argument("--n-rows", type=int, default=2)
        p.add_argument("--seed", type=int, default=0)

    s = sub.add_parser("submit", help="POST a process list")
    s.add_argument("--spec", metavar="FILE", default=None,
                   help="spec v1 JSON file (see docs/plugin-spec.md)")
    s.add_argument("--demo-chain", action="store_true",
                   help="submit the standard synthetic chain instead of "
                        "a spec file")
    s.add_argument("--streaming", action="store_true",
                   help="submit as a v2 STREAMING job: the loader's "
                        "frames arrive over `client ingest`, not from "
                        "the spec (docs/streaming.md)")
    chain_args(s)
    s.add_argument("--priority", type=int, default=0)
    s.add_argument("--job-id", default=None)
    s.add_argument("--wait", action="store_true",
                   help="poll until the job is terminal")

    ing = sub.add_parser(
        "ingest", help="stream frames into a streaming job "
                       "(docs/streaming.md)",
        description="POST frame slabs to a v2 streaming job in arrival "
                    "order, optionally rate-limited, then mark EOF.")
    ing.add_argument("job_id")
    ing.add_argument("--npy", metavar="FILE", default=None,
                     help=".npy frame stack (axis 0 = arrival axis)")
    ing.add_argument("--synthetic", action="store_true",
                     help="generate the standard synthetic scan's raw "
                          "frames (must match the submitted chain's "
                          "--n-det/--n-angles/--n-rows/--seed)")
    chain_args(ing)
    ing.add_argument("--device", default="cuda",
                     help="where --synthetic simulates the scan (the "
                          "card unless 'cpu' is asked for)")
    ing.add_argument("--chunk", type=int, default=8,
                     help="frames per POST")
    ing.add_argument("--rate", type=float, default=0.0, metavar="HZ",
                     help="chunk posts per second (0 = full speed)")
    ing.add_argument("--start", type=int, default=0,
                     help="index of the first frame being sent (resume "
                          "an interrupted feed from the watermark)")
    ing.add_argument("--eof", action=argparse.BooleanOptionalAction,
                     default=True,
                     help="post EOF after the last chunk (--no-eof to "
                          "keep the stream open)")

    pv = sub.add_parser(
        "preview", help="download the current partial reconstruction")
    pv.add_argument("job_id")
    pv.add_argument("--out", metavar="FILE", default=None,
                    help="write the npy here (default: "
                         "<job_id>-preview.npy)")

    sw = sub.add_parser(
        "sweep", help="POST a parameter sweep (docs/sweeps.md)",
        description="Expand a process list over a ≤2-param grid of "
                    "sweepable values; the service gang-batches the "
                    "variants and serves the stacked result.")
    sw.add_argument("--spec", metavar="FILE", default=None,
                    help="spec v1 JSON file (see docs/plugin-spec.md)")
    sw.add_argument("--demo-chain", action="store_true",
                    help="sweep the standard synthetic chain")
    chain_args(sw)
    sw.add_argument("--param", action="append", required=True,
                    metavar="PLUGIN.PARAM=SPEC", dest="params",
                    help="one sweep axis (repeatable, ≤2): SPEC is "
                         "START:STOP:N (inclusive linspace, e.g. "
                         "sinogram_filter.cutoff=0.4:1.0:4) or a "
                         "comma list of JSON values (e.g. "
                         "ring_removal.strength=0.5,1.0,1.5); PLUGIN "
                         "is a wire name or an entry index")
    sw.add_argument("--metric", default=None, choices=sorted(METRICS),
                    help="score each variant and report best_variant")
    sw.add_argument("--priority", type=int, default=0)
    sw.add_argument("--sweep-id", default=None)
    sw.add_argument("--wait", action="store_true",
                    help="poll until every variant is terminal")
    sw.add_argument("--out", metavar="FILE", default=None,
                    help="download the stacked npy here when done "
                         "(implies --wait)")

    wf = sub.add_parser(
        "workflow", help="POST a workflow DAG (docs/workflows.md)",
        description="Submit a DAG of process lists as ONE spec-v3 "
                    "envelope: nodes depend on nodes (`after` + "
                    "upstream-output references), admitted atomically "
                    "— a cycle or dangling reference rejects the whole "
                    "request with nothing enqueued.")
    wf.add_argument("--envelope", metavar="FILE", default=None,
                    help="JSON file: a full v3 envelope or a bare "
                         "{node: {process_list, after}} mapping")
    wf.add_argument("--demo", action="store_true",
                    help="submit the 3-stage demo DAG instead: "
                         "recon -> downsample -> quantify")
    chain_args(wf)
    wf.add_argument("--priority", type=int, default=0)
    wf.add_argument("--workflow-id", default=None)
    wf.add_argument("--wait", action="store_true",
                    help="poll until every node is terminal")
    for name, help_ in (("workflow-status",
                         "GET one workflow's per-node snapshot"),
                        ("workflow-trace",
                         "GET the workflow-level linked trace"),
                        ("workflow-cancel",
                         "DELETE a workflow (cancel live nodes; "
                         "downstream cones cascade)")):
        sub.add_parser(name, help=help_).add_argument("workflow_id")
    sub.add_parser("workflows", help="GET every workflow's summary")

    sub.add_parser("sweep-status",
                   help="GET one sweep's snapshot").add_argument("sweep_id")
    swr = sub.add_parser("sweep-result",
                         help="download the stacked result (.npy)")
    swr.add_argument("sweep_id")
    swr.add_argument("--dataset", default=None)
    swr.add_argument("--out", metavar="FILE", default=None,
                     help="write the npy here (default: <sweep_id>.npy)")
    sub.add_parser("sweep-cancel", help="DELETE a sweep (cancel live "
                   "variants)").add_argument("sweep_id")
    sub.add_parser("sweeps", help="GET every sweep group's summary")

    sub.add_parser("status", help="GET one job's snapshot").add_argument(
        "job_id")
    w = sub.add_parser("wait", help="poll a job to completion")
    w.add_argument("job_id")
    w.add_argument("--timeout", type=float, default=600.0)
    r = sub.add_parser("result", help="download an output dataset (.npy)")
    r.add_argument("job_id")
    r.add_argument("--dataset", default=None)
    r.add_argument("--out", metavar="FILE", default=None,
                   help="write the npy here (default: <job_id>.npy)")
    sub.add_parser("cancel", help="DELETE a queued job").add_argument(
        "job_id")
    tr = sub.add_parser(
        "trace", help="GET a job's span timeline",
        description="Print the job's trace — by default as an ASCII "
                    "gantt over every span the scheduler recorded.")
    tr.add_argument("job_id")
    tr.add_argument("--json", action="store_true",
                    help="print the raw span list instead of the gantt")
    tr.add_argument("--otlp", action="store_true",
                    help="print the OTLP-shaped JSON export instead "
                         "(?format=otlp)")
    slo = sub.add_parser(
        "slo", help="GET the SLO rule states (/slo)",
        description="Every SLO rule's definition, current reading and "
                    "alert lifecycle state.")
    slo.add_argument("--format", choices=("json", "text"),
                     default="json")
    ev = sub.add_parser(
        "events", help="GET the structured event log (/events)",
        description="Page — or --follow tail — the bounded structured "
                    "event log: one record per job state transition "
                    "and alert edge, each carrying trace_id / job_id "
                    "/ worker_id.")
    ev.add_argument("--since", type=int, default=0,
                    help="resume cursor: only records with seq > N")
    ev.add_argument("--limit", type=int, default=None,
                    help="page size bound")
    ev.add_argument("--follow", action="store_true",
                    help="poll forever, printing records as they land "
                         "(one line each)")
    ev.add_argument("--interval", type=float, default=1.0,
                    help="--follow poll period in seconds")
    ev.add_argument("--format", choices=("json", "text"),
                    default="json")
    cl = sub.add_parser(
        "cluster", help="GET the per-worker scoreboard (/cluster)",
        description="Broker mode: every registered worker's card, "
                    "transport, heartbeat staleness, active leases with "
                    "time-to-expiry, last error and warm-pool prefetch "
                    "count.")
    cl.add_argument("--format", choices=("json", "text"),
                    default="json")
    sub.add_parser("jobs", help="GET every job's snapshot")
    sub.add_parser("stats", help="GET scheduler + compile-cache stats")
    sub.add_parser("metrics",
                   help="GET the Prometheus text exposition (/metrics)")
    sub.add_parser("plugins", help="GET the wire-format plugin registry")
    return ap


def _demo_spec(args) -> dict:
    """The standard synthetic chain's spec (no device: the service
    decides where it runs)."""
    return to_spec(standard_chain(n_det=args.n_det, n_angles=args.n_angles,
                                  n_rows=args.n_rows, seed=args.seed))


def _spec(args, what: str) -> dict:
    if args.spec:
        with open(args.spec) as fh:
            return json.load(fh)
    if args.demo_chain:
        return _demo_spec(args)
    raise SystemExit(f"{what} needs --spec FILE or --demo-chain")


def _parse_sweep_axis(s: str) -> dict:
    """``PLUGIN.PARAM=START:STOP:N`` (inclusive linspace) or
    ``PLUGIN.PARAM=v1,v2,...`` (JSON values) -> one sweep-axis object."""
    target, eq, spec = s.partition("=")
    plugin, dot, param = target.rpartition(".")
    if not (eq and dot and plugin and param and spec):
        raise SystemExit(f"--param wants PLUGIN.PARAM=SPEC, got {s!r}")
    if ":" in spec and "," not in spec:
        parts = spec.split(":")
        try:
            start, stop, n = (float(parts[0]), float(parts[1]),
                              int(parts[2]))
        except (IndexError, ValueError):
            # a typo like 0.4:1.0 must die here, not as N failed jobs
            raise SystemExit(f"--param range must be START:STOP:N, "
                             f"got {spec!r}") from None
        if len(parts) != 3:
            raise SystemExit(f"--param range must be START:STOP:N, "
                             f"got {spec!r}")
        values = [float(v) for v in np.linspace(start, stop, n)]
    else:
        values = []
        for v in spec.split(","):
            try:
                values.append(json.loads(v))
            except json.JSONDecodeError:
                values.append(v)           # bare string value
    axis: dict = {"param": param, "values": values}
    if plugin.isdigit():
        axis["plugin_index"] = int(plugin)
    else:
        axis["plugin"] = plugin
    return axis


def _demo_workflow(args) -> dict:
    """The 3-stage demo DAG — recon -> downsample -> quantify, the
    downstream nodes fed by upstream outputs (docs/workflows.md)."""
    from ..core.process_list import ProcessList
    from ..tomo import Downsample, HDF5LikeSaver, Quantify, UpstreamLoader
    down = ProcessList()
    down.add(UpstreamLoader,
             params={"data": {"from_job": "recon", "dataset": "recon"}},
             out_datasets=("vol",))
    down.add(Downsample, params={"factor": 2},
             in_datasets=("vol",), out_datasets=("small",))
    down.add(HDF5LikeSaver, in_datasets=("small",))
    quant = ProcessList()
    quant.add(UpstreamLoader,
              params={"data": {"from_job": "downsample",
                               "dataset": "small"}},
              out_datasets=("vol",))
    quant.add(Quantify, in_datasets=("vol",), out_datasets=("stats",))
    quant.add(HDF5LikeSaver, in_datasets=("stats",))
    return {
        "recon": {"process_list": _demo_spec(args)},
        "downsample": {"process_list": to_spec(down)},
        # the upstream reference already implies this edge; the
        # explicit `after` just demonstrates the envelope field
        "quantify": {"process_list": to_spec(quant),
                     "after": ["downsample"]},
    }


def _workflow_main(client: PipelineClient, args) -> None:
    if args.envelope:
        with open(args.envelope) as fh:
            doc = json.load(fh)
        # accept a full v3 envelope or a bare node mapping
        nodes = doc.get("workflow", doc) if isinstance(doc, dict) else doc
    elif args.demo:
        nodes = _demo_workflow(args)
    else:
        raise SystemExit("workflow needs --envelope FILE or --demo")
    reply = client.workflow(nodes, workflow_id=args.workflow_id,
                            priority=args.priority)
    print(json.dumps(reply, indent=2))
    if args.wait:
        print(json.dumps(client.wait_workflow(reply["workflow_id"]),
                         indent=2))


def _ingest_main(client: PipelineClient, args) -> None:
    """Feed a frame stack into a streaming job chunk by chunk."""
    if args.npy:
        frames = np.load(args.npy)
    elif args.synthetic:
        # exactly what the submitted chain's loader declares
        pl = standard_chain(n_det=args.n_det, n_angles=args.n_angles,
                            n_rows=args.n_rows, seed=args.seed,
                            device=resolve_device(args.device))
        entry = pl.entries[0]
        loader = entry.cls(**entry.params,
                           in_datasets=list(entry.in_datasets),
                           out_datasets=list(entry.out_datasets))
        frames = loader.load()[0].materialise()
    else:
        raise SystemExit("ingest needs --npy FILE or --synthetic")
    start = args.start
    for lo in range(0, frames.shape[0], args.chunk):
        # one chunk at a time to the host (a simulated scan is on the card)
        reply = client.ingest(args.job_id,
                              to_numpy(frames[lo:lo + args.chunk]), start)
        start = reply["watermark"]
        print(f"  fed frames [{reply['start']}, "
              f"{reply['start'] + reply['count']}) -> watermark "
              f"{start}", flush=True)
        if args.rate > 0:
            time.sleep(1.0 / args.rate)
    if args.eof:
        print(json.dumps(client.eof(args.job_id), indent=2))


def _table(rows: list[tuple]) -> str:
    """Plain-text column alignment for the --format text views."""
    widths = [max(len(str(r[i])) for r in rows)
              for i in range(len(rows[0]))]
    return "\n".join(
        "  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
        for r in rows)


def _slo_text(snap: dict) -> str:
    rows = [("RULE", "STATE", "VALUE", "THRESHOLD", "FIRED",
             "RESOLVED", "METRIC")]
    for r in snap["rules"]:
        value = "-" if r["value"] is None else f"{r['value']:.3f}"
        rows.append((("*" if r["critical"] else " ") + r["name"],
                     r["state"], value,
                     f"{r['op']} {r['threshold']:g}",
                     r["fired"], r["resolved"], r["metric"]))
    firing = ", ".join(snap["firing"]) or "none"
    return (_table(rows)
            + f"\nfiring: {firing}   (* = critical rule)")


def _event_line(rec: dict) -> str:
    attrs = " ".join(f"{k}={v}"
                     for k, v in sorted(rec["attrs"].items()))
    return (f"{rec['seq']:>6d}  {rec['ts']:.3f}  {rec['event']:<14s} "
            f"trace={rec['trace_id'] or '-'} "
            f"job={rec['job_id'] or '-'} "
            f"worker={rec['worker_id'] or '-'}"
            + (f"  {attrs}" if attrs else ""))


def _cluster_text(doc: dict) -> str:
    rows = [("WORKER", "DEVICE", "TRANSPORT", "LEASES", "STALE_S", "DONE",
             "FAILED", "PREFETCHED", "LAST_ERROR")]
    for w in doc["workers"]:
        leases = ",".join(ls["job_id"] for ls in w["leases"]) or "-"
        err = w.get("last_error") or "-"
        if len(err) > 40:
            err = err[:37] + "..."
        rows.append((w["worker_id"], w.get("device") or "-",
                     w.get("transport") or "-", leases,
                     f"{w['heartbeat_staleness_s']:.1f}",
                     w["jobs_done"], w["jobs_failed"],
                     w["prefetched"], err))
    return (_table(rows)
            + f"\nactive_leases={doc['active_leases']}  "
              f"leases_expired={doc['leases_expired']}  "
              f"jobs_requeued={doc['jobs_requeued']}  "
              f"lease_ttl={doc['lease_ttl']}")


def _events_main(client: PipelineClient, args) -> None:
    """One page of the event log, or --follow: tail it forever."""
    if not args.follow:
        page = client.events(since=args.since, limit=args.limit)
        if args.format == "text":
            for rec in page["events"]:
                print(_event_line(rec))
            tail = f"# cursor {page['cursor']}"
            if page["dropped"]:
                tail += f"  ({page['dropped']} dropped before cursor)"
            print(tail)
        else:
            print(json.dumps(page, indent=2))
        return
    cursor = args.since
    try:
        while True:
            page = client.events(since=cursor, limit=args.limit)
            for rec in page["events"]:
                print(_event_line(rec) if args.format == "text"
                      else json.dumps(rec), flush=True)
            cursor = page["cursor"]
            if not page["events"]:
                time.sleep(max(args.interval, 0.05))
    except KeyboardInterrupt:
        pass


def _save(arr: np.ndarray, out: str) -> None:
    np.save(out, arr)
    print(f"{out}: shape={arr.shape} dtype={arr.dtype}")


def _client_main(argv: list[str]) -> None:
    args = _client_parser().parse_args(argv)
    client = PipelineClient(args.url, token=args.token)
    show = lambda doc: print(json.dumps(doc, indent=2))  # noqa: E731
    try:
        if args.action == "sweep":
            reply = client.sweep(
                _spec(args, "sweep"),
                [_parse_sweep_axis(p) for p in args.params],
                metric=args.metric, priority=args.priority,
                sweep_id=args.sweep_id)
            show(reply)
            if args.wait or args.out:
                snap = client.wait_sweep(reply["sweep_id"])
                show(snap)
                if args.out and snap["state"] == "done":
                    _save(client.sweep_result(reply["sweep_id"]), args.out)
        elif args.action == "sweep-status":
            show(client.sweep_status(args.sweep_id))
        elif args.action == "sweep-result":
            _save(client.sweep_result(args.sweep_id, dataset=args.dataset),
                  args.out or f"{args.sweep_id}.npy")
        elif args.action == "sweep-cancel":
            show(client.cancel_sweep(args.sweep_id))
        elif args.action == "sweeps":
            show(client.sweeps())
        elif args.action == "workflow":
            _workflow_main(client, args)
        elif args.action == "workflow-status":
            show(client.workflow_status(args.workflow_id))
        elif args.action == "workflow-trace":
            show(client.workflow_trace(args.workflow_id))
        elif args.action == "workflow-cancel":
            show(client.cancel_workflow(args.workflow_id))
        elif args.action == "workflows":
            show(client.workflows())
        elif args.action == "submit":
            spec = _spec(args, "submit")
            if args.streaming:
                spec = {**spec, "version": 2, "streaming": True}
            job_id = client.submit(spec, priority=args.priority,
                                   job_id=args.job_id)
            print(job_id)
            if args.wait:
                show(client.wait(job_id))
        elif args.action == "ingest":
            _ingest_main(client, args)
        elif args.action == "preview":
            arr, cut = client.preview(args.job_id)
            out = args.out or f"{args.job_id}-preview.npy"
            np.save(out, arr)
            print(f"{out}: shape={arr.shape} dtype={arr.dtype} "
                  f"(first {cut} frames folded in)")
        elif args.action == "status":
            show(client.status(args.job_id))
        elif args.action == "wait":
            show(client.wait(args.job_id, timeout=args.timeout))
        elif args.action == "result":
            _save(client.result(args.job_id, dataset=args.dataset),
                  args.out or f"{args.job_id}.npy")
        elif args.action == "cancel":
            show(client.cancel(args.job_id))
        elif args.action == "trace":
            if args.otlp:
                show(client.trace(args.job_id, otlp=True))
            elif args.json:
                show(client.trace(args.job_id))
            else:
                print(client.trace(args.job_id, text=True), end="")
        elif args.action == "slo":
            snap = client.slo()
            print(_slo_text(snap) if args.format == "text"
                  else json.dumps(snap, indent=2))
        elif args.action == "events":
            _events_main(client, args)
        elif args.action == "cluster":
            doc = client.cluster()
            print(_cluster_text(doc) if args.format == "text"
                  else json.dumps(doc, indent=2))
        elif args.action == "jobs":
            show(client.jobs())
        elif args.action == "stats":
            show(client.stats())
        elif args.action == "metrics":
            print(client.metrics(), end="")
        elif args.action == "plugins":
            show(client.plugins())
    except ServiceError as e:
        raise SystemExit(f"error: {e}")


def main(argv: list[str] | None = None) -> dict[str, Any] | None:
    """Run the demo, the server or the client.  The demo returns its
    summary (also printed as one JSON line): jobs/s end to end and over
    the plugin steps alone, per-job wall, the first job's seconds per
    step, the largest difference from the serial runs, gangs run and
    fallen back to solo, the compile cache's counters, and each kernel's
    launches while the scheduler ran; with ``--workers-remote`` jobs/s
    over the worker processes, jobs done per worker, requeues and the
    largest difference from the serial runs."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["client"]:
        return _client_main(argv[1:])
    args = _build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.serve is not None:
        return _serve_main(args)
    if args.workers_remote is not None:
        return _remote_demo(args)
    return _demo_main(args)


if __name__ == "__main__":
    main()
