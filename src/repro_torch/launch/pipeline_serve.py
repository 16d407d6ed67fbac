"""Multi-dataset pipeline service driver, demo mode — the paper's headline
claim ("simultaneous processing of multiple ... datasets") as a running
service: submit N tomography jobs, process them over shared workers with
one built-step cache, report per-job status and aggregate throughput,
and verify every reconstruction against a serial ``PluginRunner``.

    PYTHONPATH=src python -m repro_torch.launch.pipeline_serve --jobs 4
    PYTHONPATH=src python -m repro_torch.launch.pipeline_serve --jobs 8 \\
        --workers 1 --batch --n-det 2560 --n-angles 1801 --n-rows 8
    PYTHONPATH=src python -m repro_torch.launch.pipeline_serve --jobs 2 \\
        --device cpu

Jobs run on the card unless ``--device cpu`` is given.  The HTTP front
end (``--serve``), broker-mode workers (``--workers-remote``), per-step
cost profiles (``--cost-analysis``) and the ``client`` subcommand of the
JAX package's driver are not ported yet: each exits non-zero naming the
ROADMAP.md item that brings it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any

import numpy as np

from ..core import (ChunkedFileTransport, CudaTransport, InMemoryTransport,
                    PluginRunner)
from ..device import resolve_device
from ..kernels.backproject.kernel import backproject_cuda
from ..kernels.correction.kernel import correct_cuda
from ..kernels.sino_filter.kernel import scale_spectrum_cuda
from ..service import (CheckpointStore, CompileCache, JobQueue,
                       PipelineScheduler)
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

scheduling notes:
  --batch gangs queued jobs with identical chain signatures: each
  plugin step runs as ONE call over all gang members (one launch of
  each kernel for the gang), driven by the single worker that popped
  the gang — so for identical-chain workloads --workers does NOT
  multiply gang throughput.
"""

#: what is not ported yet, and the ROADMAP.md item that brings it
_LATER = {
    "serve": 'the HTTP front end (--serve) is not ported yet: ROADMAP.md '
             '"Next" D1',
    "workers_remote": 'broker-mode workers (--workers-remote) are not '
                      'ported yet: ROADMAP.md "Next" D1',
    "cost_analysis": 'per-step cost profiles (--cost-analysis, '
                     'plugin_cost) are not ported yet: ROADMAP.md "Next" D4',
    "client": 'the client subcommand talks to the HTTP front end, which '
              'is not ported yet: ROADMAP.md "Next" D1',
}

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
                    choices=("cuda", "inmemory", "chunked"),
                    help="execution transport (see transport notes)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--batch", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="gang identical chains into one call per plugin "
                         "step (see scheduling notes)")
    ap.add_argument("--batch-max", type=int, default=4,
                    help="--batch: gang size bound")
    ap.add_argument("--fuse", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="run consecutive linear plugins as one step")
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
                    help="not ported yet (" + _LATER["serve"] + ")")
    ap.add_argument("--workers-remote", type=int, default=None,
                    metavar="N",
                    help="not ported yet (" + _LATER["workers_remote"]
                         + ")")
    ap.add_argument("--cost-analysis",
                    action=argparse.BooleanOptionalAction, default=False,
                    help="not ported yet (" + _LATER["cost_analysis"] + ")")
    return ap


def _transport_factory(args, cache: CompileCache):
    dev = resolve_device(args.device)
    if args.transport == "cuda":
        return lambda job: CudaTransport(dev, compile_cache=cache)
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
        batch_max=args.batch_max, fuse=args.fuse,
        compile_cache=cache)

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


def main(argv: list[str] | None = None) -> dict[str, Any]:
    """Run the demo; returns its summary (also printed as one JSON
    line): jobs/s end to end and over the plugin steps alone, per-job
    wall, the first job's seconds per step, the largest difference from
    the serial runs, gangs run and fallen back to solo, the compile
    cache's counters, and each kernel's launches while the scheduler
    ran."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["client"]:
        raise SystemExit(_LATER["client"])
    args = _build_parser().parse_args(argv)
    for flag in ("serve", "workers_remote"):
        if getattr(args, flag) is not None:
            raise SystemExit(_LATER[flag])
    if args.cost_analysis:
        raise SystemExit(_LATER["cost_analysis"])
    resolve_device(args.device)
    return _demo_main(args)


if __name__ == "__main__":
    main()
