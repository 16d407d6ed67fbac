"""The system under test: the PyTorch and CUDA port, ``src/repro_torch``
of the checkout, and nothing else of the repository.  The benchmark
takes from it the runner, the transports, the service's queue and
scheduler, the plugins by their wire names, and their spans and
counters."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

#: top-level modules that a run may not load (compared whole: the
#: port's name begins with the reference package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(root: Path) -> SimpleNamespace:
    """Import the port from ``<root>/src``; raises when the checkout
    does not hold it."""
    src = Path(root) / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise FileNotFoundError(
            f"the program (src/repro_torch) is not in {root}: the "
            f"benchmark measures it and has nothing to run without it")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from repro_torch.core.framework import PluginRunner
    from repro_torch.core.process_list import ProcessList
    from repro_torch.core.transport import (CudaTransport, ShardedTransport,
                                            slots_on)
    from repro_torch.service import CompileCache, JobQueue, JobState
    from repro_torch.service.scheduler import PipelineScheduler
    from repro_torch.service.sweep import SweepAxis, expand_sweep
    from repro_torch.service.wire import registered_plugins
    return SimpleNamespace(
        PluginRunner=PluginRunner, ProcessList=ProcessList,
        CudaTransport=CudaTransport, ShardedTransport=ShardedTransport,
        slots_on=slots_on, CompileCache=CompileCache, JobQueue=JobQueue,
        JobState=JobState, PipelineScheduler=PipelineScheduler,
        SweepAxis=SweepAxis, expand_sweep=expand_sweep,
        plugins=registered_plugins())


def forbidden_modules() -> list[str]:
    """The forbidden top-level modules this process holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def chain(prog: SimpleNamespace, config: dict, scan: dict,
          overrides: dict | None = None):
    """The configuration's process list over ``scan`` (host arrays the
    loader takes as they are).  ``overrides``: {plugin wire name:
    {param: value}}."""
    pl = prog.ProcessList()
    loader = config["loader"]
    pl.add(prog.plugins[loader["plugin"]],
           params={**loader.get("params", {}), "scan": scan},
           out_datasets=tuple(loader["out"]))
    for e in config["process_list"]:
        params = {**e.get("params", {}),
                  **(overrides or {}).get(e["plugin"], {})}
        pl.add(prog.plugins[e["plugin"]], params=params,
               in_datasets=tuple(e.get("in", ())),
               out_datasets=tuple(e.get("out", ())))
    return pl
