# The service layer: a multi-tenant scheduler that runs many process
# lists concurrently over shared workers (solo, gang and streaming jobs),
# with a process-level built-step cache whose persistent tier holds the
# kernel library, checkpoint/resume, a JSON-over-HTTP front end
# (server/client/wire) for remote submission, worker-pull multi-host
# scheduling (broker/worker: one queue, many worker processes),
# parameter sweeps (sweep: Savu-style tuning expanded into gang-batched
# variant jobs) and workflow DAGs (workflow).
from .compile_cache import CompileCache, ExecutableStore, StaleExecutable
from .checkpoint import CheckpointError, CheckpointStore
from .client import PipelineClient, ServiceError
from .job import Job, JobState, StreamState, chain_signature
from .queue import JobQueue, QueueFull
from .scheduler import (LeaseLost, PipelineScheduler, UpstreamGone,
                        WorkerAuthError, WorkerBroker, WorkerInfo)
from .server import PipelineService
from .sweep import (METRICS, SweepAxis, SweepError, SweepGroup,
                    SweepManager, expand_sweep, parse_sweep_block)
from .wire import (WireError, chain_plugin_names, from_spec,
                   register_plugin, registered_plugins, registry_spec,
                   to_spec)
from .worker import PipelineWorker
from .workflow import (WorkflowError, WorkflowGroup, WorkflowManager,
                       toposort)

__all__ = [
    "CompileCache", "CheckpointError", "CheckpointStore", "Job",
    "JobState", "StreamState", "chain_signature", "JobQueue", "QueueFull",
    "PipelineScheduler", "UpstreamGone", "PipelineService",
    "PipelineWorker", "WorkerBroker", "WorkerInfo", "LeaseLost",
    "WorkerAuthError", "ExecutableStore", "StaleExecutable",
    "PipelineClient", "ServiceError", "WireError", "chain_plugin_names",
    "from_spec", "register_plugin", "registered_plugins", "registry_spec",
    "to_spec", "METRICS", "SweepAxis", "SweepError", "SweepGroup",
    "SweepManager", "expand_sweep", "parse_sweep_block", "WorkflowError",
    "WorkflowGroup", "WorkflowManager", "toposort",
]
