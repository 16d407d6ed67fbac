# The service layer, local mode: a multi-tenant scheduler that runs many
# process lists concurrently over shared workers (solo, gang and
# streaming jobs), with a process-level built-step cache,
# checkpoint/resume, a JSON-over-HTTP front end (server/client/wire) for
# remote submission, parameter sweeps (sweep: Savu-style tuning expanded
# into gang-batched variant jobs) and workflow DAGs (workflow).
# Broker-mode workers come with a later slice (ROADMAP.md "Next" D1
# part two).
from .compile_cache import CompileCache
from .checkpoint import CheckpointError, CheckpointStore
from .client import PipelineClient, ServiceError
from .job import Job, JobState, StreamState, chain_signature
from .queue import JobQueue, QueueFull
from .scheduler import PipelineScheduler, UpstreamGone
from .server import PipelineService
from .sweep import (METRICS, SweepAxis, SweepError, SweepGroup,
                    SweepManager, expand_sweep, parse_sweep_block)
from .wire import (WireError, chain_plugin_names, from_spec,
                   register_plugin, registered_plugins, registry_spec,
                   to_spec)
from .workflow import (WorkflowError, WorkflowGroup, WorkflowManager,
                       toposort)

__all__ = [
    "CompileCache", "CheckpointError", "CheckpointStore", "Job",
    "JobState", "StreamState", "chain_signature", "JobQueue", "QueueFull",
    "PipelineScheduler", "UpstreamGone", "PipelineService",
    "PipelineClient", "ServiceError", "WireError", "chain_plugin_names",
    "from_spec", "register_plugin", "registered_plugins", "registry_spec",
    "to_spec", "METRICS", "SweepAxis", "SweepError", "SweepGroup",
    "SweepManager", "expand_sweep", "parse_sweep_block", "WorkflowError",
    "WorkflowGroup", "WorkflowManager", "toposort",
]
