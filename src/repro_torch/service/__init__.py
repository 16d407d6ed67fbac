# Multi-tenant pipeline service, in-process half: job queue, scheduler
# (solo, gang and streaming jobs), built-step cache, checkpoints and the
# wire format.  The HTTP front end, broker-mode workers, sweeps and
# workflows come with later slices (ROADMAP.md "Next" D1-D2).
from .compile_cache import CompileCache
from .checkpoint import CheckpointError, CheckpointStore
from .job import Job, JobState, StreamState, chain_signature
from .queue import JobQueue, QueueFull
from .scheduler import PipelineScheduler, UpstreamGone
from .wire import (WireError, chain_plugin_names, from_spec,
                   register_plugin, registered_plugins, registry_spec,
                   to_spec)

__all__ = [
    "CompileCache", "CheckpointError", "CheckpointStore", "Job",
    "JobState", "StreamState", "chain_signature", "JobQueue", "QueueFull",
    "PipelineScheduler", "UpstreamGone", "WireError", "chain_plugin_names",
    "from_spec", "register_plugin", "registered_plugins", "registry_spec",
    "to_spec",
]
