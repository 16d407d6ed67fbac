"""Wire-registered test plugins for the port's broker/worker tests — the
port's counterpart of ``slow_plugins.py``.

Imported BOTH by the test process (so the broker's spec validation
knows the plugins) and by worker subprocesses via ``python -m
repro_torch.service.worker --import torch_slow_plugins`` (so the worker
can execute them) — which also exercises the capability filter: a
worker started WITHOUT the import is never leased a chain containing
``slow_identity``.  ``chip_smoke.py`` imports it the same way for its
kill-and-resume check.

A test process imports it only while the wire registry is swapped for a
copy (``monkeypatch.setattr(wire, "_REGISTRY", ...)``) and registers
:data:`PLUGINS` into that copy, so the process-wide registry keeps only
the default plugins.

On a ``CudaTransport`` a per-frame plugin takes the whole frame stack
in one call, so ``delay`` is slept once per step there; host transports
call it once per frame.
"""
import time

from repro_torch.core.patterns import PROJECTION, VOLUME_XZ
from repro_torch.core.plugin import BaseFilter
from repro_torch.service import register_plugin


@register_plugin
class SlowIdentity(BaseFilter):
    """Pass-through that sleeps per call — makes a chain slow enough to
    SIGKILL a worker mid-job deterministically."""

    name = "slow_identity"
    pattern_name = PROJECTION
    frames = 1
    parameters = {"delay": 0.1}

    def process_frames(self, frames):
        time.sleep(self.params["delay"])
        return frames[0]


@register_plugin
class SlowVolumeIdentity(BaseFilter):
    """Volume-pattern pass-through that sleeps per call — slows a
    workflow's DOWNSTREAM node (which consumes an upstream VOLUME output,
    docs/workflows.md) so its worker can be SIGKILLed mid-node."""

    name = "slow_volume_identity"
    pattern_name = VOLUME_XZ
    frames = 1
    parameters = {"delay": 0.1}

    def process_frames(self, frames):
        time.sleep(self.params["delay"])
        return frames[0]


@register_plugin
class FailingPlugin(BaseFilter):
    """Raises on the first call — drives a workflow node to FAILED so the
    downstream cascade (cancelled, reason ``upstream_failed``) can be
    asserted."""

    name = "failing_plugin"
    pattern_name = PROJECTION
    frames = 1
    parameters = {"message": "injected failure"}

    def process_frames(self, frames):
        raise RuntimeError(self.params["message"])


#: every plugin this module registers
PLUGINS = (SlowIdentity, SlowVolumeIdentity, FailingPlugin)
