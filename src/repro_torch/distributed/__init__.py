from .checkpoint import CheckpointManager
from .straggler import StragglerEvent, StragglerMonitor

__all__ = ["CheckpointManager", "StragglerMonitor", "StragglerEvent"]
