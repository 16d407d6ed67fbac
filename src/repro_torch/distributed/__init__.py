from .checkpoint import CheckpointManager
from .compression import (compressed_psum, dequantise_int8, quantise_int8,
                          quantise_tree)
from .param_sharding import (batch_shardings, distribute_params,
                             param_shardings, replicated, spec_for)
from .straggler import StragglerEvent, StragglerMonitor

__all__ = ["CheckpointManager", "compressed_psum", "quantise_int8",
           "dequantise_int8", "quantise_tree", "param_shardings",
           "batch_shardings", "distribute_params", "replicated", "spec_for",
           "StragglerMonitor", "StragglerEvent"]
