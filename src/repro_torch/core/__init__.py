# The paper's primary contribution — a pattern-driven, plugin-based
# processing framework (Savu) re-expressed for PyTorch on one CUDA device.
from .patterns import (BATCH, DIFFRACTION, EXPERT, HEADS, PROJECTION,
                       SEQUENCE, SINOGRAM, SPECTRUM, TIMESERIES, TOKENS,
                       VOLUME_XZ, Pattern, pattern_from_labels)
from .dataset import DataSet
from .plugin import (BaseFilter, BaseLoader, BasePlugin, BaseRecon,
                     BaseSaver, CPU_DRIVER, GPU_DRIVER, DeviceDriver,
                     LambdaFilter, PluginData)
from .process_list import PluginEntry, ProcessList, ProcessListError
from .framework import PluginRunner, run_process_list
from .transport import (ChunkedFile, ChunkedFileTransport, CudaTransport,
                        GangSignatureMismatch, InMemoryTransport, IOStats,
                        LocalCompileCache, Transport)
from .chunking import (DEFAULT_CACHE_BYTES, chunks_touched, naive_chunks,
                       optimise_chunks)
from .profiler import Event, Profiler

__all__ = [
    "Pattern", "pattern_from_labels", "DataSet", "BasePlugin", "BaseFilter",
    "BaseRecon", "BaseLoader", "BaseSaver", "LambdaFilter", "DeviceDriver",
    "PluginData", "CPU_DRIVER", "GPU_DRIVER", "ProcessList", "PluginEntry",
    "ProcessListError", "PluginRunner", "run_process_list", "Transport",
    "InMemoryTransport", "CudaTransport", "GangSignatureMismatch",
    "ChunkedFileTransport",
    "ChunkedFile", "IOStats", "LocalCompileCache", "optimise_chunks",
    "naive_chunks", "chunks_touched", "DEFAULT_CACHE_BYTES", "Profiler",
    "Event", "PROJECTION", "SINOGRAM", "SPECTRUM", "DIFFRACTION",
    "VOLUME_XZ", "TIMESERIES", "BATCH", "SEQUENCE", "TOKENS", "EXPERT",
    "HEADS",
]
