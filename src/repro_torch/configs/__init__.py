from .registry import (ARCH_IDS, SHAPES, SUBQUADRATIC, CellSpec, TensorSpec,
                       all_cells, cell_supported, get_config, input_specs,
                       smoke_batch)

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC", "CellSpec", "TensorSpec",
           "all_cells", "cell_supported", "get_config", "input_specs",
           "smoke_batch"]
