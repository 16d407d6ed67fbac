from .registry import (ARCH_IDS, SHAPES, SUBQUADRATIC, all_cells,
                       cell_supported, get_config, smoke_batch)

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC", "all_cells",
           "cell_supported", "get_config", "smoke_batch"]
