"""Assigned architecture configs. See registry.py for the cell matrix."""
from repro_torch.configs.registry import (ALIASES, ARCH_IDS, SHAPES,
                                          ShapeSpec, all_cells, cells,
                                          get_config, get_smoke)
