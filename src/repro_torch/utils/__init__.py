"""Small helpers shared by the port's packages."""

from repro_torch.utils.hlo import collective_bytes, parse_cost_analysis
from repro_torch.utils.trees import (
    flatten_dict,
    map_with_path,
    tree_bytes,
    tree_size,
    tree_zeros_like,
    unflatten_dict,
)

__all__ = [
    "collective_bytes",
    "parse_cost_analysis",
    "tree_size",
    "tree_bytes",
    "tree_zeros_like",
    "map_with_path",
    "flatten_dict",
    "unflatten_dict",
]
