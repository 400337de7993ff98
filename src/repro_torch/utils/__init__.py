"""Tree, memory-accounting and device helpers. Re-exports what
``repro.utils`` does."""
from repro_torch.utils.mem import MemoryMeter
from repro_torch.utils.trees import (
    flatten_state_dict,
    tree_bytes,
    tree_param_count,
    unflatten_state_dict,
)

__all__ = [
    "tree_bytes",
    "tree_param_count",
    "flatten_state_dict",
    "unflatten_state_dict",
    "MemoryMeter",
]
