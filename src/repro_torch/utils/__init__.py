from repro_torch.utils.registry import Registry
from repro_torch.utils.trees import param_count, tree_bytes

__all__ = ["Registry", "param_count", "tree_bytes"]
