# The GCN model's eval forward in PyTorch (training parts: training slice).
from repro_torch.core.model import GCNConfig, forward, init_params

__all__ = ["GCNConfig", "forward", "init_params"]
