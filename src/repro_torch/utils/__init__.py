from repro_torch.utils.registry import Registry

__all__ = ["Registry"]
