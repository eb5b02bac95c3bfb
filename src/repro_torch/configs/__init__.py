from repro_torch.configs.registry import REGISTRY, get_config

__all__ = ["REGISTRY", "get_config"]
