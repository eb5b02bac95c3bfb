from repro_torch.configs.registry import REGISTRY, get_config
from repro_torch.configs.runtime import RuntimeConfig

__all__ = ["REGISTRY", "RuntimeConfig", "get_config"]
