from repro_torch.configs.registry import ASSIGNED, REGISTRY, get_config
from repro_torch.configs.runtime import RuntimeConfig
from repro_torch.configs.shapes import (
    ENCDEC_ENC_LEN,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    cells,
)

__all__ = ["ASSIGNED", "REGISTRY", "RuntimeConfig", "get_config",
           "SHAPES", "LONG_CONTEXT_ARCHS", "ENCDEC_ENC_LEN", "cells"]
