"""Architecture registry of the port: the TCN presets only (the LM zoo of
``repro/configs/registry.py`` is not ported yet)."""

from __future__ import annotations

from repro_torch.configs.chameleon_tcn import (
    CHAMELEON_TCN,
    CHAMELEON_TCN_AUDIO,
    CHAMELEON_TCN_KWS,
)
from repro_torch.models.config import ArchConfig

REGISTRY = {c.name: c for c in (
    CHAMELEON_TCN, CHAMELEON_TCN_AUDIO, CHAMELEON_TCN_KWS)}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
