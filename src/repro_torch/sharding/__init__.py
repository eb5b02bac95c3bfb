"""Logical-axis sharding over a ``torch.distributed`` device mesh: the
rules table and specs (``rules.py``), the ambient context (``ctx.py``).
The port of ``repro/sharding/``."""

from repro_torch.sharding.rules import (
    ParamDef,
    DEFAULT_RULES,
    resolve_rules,
    pspec,
    param_pspecs,
    init_params,
    abstract_params,
)

__all__ = [
    "ParamDef",
    "DEFAULT_RULES",
    "resolve_rules",
    "pspec",
    "param_pspecs",
    "init_params",
    "abstract_params",
]
