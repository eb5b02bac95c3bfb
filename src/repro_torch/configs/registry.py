"""Architecture registry of the port: the ten assigned LM configs and the
paper's own TCN presets, as in ``repro/configs/registry.py``.  Every config
is data; ``models/build.build_bundle`` builds the families this port
serves (``tcn`` and ``dense``) and refuses the others."""

from __future__ import annotations

from repro_torch.configs.chameleon_tcn import (
    CHAMELEON_TCN,
    CHAMELEON_TCN_AUDIO,
    CHAMELEON_TCN_KWS,
)
from repro_torch.configs.command_r_35b import COMMAND_R_35B
from repro_torch.configs.deepseek_v2_lite_16b import DEEPSEEK_V2_LITE
from repro_torch.configs.internvl2_76b import INTERNVL2_76B
from repro_torch.configs.moonshot_v1_16b_a3b import MOONSHOT_16B_A3B
from repro_torch.configs.olmo_1b import OLMO_1B
from repro_torch.configs.qwen25_32b import QWEN25_32B
from repro_torch.configs.rwkv6_1p6b import RWKV6_1B6
from repro_torch.configs.seamless_m4t_large_v2 import SEAMLESS_M4T_V2
from repro_torch.configs.stablelm_1p6b import STABLELM_1B6
from repro_torch.configs.zamba2_1p2b import ZAMBA2_1B2
from repro_torch.models.config import ArchConfig

ASSIGNED = [
    RWKV6_1B6, DEEPSEEK_V2_LITE, MOONSHOT_16B_A3B, OLMO_1B, STABLELM_1B6,
    COMMAND_R_35B, QWEN25_32B, ZAMBA2_1B2, INTERNVL2_76B, SEAMLESS_M4T_V2,
]

REGISTRY = {c.name: c for c in ASSIGNED + [
    CHAMELEON_TCN, CHAMELEON_TCN_AUDIO, CHAMELEON_TCN_KWS]}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
