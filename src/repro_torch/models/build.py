"""Model bundles — the TCN bundle only (``repro/models/build.py``'s
``build_tcn_bundle``); the LM families come in a later slice.

A ``Bundle`` carries the config, the param defs, the device the bundle's
tensors live on and ``embed_fn``, the shot embedder the PN-as-FC learning
head (core/protonet.py) and the session service consume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.dispatch import require_device
from repro_torch.models import tcn as tcn_mod
from repro_torch.models.config import ArchConfig


@dataclass
class Bundle:
    cfg: ArchConfig
    param_defs: dict
    device: torch.device
    embed_fn: Callable  # (params, batch, state=None, quantize=False) -> (B, V)

    def init(self, generator: torch.Generator) -> dict:
        return tcn_mod.init_params(self.param_defs, generator, self.device)


def build_tcn_bundle(cfg: ArchConfig, device="cuda") -> Bundle:
    dev = require_device(device)

    def embed_fn(params, batch, state=None, quantize=False):
        state = state if state is not None \
            else tcn_mod.tcn_empty_state(cfg, dev)
        emb, _ = tcn_mod.tcn_forward(params, state, cfg, batch["x"],
                                     quantize=quantize)
        return emb

    return Bundle(cfg=cfg, param_defs=tcn_mod.tcn_param_defs(cfg),
                  device=dev, embed_fn=embed_fn)
