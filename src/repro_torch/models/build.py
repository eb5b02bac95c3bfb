"""Model bundles — the TCN bundle only (``repro/models/build.py``'s
``build_tcn_bundle``); the LM families come in a later slice.

A ``Bundle`` carries the config, the param defs, the device the bundle's
tensors live on, ``loss_fn`` (the train-mode forward and the FC head's
cross-entropy, what ``training/trainer.py`` differentiates),
``prefill_fn`` and ``embed_fn``, the shot embedder the PN-as-FC learning
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
    # (params, batch, state=None, quantize=False)
    #   -> (loss, ({"acc": acc}, new_state))
    loss_fn: Callable
    prefill_fn: Callable  # (params, batch) -> (logits, {})

    def init(self, generator: torch.Generator) -> dict:
        return tcn_mod.init_params(self.param_defs, generator, self.device)


def cross_entropy(logits, labels):
    """(mean of logsumexp - gold logit, accuracy), as the reference's
    TCN loss computes them."""
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return torch.mean(lse - gold), acc


def build_tcn_bundle(cfg: ArchConfig, device="cuda") -> Bundle:
    dev = require_device(device)

    def loss_fn(params, batch, state=None, quantize=False):
        state = state if state is not None \
            else tcn_mod.tcn_empty_state(cfg, dev)
        _, logits, new_state = tcn_mod.tcn_forward(
            params, state, cfg, batch["x"], train=True, quantize=quantize)
        loss, acc = cross_entropy(logits, batch["labels"])
        return loss, ({"acc": acc}, new_state)

    def embed_fn(params, batch, state=None, quantize=False):
        state = state if state is not None \
            else tcn_mod.tcn_empty_state(cfg, dev)
        emb, _, _ = tcn_mod.tcn_forward(params, state, cfg, batch["x"],
                                        quantize=quantize)
        return emb

    def prefill_fn(params, batch):
        state = tcn_mod.tcn_empty_state(cfg, dev)
        _, logits, _ = tcn_mod.tcn_forward(params, state, cfg, batch["x"])
        return logits, {}

    return Bundle(cfg=cfg, param_defs=tcn_mod.tcn_param_defs(cfg),
                  device=dev, embed_fn=embed_fn, loss_fn=loss_fn,
                  prefill_fn=prefill_fn)
