"""Prototypical meta-training of the TCN embedder (paper §II-A, §III-A)
and the Table I evaluation on unseen classes.

The port of the meta-training loop that the reference keeps outside its
package (``examples/fsl_episodic.py``, ``benchmarks/common.py``): an
episode's support batch goes through the train-mode forward, its query
batch through another train-mode forward on the support's new BN state,
the support embeddings become the PN-as-FC head (``support_sums`` ->
``pn_fc_from_sums``), and the loss is the query's cross-entropy.  Only
the support's new BN state is returned.
"""

from __future__ import annotations

import torch

from repro_torch.core import protonet as pn
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.build import cross_entropy
from repro_torch.models.config import ArchConfig
from repro_torch.models.tcn import tcn_forward
from repro_torch.training.optim import apply_updates
from repro_torch.training.trainer import value_and_grad


def episode_loss(params, state, cfg: ArchConfig, sx, sy, qx, qy, *,
                 n_ways: int, quantize: bool = False):
    """Returns (loss, (the support's new BN state, query accuracy))."""
    emb_s, _, new_state = tcn_forward(params, state, cfg, sx, train=True,
                                      quantize=quantize)
    emb_q, _, _ = tcn_forward(params, new_state, cfg, qx, train=True,
                              quantize=quantize)
    s = pn.support_sums(emb_s, sy, n_ways)
    w, b = pn.pn_fc_from_sums(s, sx.shape[0] // n_ways)
    loss, acc = cross_entropy(pn.pn_logits(emb_q, w, b), qy)
    return loss, (new_state, acc)


def make_episode_step(cfg: ArchConfig, optimizer, *, n_ways: int = 5,
                      quantize: bool = False):
    """``step(params, state, opt_state, sx, sy, qx, qy) -> (params,
    state, opt_state, loss, acc)``: one optimizer update on one episode
    (``quantize=True``: the QAT fake-quant forward)."""
    _, opt_update = optimizer

    def step(params, state, opt_state, sx, sy, qx, qy):
        loss, (new_state, acc), grads = value_and_grad(
            lambda p: episode_loss(p, state, cfg, sx, sy, qx, qy,
                                   n_ways=n_ways, quantize=quantize), params)
        updates, opt_state, _ = opt_update(grads, opt_state, params)
        return apply_updates(params, updates), new_state, opt_state, loss, acc

    return step


def fsl_episode(embed, sampler, ep: int, n_ways: int, k: int, *,
                n_query: int = 4, log2: bool = False, device="cuda"):
    """One Table I episode on the sampler's (unseen) classes: ``embed(x)
    -> (B, V)`` embeds the support and the query, ``protonet.adapt``
    extracts the FC head from the support embeddings (``proto_extract``
    for fp32, Eq. 8 for log2), and the query is classified by argmax.
    Returns (accuracy, a dict of the episode's tensors: sx, sy, qx, qy,
    emb_s, emb_q, w, b, pred)."""
    dev = require_device(device)
    sx, sy, qx, qy = (torch.from_numpy(a).to(dev)
                      for a in sampler.episode(ep, n_ways, k, n_query))
    emb_s = embed(sx)
    w, b = pn.adapt(lambda _, e: e, None, emb_s, sy, n_ways, k, log2=log2)
    emb_q = embed(qx)
    pred = torch.argmax(pn.pn_logits(emb_q, w, b), dim=-1)
    acc = float(torch.mean((pred == qy.long()).to(torch.float32)))
    return acc, {"sx": sx, "sy": sy, "qx": qx, "qy": qy, "emb_s": emb_s,
                 "emb_q": emb_q, "w": w, "b": b, "pred": pred}
