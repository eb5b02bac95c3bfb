"""Prototypical meta-training of the TCN embedder (paper §II-A, §III-A)
and the Table I evaluation on unseen classes.

The port of the meta-training loop that the reference keeps outside its
package (``examples/fsl_episodic.py``, ``benchmarks/common.py``): an
episode's support batch goes through the train-mode forward, its query
batch through another train-mode forward on the support's new BN state,
the support embeddings become the PN-as-FC head (``support_sums`` ->
``pn_fc_from_sums``), and the loss is the query's cross-entropy.  Only
the support's new BN state is returned.  ``get_meta_trained_tcn`` is
the reduced embedder the reference's FSL/CL benchmarks and its quickstart
meta-train once and reuse.
"""

from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.core import protonet as pn
from repro_torch.data import EpisodicSampler, GlyphClasses, split_classes
from repro_torch.kernels.dispatch import require_device
from repro_torch.models.build import build_tcn_bundle, cross_entropy
from repro_torch.models.config import ArchConfig
from repro_torch.models.tcn import tcn_empty_state, tcn_forward
from repro_torch.training.optim import adamw, apply_updates
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


_META_TRAINED: dict = {}


def get_meta_trained_tcn(episodes: int = 260, img: int = 12,
                         n_classes: int = 40, seed: int = 0, *,
                         device="cuda", params=None):
    """Meta-train the paper's TCN PN embedder, reduced (3 blocks of 16
    channels, k=5, embed_dim 32), on ``img`` x ``img`` glyphs: ``episodes``
    5-way 3-shot 3-query episodes of the first half of ``n_classes``
    classes, AdamW 2e-3.  Returns (cfg, bundle, params, state, ds,
    test_cls): the trained tree, its BN state, the glyph classes and the
    unseen half.  The result is kept per (episodes, img, n_classes, seed,
    device) and reused; ``params`` (an initial tree, e.g. a reference tree
    carried over with ``convert.params_from_jax``) replaces the seeded
    init, and such a run is not kept."""
    dev = require_device(device)
    key = (episodes, img, n_classes, seed, str(dev))
    if params is None and key in _META_TRAINED:
        return _META_TRAINED[key]
    cfg = get_config("chameleon-tcn").replace(
        tcn_channels=(16, 16, 16), tcn_kernel=5, embed_dim=32, n_classes=5)
    bundle = build_tcn_bundle(cfg, dev)
    keep = params is None
    if keep:
        params = bundle.init(torch.Generator().manual_seed(seed))
    state = tcn_empty_state(cfg, dev)
    ds = GlyphClasses(n_classes, seed=seed, size=img)
    train_cls, test_cls = split_classes(n_classes, 0.5, seed=seed)
    sampler = EpisodicSampler(ds, train_cls, seed=seed + 1)
    opt = adamw(2e-3)
    opt_state = opt[0](params)
    step = make_episode_step(cfg, opt)
    for ep in range(episodes):
        batch = [torch.from_numpy(a).to(dev) for a in
                 sampler.episode(ep, n_ways=5, k_shots=3, n_query=3)]
        params, state, opt_state, _, _ = step(params, state, opt_state,
                                              *batch)
    out = (cfg, bundle, params, state, ds, test_cls)
    if keep:
        _META_TRAINED[key] = out
    return out
