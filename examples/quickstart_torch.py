"""Quickstart (the PyTorch/CUDA port): the paper's loop in a minute.

1. meta-train a small Chameleon TCN embedder on synthetic sequential
   glyphs,
2. learn a NEW 5-way task gradient-free via the PN-as-FC head (Eq. 6),
3. stream one query through the ring-buffer executor.

The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

from repro_torch.core import protonet as pn
from repro_torch.core.streaming import stream_init, stream_step
from repro_torch.data import EpisodicSampler
from repro_torch.models.tcn import tcn_forward
from repro_torch.training.episodic import get_meta_trained_tcn


def few_shot(cfg, params, state, ds, test_cls, device="cuda") -> dict:
    """Step 2: one 5-way 3-shot episode on unseen classes, the head
    extracted from the support's embeddings (``support_sums`` ->
    ``pn_fc_from_sums``, no gradient).  Returns the query's ``logits``,
    ``pred``, labels ``qy`` and inputs ``qx``, and the accuracy ``acc``."""
    sampler = EpisodicSampler(ds, test_cls, seed=5)
    sx, sy, qx, qy = (torch.from_numpy(a).to(device) for a in
                      sampler.episode(0, n_ways=5, k_shots=3, n_query=4))
    emb_s, _, _ = tcn_forward(params, state, cfg, sx)
    w, b = pn.pn_fc_from_sums(pn.support_sums(emb_s, sy, 5), k=3)
    emb_q, _, _ = tcn_forward(params, state, cfg, qx)
    logits = pn.pn_logits(emb_q, w, b)
    pred = torch.argmax(logits, dim=-1)
    acc = float(torch.mean((pred == qy.long()).to(torch.float32)))
    return {"logits": logits, "pred": pred, "qy": qy, "qx": qx, "acc": acc}


def stream_one(cfg, params, state, x):
    """Step 3: a (1, T, C_in) query through the ring-buffer executor, one
    ``stream_step`` a sample.  Returns (the last streamed embedding, the
    full forward's)."""
    sstate = stream_init(cfg, 1, device=x.device)
    for t in range(x.shape[1]):
        sstate, emb, _ = stream_step(params, state, cfg, sstate, x[:, t])
    full, _, _ = tcn_forward(params, state, cfg, x)
    return emb, full


def run(device="cuda", episodes: int = 80, params=None) -> dict:
    """The three steps; returns ``few_shot``'s dict with ``stream_emb``,
    ``full_emb`` and their max abs difference ``stream_err``.
    ``params``: an initial tree for the meta-training (its seeded init
    when None)."""
    cfg, bundle, params, state, ds, test_cls = get_meta_trained_tcn(
        episodes=episodes, device=device, params=params)
    out = few_shot(cfg, params, state, ds, test_cls, bundle.device)
    emb, full = stream_one(cfg, params, state, out["qx"][:1])
    return {**out, "stream_emb": emb, "full_emb": full,
            "stream_err": float(torch.max(torch.abs(emb - full)))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--episodes", type=int, default=80)
    args = ap.parse_args(argv)
    print("== meta-training a 3-block TCN PN embedder (synthetic Omniglot) ==")
    print("== gradient-free FSL on unseen classes (PN-as-FC, Eq. 6) ==")
    out = run(args.device, args.episodes)
    print(f"   learned 5 new classes from 15 examples -> query acc "
          f"{out['acc']:.2f} (chance 0.20)")
    print("== streaming one query through the ring-buffer executor ==")
    print(f"   streaming output == full conv (max err {out['stream_err']:.1e})")
    print("done.")
    return out


if __name__ == "__main__":
    main()
