"""End-to-end example of the PyTorch/CUDA port (the paper's kind):
meta-train the Chameleon TCN embedder with prototypical episodes, then
evaluate

  * FSL on unseen classes (Table I protocol: ways x shots), fp32 and log2
    (Eq. 8), through the deployment path: the trained params baked once
    (``bake_stream_params``), embedded by the fused forward (the
    ``tcn_block`` kernel's strip entry) and enrolled by ``protonet.adapt``
    (the ``proto_extract`` kernel for fp32);
  * few-shot CONTINUAL learning, one class at a time (Fig. 15 protocol),

with checkpointing so the run is resumable.  The twin of
``examples/fsl_episodic.py``.

    PYTHONPATH=src python examples/fsl_episodic_torch.py [--episodes 300]
    PYTHONPATH=src python examples/fsl_episodic_torch.py --device cpu \\
        --episodes 20        # the plain PyTorch versions, no card needed
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core import protonet as pn
from repro_torch.data import EpisodicSampler, GlyphClasses, split_classes
from repro_torch.models import build_tcn_bundle
from repro_torch.models.tcn import (
    bake_stream_params,
    make_fused_forward,
    tcn_empty_state,
)
from repro_torch.training.episodic import fsl_episode, make_episode_step
from repro_torch.training.optim import adamw


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=300)
    ap.add_argument("--img", type=int, default=12)
    ap.add_argument("--classes", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config("chameleon-tcn").replace(
        tcn_channels=(16, 16, 16, 16), tcn_kernel=5, embed_dim=32, n_classes=5)
    bundle = build_tcn_bundle(cfg, args.device)
    dev = bundle.device
    params = bundle.init(torch.Generator().manual_seed(0))
    state = tcn_empty_state(cfg, dev)
    ds = GlyphClasses(args.classes, seed=0, size=args.img)
    train_cls, test_cls = split_classes(args.classes, 0.6, seed=0)
    sampler = EpisodicSampler(ds, train_cls, seed=1)
    opt = adamw(2e-3)
    opt_state = opt[0](params)

    start = 0
    if args.ckpt_dir:
        got = store.restore_into(args.ckpt_dir, {
            "params": params, "state": state, "opt_state": opt_state})
        if got:
            start, tree = got
            params, state, opt_state = (tree["params"], tree["state"],
                                        tree["opt_state"])
            print(f"[resume] from episode {start}")

    t0 = time.time()
    step = make_episode_step(cfg, opt)
    for ep in range(start, args.episodes):
        batch = [torch.from_numpy(a).to(dev) for a in
                 sampler.episode(ep, n_ways=5, k_shots=3, n_query=3)]
        params, state, opt_state, loss, acc = step(params, state, opt_state,
                                                   *batch)
        if ep % 25 == 0:
            print(f"[meta-train] ep {ep:4d} loss {float(loss):.3f} "
                  f"qacc {float(acc):.2f}")
        if args.ckpt_dir and (ep + 1) % 100 == 0:
            store.save(args.ckpt_dir, ep + 1, {
                "params": params, "state": state, "opt_state": opt_state})
    print(f"[meta-train] {args.episodes - start} episodes in "
          f"{time.time() - t0:.0f}s")

    # ---- the deployment path: bake once, fused forward ---------------------
    embed = {}
    for log2 in (False, True):
        _, _, fused = bake_stream_params(params, state, cfg, quantize=log2)
        fwd = make_fused_forward(cfg, quantize=log2, device=dev)
        embed[log2] = lambda x, fwd=fwd, fused=fused: fwd(fused, x)[0]

    # ---- Table I protocol: FSL on UNSEEN classes --------------------------
    def fsl(n_ways, k, log2=False, n_ep=10):
        es = EpisodicSampler(ds, test_cls, seed=99)
        accs = [fsl_episode(embed[log2], es, e, n_ways, k, log2=log2,
                            device=dev)[0] for e in range(n_ep)]
        return np.mean(accs), 1.96 * np.std(accs) / len(accs) ** 0.5

    print("\n== FSL on unseen classes (Table I protocol) ==")
    for n_ways, k in [(5, 1), (5, 5), (10, 1), (10, 5)]:
        a, ci = fsl(n_ways, k)
        aq, _ = fsl(n_ways, k, log2=True)
        print(f"  {n_ways:2d}-way {k}-shot: fp32 {a:.3f} +- {ci:.3f} | "
              f"log2 (Eq. 8) {aq:.3f}")

    # ---- Fig. 15 protocol: continual learning -----------------------------
    print("\n== Continual learning, one class at a time (Fig. 15) ==")
    n_cl = min(20, len(test_cls))
    to_dev = lambda a: torch.from_numpy(a).to(dev)
    for shots in (1, 5):
        st_ = pn.store_init(n_cl, cfg.embed_dim, device=dev)
        accs = []
        for j in range(n_cl):
            sx = ds.sample(int(test_cls[j]), shots, seed=700 + j)
            st_ = pn.store_add_class(st_, embed[False](to_dev(sx)))
            c = t = 0
            for jj in range(j + 1):
                q = ds.sample(int(test_cls[jj]), 4, seed=800 + jj)
                pred = pn.store_classify(st_, embed[False](to_dev(q)))
                c += int(torch.sum(pred == jj))
                t += 4
            accs.append(c / t)
        print(f"  {shots}-shot: final({n_cl} ways) {accs[-1]:.3f} "
              f"avg {np.mean(accs):.3f}")
    print("\ndone — learning was a forward pass + segment-sum throughout "
          "(no gradients after meta-training).")


if __name__ == "__main__":
    main()
