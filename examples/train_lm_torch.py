"""LM training example of the PyTorch/CUDA port, with fault tolerance:
train a reduced assigned arch on the synthetic seekable stream, "crash" at
60 % of the steps, and resume exactly from the last checkpoint.  The twin
of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--arch olmo-1b] \\
        [--steps 150]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu \\
        --steps 20        # the CPU, asked for

(``repro_torch/launch/train.py`` is the launcher for full configs.)
"""

import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.kernels.dispatch import require_device
from repro_torch.launch.analytic import param_count
from repro_torch.models import build_bundle
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training.optim import adamw, warmup_cosine
from repro_torch.utils.trees import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = get_config(args.arch).smoke()
    bundle = build_bundle(cfg, dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    print(f"[setup] {cfg.name} (reduced): "
          f"{param_count(bundle.param_defs) / 1e6:.2f}M params on {dev}")

    def data(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                lm_batch(step, args.batch, args.seq, cfg.vocab_size).items()}

    opt = adamw(warmup_cosine(3e-3, args.steps // 10, args.steps))
    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainConfig(steps=args.steps, ckpt_dir=ckpt, ckpt_every=20,
                         log_every=10)
        crash = int(args.steps * 0.6)
        print("[run 1] training, will 'crash' at 60% ...")
        t1 = Trainer(bundle.loss_fn, params, tc, data, optimizer=opt)
        t1.run(steps=crash)

        print("[run 2] relaunch -> auto-resume from latest valid checkpoint")
        t2 = Trainer(bundle.loss_fn, params, tc, data, optimizer=opt)
        resumed = t2.maybe_resume()
        print(f"[run 2] resumed at step {resumed}")
        state, hist = t2.run()
        for h in hist:
            print(f"  step {h['step']:4d} loss {h['loss']:.4f} "
                  f"acc {h.get('acc', 0):.3f}")

        print("[check] one uninterrupted run of the same steps")
        t3 = Trainer(bundle.loss_fn, params,
                     TrainConfig(steps=args.steps, log_every=10), data,
                     optimizer=opt)
        whole, _ = t3.run()
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state.params), tree_leaves(whole.params)))
        print(f"[check] resumed run equal to the uninterrupted one bit for "
              f"bit: {exact}")
        if not exact:
            raise SystemExit("resume was not exact")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[done] loss {first:.3f} -> {last:.3f} "
          f"(copy-task structure learned: {last < first})")
    return state, hist


if __name__ == "__main__":
    main()
