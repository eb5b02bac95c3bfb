"""One-card LM training launcher, the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 3 --device cpu      # the CPU, asked for

Trains an LM bundle of the zoo on the synthetic, step-seekable copy-task
stream (``data.lm_batch``) with AdamW on a warmup-cosine schedule,
through ``training.Trainer``: exact resume from ``--ckpt-dir`` (a killed
run relaunched with the same arguments continues bit for bit),
gradient accumulation and int8 error-feedback compression.  The weights
are seeded random draws on the device (``Bundle.init``).

``--device`` defaults to ``cuda`` and raises without a card; the CPU runs
only when asked for (``--device cpu``).  The reference's ``--mesh``,
``make_mesh`` and ``shard_ctx`` are gone: they lay the step over a device
mesh, which has no meaning on one card.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_batch
from repro_torch.kernels.dispatch import require_device
from repro_torch.launch.analytic import param_count
from repro_torch.models import build_bundle
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training.optim import adamw, warmup_cosine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Train as the arguments say; returns (the final TrainState, the
    logged history)."""
    args = parse_args(argv)
    dev = require_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.batch % args.grad_accum:
        raise ValueError("--batch must be a multiple of --grad-accum")
    bundle = build_bundle(cfg, dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    print(f"[train] {cfg.name}: {param_count(bundle.param_defs) / 1e6:.2f}M "
          f"params on {dev}")

    def data_fn(step):
        b = lm_batch(step, args.batch, args.seq, cfg.vocab_size)
        if args.grad_accum > 1:
            b = {k: v.reshape(args.grad_accum, -1, *v.shape[1:])
                 for k, v in b.items()}
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    tcfg = TrainConfig(
        steps=args.steps, grad_accum=args.grad_accum, log_every=10,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        grad_compression="int8_ef" if args.compress_grads else None)
    optimizer = adamw(warmup_cosine(args.lr, args.steps // 10, args.steps))
    trainer = Trainer(bundle.loss_fn, params, tcfg, data_fn,
                      optimizer=optimizer)
    resumed = trainer.maybe_resume()
    if resumed:
        print(f"[train] resumed from step {resumed}")
    state, hist = trainer.run()
    for h in hist:
        print(f"[train] step {h['step']:5d} loss {h['loss']:.4f} "
              f"acc {h.get('acc', 0):.3f} gnorm {h.get('grad_norm', 0):.2f}")
    if trainer.straggler_events:
        print(f"[train] straggler events: {trainer.straggler_events}")
    return state, hist


if __name__ == "__main__":
    main()
