"""Training loop: grad accumulation, checkpoint/restart, straggler hooks.

The port of ``repro/training/trainer.py``, on trees of tensors, with
gradients from autograd.

Fault-tolerance contract (``tests/test_torch_training.py``; on the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s train phase):
  * checkpoints are atomic + validated (checkpoint/store.py);
  * the data stream is seekable by step (``data_fn(step)``), and every op
    of a step is deterministic, so kill-and-resume reproduces the
    uninterrupted run bit for bit;
  * saves are async (device->host snapshot on the loop thread only);
  * a per-step wall-clock EMA flags stragglers (the hook records them).

Levers (wired via TrainConfig):
  * microbatch gradient accumulation over a leading micro-batch axis of
    the batch, the model state (TCN batch-norm running stats) chained
    from one micro-batch to the next;
  * int8 error-feedback gradient compression (quant/compress.py).  The
    reference applies it around a ``shard_map`` all-reduce over its
    ``dp_axis``; one card has no all-reduce, so the port compresses and
    decompresses the local gradient and has no ``dp_axis``.

A step writes into no tensor it was given: the optimizer's updates are
new tensors, so the caller's params are never changed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.checkpoint import store
from repro_torch.quant import compress
from repro_torch.training import optim
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    model_state: Any   # e.g. TCN batch-norm running stats ({} for none)
    err_state: Any     # error-feedback residuals ({} when compression off)
    step: torch.Tensor


@dataclass
class TrainConfig:
    steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    straggler_factor: float = 3.0
    grad_compression: str | None = None  # None | "int8_ef"


def _detach(tree):
    return tree_map(lambda x: x.detach(), tree)


def value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads) of ``loss_fn(params, *args) -> (loss, aux)``:
    the gradient w.r.t. every leaf of ``params`` (zeros for a leaf the
    loss does not use, as ``jax.value_and_grad`` gives), all detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _detach(aux), tree_unflatten(params, grads)


def make_train_step(loss_fn, optimizer, *, grad_accum: int = 1,
                    has_model_state: bool = False,
                    grad_compression: str | None = None):
    """loss_fn(params, batch [, model_state]) -> (loss, metrics[, new_state]).
    With ``grad_accum`` > 1 every leaf of the batch has a leading
    micro-batch axis."""
    _, opt_update = optimizer

    def compute_grads(params, model_state, batch):
        if has_model_state:
            loss, (metrics, new_ms), grads = value_and_grad(
                loss_fn, params, batch, model_state)
        else:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
            new_ms = model_state
        return loss, metrics, new_ms, grads

    def train_step(state: TrainState, batch):
        params = state.params
        if grad_accum > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            new_ms, per_mb = state.model_state, []
            for i in range(tree_leaves(batch)[0].shape[0]):
                mb = tree_map(lambda x: x[i], batch)
                l_i, m_i, new_ms, g_i = compute_grads(params, new_ms, mb)
                grads = tree_map(lambda a, g: a + g / grad_accum, grads, g_i)
                loss = loss + l_i / grad_accum
                per_mb.append(m_i)
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}
        else:
            loss, metrics, new_ms, grads = compute_grads(
                params, state.model_state, batch)

        err_state = state.err_state
        if grad_compression == "int8_ef":
            codes, scales, err_state = compress.compress_tree(grads,
                                                              err_state)
            grads = compress.decompress_tree(codes, scales)

        updates, opt_state, opt_metrics = opt_update(grads, state.opt_state,
                                                     params)
        params = optim.apply_updates(params, updates)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return TrainState(params, opt_state, new_ms, err_state,
                          state.step + 1), metrics

    return train_step


def _block(t: torch.Tensor) -> None:
    """Wait for the device that holds ``t`` (the step is timed to its end)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Trainer:
    def __init__(self, loss_fn, params, cfg: TrainConfig,
                 data_fn: Callable[[int], Any], *, optimizer=None,
                 model_state=None):
        self.cfg = cfg
        optimizer = optimizer or optim.adamw(3e-4)
        self.opt_init, _ = optimizer
        # no copy of params, unlike the reference (whose jit step donates
        # its state): a step writes into no tensor it was given
        has_ms = model_state is not None
        self.data_fn = data_fn
        self.train_step = make_train_step(
            loss_fn, optimizer, grad_accum=cfg.grad_accum,
            has_model_state=has_ms, grad_compression=cfg.grad_compression)
        err = compress.init_error_state(params) if cfg.grad_compression \
            else {}
        dev = tree_leaves(params)[0].device
        self.state = TrainState(
            params=params, opt_state=self.opt_init(params),
            model_state=model_state if has_ms else {},
            err_state=err,
            step=torch.zeros((), dtype=torch.int32, device=dev))
        self.ckpt = store.AsyncCheckpointer(cfg.ckpt_dir, cfg.ckpt_keep) \
            if cfg.ckpt_dir else None
        self.straggler_events: list = []
        self.history: list = []

    def maybe_resume(self) -> int:
        if not self.cfg.ckpt_dir:
            return 0
        got = store.restore_into(self.cfg.ckpt_dir, self.state)
        if got is None:
            return 0
        step, tree = got
        self.state = tree._replace(step=torch.tensor(
            step, dtype=torch.int32, device=self.state.step.device))
        return step

    def run(self, steps: int | None = None):
        steps = steps if steps is not None else self.cfg.steps
        start = int(self.state.step)
        ema = None
        for step in range(start, steps):
            batch = self.data_fn(step)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            _block(metrics["loss"])
            dt = time.perf_counter() - t0
            # straggler detection: step latency vs EMA.  The first steps
            # include warm-up (allocator, first launches) and must not
            # seed the EMA, or a real straggler later hides under the
            # inflated baseline.
            if ema is not None and dt > self.cfg.straggler_factor * ema:
                self.straggler_events.append((step, dt, ema))
            if step >= start + 2:
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if step % self.cfg.log_every == 0 or step == steps - 1:
                self.history.append(
                    {"step": step, **{k: float(v) for k, v in metrics.items()}})
            if self.ckpt and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step + 1, self.state)
        if self.ckpt:
            self.ckpt.save_async(int(self.state.step), self.state)
            self.ckpt.wait()
        return self.state, self.history
