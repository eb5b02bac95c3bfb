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
  * int8 error-feedback gradient compression (quant/compress.py) of each
    rank's local gradient block.  The reference's ``dp_axis`` field, which
    its trainer never reads, has no twin.

On a mesh (``launch/train.py --mesh``, or a state placed by
``launch/specs.train_state_pspecs``) every leaf of the state is a
DTensor: a gradient comes back in its parameter's layout (the all-reduce
of a replicated parameter, the reduce-scatter of a sharded one), the
loss and the metrics reduced to replicated values, the AdamW update runs
elementwise on each rank's blocks, and a checkpoint holds the whole
tensors, written by the mesh's first rank and cut back to each rank's
block on resume.

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
from repro_torch.sharding import spmd
from repro_torch.sharding.placed import full, is_dt, like
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
    grads = [torch.zeros_like(p) if g is None else _as_param(g, p)
             for p, g in zip(leaves, grads)]
    return full(loss.detach()), tree_map(full, _detach(aux)), \
        tree_unflatten(params, grads)


def _as_param(g, p):
    """A gradient in its parameter's layout (a partial sum over the lane
    blocks reduced, or reduce-scattered onto a sharded parameter)."""
    if is_dt(g) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _compress_local(grads, err_state):
    """int8 error-feedback of each rank's local gradient blocks: the codes
    and the residual of a block are its rank's own."""
    loc = lambda t: t.to_local() if is_dt(t) else t
    codes, scales, err = compress.compress_tree(tree_map(loc, grads),
                                                tree_map(loc, err_state))
    dec = compress.decompress_tree(codes, scales)
    rewrap = lambda d, g: type(g).from_local(
        d, g.device_mesh, g.placements, run_check=False) if is_dt(g) else d
    return tree_map(rewrap, dec, grads), tree_map(rewrap, err, err_state)


class _As:
    """A live leaf's layout for ``store.restore_into(shardings=)``: the
    whole restored tensor cut to this rank's block as ``live`` is (a
    plain leaf stays whole)."""

    def __init__(self, live):
        self.live = live

    def place(self, whole):
        if not is_dt(self.live):
            return whole
        return spmd.place_as(whole, self.live.device_mesh,
                             self.live.placements)


def _host_float(v) -> float:
    return float(v.full_tensor() if is_dt(v) else v)


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
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = like(torch.zeros((), dtype=torch.float32,
                                    device=state.step.device), state.step)
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
            grads, err_state = _compress_local(grads, err_state)

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
        leaf = tree_leaves(params)[0]
        opt_state = self.opt_init(params)
        if hasattr(opt_state, "step"):  # the counters, replicated on a mesh
            opt_state = opt_state._replace(step=like(opt_state.step, leaf))
        self.state = TrainState(
            params=params, opt_state=opt_state,
            model_state=model_state if has_ms else {},
            err_state=err,
            step=like(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      leaf))
        self.ckpt = store.AsyncCheckpointer(cfg.ckpt_dir, cfg.ckpt_keep) \
            if cfg.ckpt_dir else None
        self.straggler_events: list = []
        self.history: list = []

    def maybe_resume(self) -> int:
        if not self.cfg.ckpt_dir:
            return 0
        got = store.restore_into(self.cfg.ckpt_dir, self.state,
                                 shardings=tree_map(_As, self.state))
        if got is None:
            return 0
        step, tree = got
        self.state = tree._replace(step=like(torch.tensor(
            step, dtype=torch.int32, device=self.state.step.device),
            self.state.step))
        return step

    def run(self, steps: int | None = None):
        steps = steps if steps is not None else self.cfg.steps
        start = int(_host_float(self.state.step))
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
                    {"step": step, **{k: _host_float(v)
                                      for k, v in metrics.items()}})
            if self.ckpt and (step + 1) % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step + 1, self.state)
        if self.ckpt:
            self.ckpt.save_async(int(self.state.step), self.state)
            self.ckpt.wait()
        return self.state, self.history
