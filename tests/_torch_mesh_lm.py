"""Rank workers of tests/test_torch_mesh_params.py.

Every rank of one spawn (gloo on the CPU, one torch thread a rank, a
rendezvous file, a process-group timeout) runs the same scenarios and
pickles what it saw to ``<out>/w<world>_r<rank>.pkl``; the test asserts
in the parent.  The JAX package's side runs in a subprocess of its own
(``jax_main``, one host device: the reference's unsharded functions) and
writes its params and results for the ranks and the parent to read.
Nothing here imports jax at module level: the ranks never import it.

The scenarios:
  * ``CELLS`` on every mesh of ``MESHES``: the params placed by
    ``param_pspecs(DEFAULT_RULES)``, a train step's loss and gradients
    (through the trainer's ``value_and_grad``) or a cached decode's
    logits and cache, under ``shard_ctx``; and the same through the
    port's unsharded functions;
  * speculation over ``LMSessionService(mesh=)``, scan and parallel, an
    oracle and the n-gram drafter, and a park/resume mid-draft, against
    the unsharded service;
  * ``launch/train.py --mesh 2x2``: three steps, a relaunch from the
    step-2 checkpoint, three steps with ``--compress-grads``, and three
    steps of the config in fp32 activations; the launcher without
    ``--mesh`` (the port's unsharded twin) on the first rank, bf16 and
    fp32.
"""

from __future__ import annotations

import os
import pickle
import shutil
from contextlib import nullcontext
from datetime import timedelta

import numpy as np

# (arch, kind, config overrides): the reference sharding test's three
# cells, one zamba2 and one seamless
CELLS = {
    "olmo_train": ("olmo-1b", "train"),
    "deepseek_decode": ("deepseek-v2-lite-16b", "decode"),
    "rwkv_decode": ("rwkv6-1.6b", "decode"),
    "zamba_decode": ("zamba2-1.2b", "decode"),
    "seamless_train": ("seamless-m4t-large-v2", "train"),
}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
B, S, ENC, S_MAX, STEPS = 4, 16, 8, 8, 5

TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=64, head_dim=16)
LM_KW = dict(n_slots=8, seq_cap=48, t_chunk=8)
SPEC_MESHES = {4: {"4x1": (4, 1), "2x2": (2, 2)}, 2: {"2x1": (2, 1)}}
TRAIN_ARGS = ["--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch",
              "8", "--seq", "32", "--device", "cpu", "--ckpt-every", "1"]


def cell_cfg(cell: str, get_config):
    return get_config(CELLS[cell][0]).smoke().replace(act_dtype="float32")


def cell_inputs(cell: str, cfg) -> dict:
    """The cell's seeded numpy inputs: a train batch, or a decode's
    tokens (B, STEPS)."""
    rng = np.random.default_rng(sorted(CELLS).index(cell))
    if CELLS[cell][1] == "decode":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, STEPS))
                .astype(np.int32)}
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, ENC, cfg.d_model)) \
            .astype(np.float32)
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def shaped_like(defs, tree):
    """``tree`` with the empty subtrees of ``defs`` (a non-parametric
    norm's ``{}``) that a flat file drops."""
    if isinstance(defs, dict):
        return {k: shaped_like(v, tree.get(k, {})) for k, v in defs.items()}
    return tree


def unflat(d: dict) -> dict:
    out: dict = {}
    for key, v in d.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def spawn(fn, world: int, args: tuple, timeout: float) -> None:
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_mesh as tm

    tm.spawn(fn, world, args, timeout)


# ---------------------------------------------------------------------------
# the port's ranks: placed params
# ---------------------------------------------------------------------------

def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy().copy()


def dist_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _run_cell(bundle, cfg, kind, params, inputs, mesh, n_lanes: int = B):
    """(results {name: array}, local shapes {param path: shape}) of the
    cell on ``mesh`` (None: the port's unsharded functions)."""
    import torch

    from repro_torch.launch.specs import (
        batch_pspecs,
        cache_pspecs,
        named,
        place_tree,
    )
    from repro_torch.sharding.ctx import shard_ctx
    from repro_torch.sharding.rules import (
        DEFAULT_RULES,
        param_pspecs,
        resolve_rules,
    )
    from repro_torch.training.trainer import value_and_grad

    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    shapes = {}
    place = (lambda specs, tree: tree)
    ctx = None
    if mesh is not None:
        rules = resolve_rules(DEFAULT_RULES, mesh)
        params = place_tree(named(mesh, param_pspecs(bundle.param_defs,
                                                     rules, mesh)), params)
        shapes = {k: tuple(v.to_local().shape)
                  for k, v in flat(params).items()}
        place = (lambda specs, tree: place_tree(named(mesh, specs), tree))
        ctx = shard_ctx(mesh, DEFAULT_RULES)
    out = {}
    with ctx if ctx is not None else nullcontext():
        if kind == "train":
            b = place(batch_pspecs(cfg, batch, mesh), batch) \
                if mesh is not None else batch
            loss, _, grads = value_and_grad(bundle.loss_fn, params, b)
            out["loss"] = _np(loss)
            out.update({f"grad/{k}": _np(v) for k, v in flat(grads).items()})
        else:
            with torch.no_grad():
                cache = bundle.empty_cache(n_lanes, S_MAX)
                if mesh is not None:
                    cache = place(cache_pspecs(cfg, cache, mesh), cache)
                for j in range(STEPS):
                    step = {"tokens": batch["tokens"][:, j:j + 1],
                            "pos": torch.tensor(j, dtype=torch.int32)}
                    if mesh is not None:
                        step = place(batch_pspecs(cfg, step, mesh), step)
                    logits, cache = bundle.decode_fn(params, cache, step)
                    out[f"logits/{j}"] = _np(logits)
                out.update({f"cache/{k}": _np(v)
                            for k, v in flat(cache).items()})
    return out, shapes


def _cells(jax_dir: str, out: dict) -> None:
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_bundle

    meshes = {name: make_mesh(dims, axes, device_type="cpu")
              for name, (dims, axes) in MESHES.items()}
    for cell, (arch, kind) in CELLS.items():
        cfg = cell_cfg(cell, get_config)
        bundle = build_bundle(cfg, "cpu")
        with np.load(os.path.join(jax_dir, f"{cell}.npz")) as z:
            params = shaped_like(bundle.param_defs, params_from_jax(
                unflat({k: z[k] for k in z.files}), "cpu"))
        inputs = cell_inputs(cell, cfg)
        out[(cell, "plain")], _ = _run_cell(bundle, cfg, kind, params,
                                            inputs, None)
        for name, mesh in meshes.items():
            got, shapes = _run_cell(bundle, cfg, kind, params, inputs, mesh)
            out[(cell, name)] = got
            out[(cell, name, "shapes")] = shapes
        if kind == "decode":  # 4x1: this rank's lane, unsharded, alone
            lane = dist_rank()
            mine = {k: v[lane:lane + 1] for k, v in inputs.items()}
            out[(cell, "lane")], _ = _run_cell(bundle, cfg, kind, params,
                                               mine, None, n_lanes=1)


# ---------------------------------------------------------------------------
# speculation over a mesh= service
# ---------------------------------------------------------------------------

def spec_prompts() -> list:
    """Eight prompts with distinct first tokens (the oracle drafter knows
    a session by it)."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(LM_KW["n_slots"]):
        p = rng.integers(0, TINY["vocab_size"], size=rng.integers(1, 7))
        p[0] = i + 1
        out.append(p.astype(np.int32))
    return out


def _oracle(streams: dict):
    """Drafts the port's plain greedy continuation of each prompt."""
    def draft(hist, k):
        prompt, ref = streams[int(hist[0])]
        i = len(hist) - len(prompt)
        return np.asarray(ref[i:i + k], np.int32)

    return draft


def _spec_run(svc, drafter, verify: str) -> dict:
    from repro_torch.sessions.spec import SpeculativeDecoder

    sp = SpeculativeDecoder(svc, drafter, k=4, verify=verify)
    sids = [svc.open_session(p) for p in spec_prompts()]
    toks = [sp.decode({s: 6 for s in sids}), sp.decode({s: 9 for s in sids})]
    reg = svc.metrics_registry
    counters = {name: reg.counter(name, service="lm", verify=verify).value
                for name in ("spec_drafted_total", "spec_accepted_total")}
    counters["spec_device_accepted_total"] = reg.counter(
        "spec_device_accepted_total", service="lm").value
    res = {"tokens": [[t[s] for s in sids] for t in toks],
           "drafted": sp.drafted, "accepted": sp.accepted,
           "accepts": [sp.accepts.get(s, 0) for s in sids],
           "counters": counters}
    for s in sids:
        svc.close(s)
    return res


def _spec_park(svc, verify: str, park: bool) -> dict:
    """A session decoded 7 then 19 tokens (equal call budgets), parked
    between the calls (``park``) while newcomers take every slot, so it
    resumes on another slot (another rank's on a mesh)."""
    from repro_torch.sessions.spec import SpeculativeDecoder, ngram_drafter

    sp = SpeculativeDecoder(svc, ngram_drafter(), k=4, verify=verify)
    sid = svc.open_session(np.array([2, 7, 1], np.int32))
    got = sp.decode({sid: 7})[sid]
    before = svc.sched.slot_of[sid]
    others = []
    if park:
        svc.park(sid)
        others = [svc.open_session(np.array([9 + i], np.int32))
                  for i in range(LM_KW["n_slots"])]
        svc.decode({o: 2 for o in others})
        for o in others[LM_KW["n_slots"] // 2:]:  # the last ranks' slots
            svc.close(o)
    got += sp.decode({sid: 19})[sid]
    after = svc.sched.slot_of[sid]
    for s in [sid] + others[:LM_KW["n_slots"] // 2]:
        svc.close(s)
    return {"tokens": got, "before": before, "after": after}


def _spec(world: int, out: dict) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_bundle
    from repro_torch.sessions import LMSessionService
    from repro_torch.sessions.spec import ngram_drafter

    bundle = build_bundle(get_config("olmo-1b").smoke().replace(
        act_dtype="float32", **TINY), "cpu")
    params = bundle.init(torch.Generator().manual_seed(1))
    lm = lambda mesh=None, **kw: LMSessionService(  # noqa: E731
        bundle, params, **LM_KW, max_sessions=32, mesh=mesh, **kw)
    plain = lm()
    streams = {}
    for p in spec_prompts():
        sid = plain.open_session(p)
        streams[int(p[0])] = (p, plain.decode({sid: 15})[sid])
        plain.close(sid)
    drafters = {"oracle": lambda: _oracle(streams), "ngram": ngram_drafter}
    for name, dims in SPEC_MESHES[world].items():
        mesh = make_mesh(dims, ("data", "model"), device_type="cpu")
        for verify in ("scan", "parallel"):
            for dname, make in drafters.items():
                out[("spec", name, verify, dname)] = _spec_run(
                    lm(mesh, device_counters=True), make(), verify)
                if name == next(iter(SPEC_MESHES[world])):
                    out[("spec", "plain", verify, dname)] = _spec_run(
                        lm(device_counters=True), make(), verify)
            out[("park", name, verify)] = _spec_park(lm(mesh), verify, True)
    for verify in ("scan", "parallel"):
        out[("park", "plain", verify)] = _spec_park(lm(), verify, True)
        out[("park", "never", verify)] = _spec_park(lm(), verify, False)


# ---------------------------------------------------------------------------
# launch/train.py --mesh
# ---------------------------------------------------------------------------

def _launch(outdir: str, out: dict) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils.trees import tree_leaves

    a, b = os.path.join(outdir, "ckpt_a"), os.path.join(outdir, "ckpt_b")
    state, hist = train.main(TRAIN_ARGS + ["--mesh", "2x2", "--ckpt-dir", a])
    out["train_hist"] = hist
    out["train_params"] = [_np(p) for p in tree_leaves(state.params)]
    out["train_placements"] = [repr(p.placements)
                               for p in tree_leaves(state.params)]
    if dist.get_rank() == 0:  # killed after step 2: its checkpoint survives
        shutil.copytree(os.path.join(a, "step_000000000002"),
                        os.path.join(b, "step_000000000002"))
    dist.barrier()
    again, hist2 = train.main(TRAIN_ARGS + ["--mesh", "2x2", "--ckpt-dir",
                                            b])
    out["resumed_hist"] = hist2
    out["resumed_params"] = [_np(p) for p in tree_leaves(again.params)]
    # int8 error feedback of each rank's gradient blocks
    _, out["compressed_hist"] = train.main(TRAIN_ARGS + ["--mesh", "2x2",
                                                         "--compress-grads"])
    # the same runs in fp32 activations (no bf16 rounding for AdamW to
    # turn into steps of either sign), and the unsharded launcher
    fp32 = lambda arch: get_config(arch).replace(act_dtype="float32")
    for tag, cfg_of in (("bf16", get_config), ("fp32", fp32)):
        train.get_config = cfg_of
        try:
            if tag == "fp32":
                st, out["fp32_hist"] = train.main(TRAIN_ARGS + ["--mesh",
                                                                "2x2"])
                out["fp32_params"] = [_np(p) for p in tree_leaves(st.params)]
            if dist.get_rank() == 0:
                st, out[f"bare_{tag}_hist"] = train.main(TRAIN_ARGS)
                out[f"bare_{tag}_params"] = [_np(p) for p in
                                             tree_leaves(st.params)]
        finally:
            train.get_config = get_config


def rank_main(rank: int, world: int, rdv: str, outdir: str,
              jax_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=120))
    out: dict = {"rank": rank, "world": world}
    try:
        if world == 4:
            _cells(jax_dir, out)
            _launch(outdir, out)
        _spec(world, out)
        with open(os.path.join(outdir, f"w{world}_r{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's side
# ---------------------------------------------------------------------------

def jax_main(outdir: str) -> None:
    """The reference's unsharded functions on every cell (its params
    written for the ranks), and its ``Trainer`` over the launcher's run:
    the port launcher's seeded params, its optimizer and its data."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as j_get_config
    from repro.data import lm_batch as j_lm_batch
    from repro.models import build_bundle as j_build_bundle
    from repro.training import TrainConfig as JTrainConfig
    from repro.training import Trainer as JTrainer
    from repro.training import optim as jo
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle

    res = {}
    for i, (cell, (arch, kind)) in enumerate(CELLS.items()):
        cfg = cell_cfg(cell, j_get_config)
        jb = j_build_bundle(cfg)
        params = jb.init(jax.random.key(i))
        np.savez(os.path.join(outdir, f"{cell}.npz"),
                 **flat(jax.tree.map(np.asarray, params)))
        inputs = cell_inputs(cell, cfg)
        got = {}
        if kind == "train":
            batch = {k: jnp.asarray(v) for k, v in inputs.items()}
            (loss, _), grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
                params, batch)
            got["loss"] = np.asarray(loss, np.float32)
            got.update({f"grad/{k}": np.asarray(v, np.float32)
                        for k, v in flat(grads).items()})
        else:
            cache = jb.empty_cache(B, S_MAX)
            dec = jax.jit(jb.decode_fn)
            for j in range(STEPS):
                logits, cache = dec(params, cache, {
                    "tokens": jnp.asarray(inputs["tokens"][:, j:j + 1]),
                    "pos": jnp.int32(j)})
                got[f"logits/{j}"] = np.asarray(logits, np.float32)
            got.update({f"cache/{k}": np.asarray(v, np.float32)
                        for k, v in flat(cache).items()})
        res[cell] = got

    # the launcher's run: olmo-1b smoke, seed 0, AdamW warmup-cosine; in
    # its bf16 activations and in fp32
    cfg = get_config("olmo-1b").smoke()
    tparams = build_bundle(cfg, "cpu").init(
        torch.Generator("cpu").manual_seed(0))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    steps, lr = 3, 3e-3
    for key, over in (("train", {}), ("train_fp32",
                                      {"act_dtype": "float32"})):
        jb = j_build_bundle(j_get_config("olmo-1b").smoke().replace(**over))
        state, hist = JTrainer(
            jb.loss_fn, jax.tree.map(jnp.array, jparams),
            JTrainConfig(steps=steps, log_every=10),
            lambda s: {k: jnp.asarray(v) for k, v in
                       j_lm_batch(s, 8, 32, cfg.vocab_size).items()},
            optimizer=jo.adamw(jo.warmup_cosine(lr, steps // 10,
                                                steps))).run()
        res[key] = {"hist": hist,
                    "params": [np.asarray(p, np.float32)
                               for p in jax.tree.leaves(state.params)],
                    "init": [np.asarray(p, np.float32)
                             for p in jax.tree.leaves(jparams)]}
    with open(os.path.join(outdir, "jax.pkl"), "wb") as f:
        pickle.dump(res, f)
