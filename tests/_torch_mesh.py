"""Rank workers of tests/test_torch_multidevice.py.

Each world size is one spawn of gloo ranks on the CPU (one torch thread
each, rendezvous through a file, a process-group timeout).  Every rank
runs the same scenarios through the port's services with ``mesh=`` and
through unsharded twins, and pickles what it saw to
``<out>/w<world>_r<rank>.pkl``; the test asserts in the parent.  The JAX
package's side runs in a subprocess of its own with four host devices
(``jax_main``), and writes its params and results for the ranks and the
parent to read.  Nothing here imports jax at module level: the ranks
never import it.

The scenarios use only the service verbs both packages share, so one
function drives either package's service.
"""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta

import numpy as np

SMALL = dict(tcn_channels=(8, 8), tcn_kernel=3, tcn_in_channels=2,
             embed_dim=12, n_classes=4)
TINY = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=64, head_dim=16)
N_SLOTS, MAX_TENANTS = 8, 8
TCN_KW = dict(n_slots=N_SLOTS, max_tenants=MAX_TENANTS, max_ways=4,
              fused=True)
LM_KW = dict(n_slots=N_SLOTS, seq_cap=48, t_chunk=8)
MESHES = {"4x1": (4, 1), "1x4": (1, 4), "2x2": (2, 2)}


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def spawn(fn, world: int, args: tuple, timeout: float) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes;
    raise if a rank fails, and terminate every rank if they have not all
    ended after ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world,) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


# ---------------------------------------------------------------------------
# scenarios (either package's services)
# ---------------------------------------------------------------------------

def tcn_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 22, size=N_SLOTS)
    x = rng.normal(size=(N_SLOTS, 21, 2)).astype(np.float32)
    more = rng.normal(size=(N_SLOTS + 1, 13, 2)).astype(np.float32)
    shots = rng.normal(size=(3, 12, 2)).astype(np.float32)
    return lens, x, more, shots


def _res(r: dict) -> tuple:
    return (r["emb"], r["logits"], r["tenant_logits"], r["pred"], r["step"])


def tcn_scenario(svc, seed: int = 0) -> list:
    """8 sessions of 8 tenants, enrollment (a new way, a refined way, a
    label), two ragged pushes; returns every session's results."""
    lens, x, more, shots = tcn_inputs(seed)
    sids = [svc.open_session(tenant=i % MAX_TENANTS) for i in range(N_SLOTS)]
    svc.enroll_shots(sids[1], shots)
    svc.enroll_shots(sids[1], shots[:2], way=0)
    svc.enroll_shots(sids[2], shots[1:], label="yes")
    svc.enroll_shots(sids[6], shots[:1])
    out = []
    r = svc.push_audio({sid: x[i, :lens[i]] for i, sid in enumerate(sids)})
    out += [_res(r[s]) for s in sids]
    r = svc.push_audio({sid: more[i] for i, sid in enumerate(sids)})
    out += [_res(r[s]) for s in sids]
    return out


def tcn_park_scenario(svc, seed: int = 1) -> dict:
    """Park the session on slot 0, let a newcomer take that slot, then push
    the parked one again: it resumes in the slot of the least recently
    used session (slot 4, another rank's at mesh (4, 1))."""
    lens, x, more, _ = tcn_inputs(seed)
    sids = [svc.open_session(tenant=i % MAX_TENANTS) for i in range(N_SLOTS)]
    svc.push_audio({sid: x[i, :lens[i]] for i, sid in enumerate(sids)})
    first = sids[0]
    before = svc.sched.slot_of[first]
    svc.park(first)
    new = svc.open_session()
    work = {sid: more[i] for i, sid in enumerate(sids) if i not in (0, 4)}
    svc.push_audio({**work, new: more[N_SLOTS]})
    r = svc.push_audio({first: more[0]})
    return {"before": before, "after": svc.sched.slot_of[first],
            "result": _res(r[first])}


def tcn_uninterrupted(svc, seed: int = 1) -> tuple:
    """The parked session's stream, never parked."""
    lens, x, more, _ = tcn_inputs(seed)
    sid = svc.open_session(tenant=0)
    svc.push_audio({sid: x[0, :lens[0]]})
    return _res(svc.push_audio({sid: more[0]})[sid])


def tcn_spill_scenario(make, path: str, seed: int = 2) -> list:
    """Spill every session of one service (bound ones parked first),
    restore the file into a fresh service, push on."""
    lens, x, more, _ = tcn_inputs(seed)
    svc = make()
    sids = [svc.open_session(tenant=i % MAX_TENANTS) for i in range(N_SLOTS)]
    svc.push_audio({sid: x[i, :lens[i]] for i, sid in enumerate(sids)})
    svc.spill_parking(path, include_bound=True)
    fresh = make()
    assert fresh.restore_parking(path) == sids
    r = fresh.push_audio({sid: more[i] for i, sid in enumerate(sids)})
    return [_res(r[s]) for s in sids]


def lm_prompts(seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=rng.integers(1, 9)).astype(np.int32)
            for _ in range(N_SLOTS)]


def lm_scenario(svc, waves: int = 3) -> list:
    return _lm_waves(svc, [svc.open_session(p) for p in lm_prompts()],
                     waves)


def _lm_waves(svc, sids: list, waves: int = 3) -> list:
    out = []
    for _ in range(waves):  # greedy feedback crosses dispatches
        r = svc.decode({s: 8 for s in sids})
        out.append([r[s] for s in sids])
    return out


def lm_logits_scenario(svc, bundle) -> tuple:
    """``lm_scenario`` through ``svc`` with the logits of every valid
    decode step kept: (the streams, {stream index: logits (generated, V)})
    for the streams on lanes this rank decodes.  Row g of a stream is the
    step that emitted its g-th token (position len(prompt) - 1 + g)."""
    from repro_torch.sessions.lm import make_decode_scan

    dispatches = []  # (pos, n_steps, [logits of each step]) a dispatch

    def decode_fn(params, cache, batch):
        logits, new = bundle.decode_fn(params, cache, batch)
        dispatches[-1][2].append(logits.detach().float().cpu().numpy()
                                 .copy())
        return logits, new

    scan = make_decode_scan(decode_fn, svc._batch_axes, svc._seq_axes)

    def tagged(params, cache, tok, pos, inp, n_inp, n_steps):
        dispatches.append((pos.cpu().numpy().copy(),
                           n_steps.cpu().numpy().copy(), []))
        return scan(params, cache, tok, pos, inp, n_inp, n_steps)

    svc._decode_scan = tagged
    prompts = lm_prompts()
    sids = [svc.open_session(p) for p in prompts]
    streams = _lm_waves(svc, sids)
    stream_of = {svc.sched.slot_of[sid] - svc._slot_lo: i
                 for i, sid in enumerate(sids)}  # no session moved
    rows: dict = {}
    for pos, n_steps, steps in dispatches:
        for lane, n in enumerate(n_steps):
            for j in range(int(n)):
                rows.setdefault(stream_of[lane], {})[int(pos[lane]) + j] = \
                    steps[j][lane]
    out = {}
    for i, by_pos in rows.items():
        first = len(prompts[i]) - 1
        n_gen = sum(len(w[i]) for w in streams)
        out[i] = np.stack([by_pos[first + g] for g in range(n_gen)])
    return streams, out


def lm_park_scenario(svc) -> dict:
    sids = [svc.open_session(p) for p in lm_prompts(8)]
    svc.decode({s: 5 for s in sids})
    before = svc.sched.slot_of[sids[0]]
    svc.park(sids[0])
    new = svc.open_session(np.arange(1, 6, dtype=np.int32))
    svc.decode({new: 3, **{s: 2 for i, s in enumerate(sids)
                           if i not in (0, 4)}})
    r = svc.decode({sids[0]: 6})
    return {"before": before, "after": svc.sched.slot_of[sids[0]],
            "tokens": r[sids[0]]}


def lm_uninterrupted(svc) -> list:
    sid = svc.open_session(lm_prompts(8)[0])
    svc.decode({sid: 5})
    return svc.decode({sid: 6})[sid]


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def dist_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()


def _port_setup(params_npz: str | None):
    """(tcn bundle, params, bn; lm bundle, params) on the CPU: the JAX
    package's params when ``params_npz`` is given, else seeded ones."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_bundle, build_tcn_bundle

    tb = build_tcn_bundle(get_config("chameleon-tcn").replace(**SMALL), "cpu")
    lb = build_bundle(get_config("olmo-1b").smoke().replace(
        act_dtype="float32", **TINY), "cpu")
    if params_npz is None:
        return (tb, tb.init(torch.Generator().manual_seed(0)), None, lb,
                lb.init(torch.Generator().manual_seed(1)))
    with np.load(params_npz) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflat(flat)
    return (tb, params_from_jax(tree["tcn"], "cpu"),
            params_from_jax(tree["bn"], "cpu"), lb,
            params_from_jax(tree["lm"], "cpu"))


def _local_rows(tree, axes=None) -> list:
    """Each DTensor leaf's local extent on its sharded axis (or axis 0),
    with its placements."""
    from repro_torch.utils.trees import tree_leaves

    leaves = tree_leaves(tree)
    axes = [0] * len(leaves) if axes is None else tree_leaves(axes)
    return [(int(a.to_local().shape[ax]), int(a.shape[ax]),
             repr(a.placements)) for a, ax in zip(leaves, axes)]


def _full(tree) -> list:
    from repro_torch.utils.host import to_host
    from repro_torch.utils.trees import tree_leaves

    return [to_host(a.full_tensor() if hasattr(a, "full_tensor") else a)
            for a in tree_leaves(tree)]


def _gathers(mesh) -> dict:
    """{entry: (this rank's [lo, hi) of a 12-long dim, the rows every
    rank gathered)}: ``spmd.gather`` of each rank's own rows of
    ``arange(12)``, along dims 0 and 1, for every kind of spec entry."""
    import torch

    from repro_torch.sharding import spmd

    out = {}
    for entry in ("data", "model", ("data", "model"), None):
        lo, hi = spmd.local_range(mesh, entry, 12)
        rows = torch.arange(lo, hi, dtype=torch.float32)
        out[str(entry)] = ((lo, hi), spmd.gather(rows, mesh, entry).tolist(),
                           spmd.gather(rows[None, :, None].expand(2, -1, 3),
                                       mesh, entry, dim=1)[1, :, 2].tolist())
    return out


def _world4(outdir: str, out: dict) -> None:
    from repro_torch.checkpoint.store import save
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sessions import LMSessionService, StreamSessionService

    tb, tp, tbn, lb, lp = _port_setup(None)
    meshes = {k: make_mesh(v, ("data", "model"), device_type="cpu")
              for k, v in MESHES.items()}
    tcn = lambda mesh=None, **kw: StreamSessionService(
        tb, tp, tbn, **{**TCN_KW, "t_chunk": 8, **kw}, mesh=mesh)
    out["tcn_plain"] = tcn_scenario(tcn())
    svcs = {}
    for name, mesh in meshes.items():
        svcs[name] = tcn(mesh)
        out[f"tcn_{name}"] = tcn_scenario(svcs[name])
        out[f"grid_{name}"] = _local_rows(svcs[name].states)
        out[f"bank_{name}"] = _local_rows(svcs[name].bank)
    out["tcn_4x1_t3"] = tcn_scenario(tcn(meshes["4x1"], t_chunk=3))
    out["tcn_4x1_t1"] = tcn_scenario(tcn(meshes["4x1"], t_chunk=1))
    out["tcn_paged_4x1"] = tcn_scenario(tcn(meshes["4x1"], paged_bank=True,
                                            bank_block_ways=2))
    out["tcn_paged_plain"] = tcn_scenario(tcn(paged_bank=True,
                                              bank_block_ways=2))
    out["park_4x1"] = tcn_park_scenario(tcn(meshes["4x1"]))
    out["park_plain"] = tcn_park_scenario(tcn())
    out["park_never"] = tcn_uninterrupted(tcn())
    out["spill_4x1"] = tcn_spill_scenario(lambda: tcn(meshes["4x1"]),
                                          os.path.join(outdir, "spill4.npz"))
    out["spill_plain"] = tcn_spill_scenario(
        tcn, os.path.join(outdir, f"spill_plain{dist_rank()}.npz"))
    out["slots_4x1"] = (svcs["4x1"]._slot_lo, svcs["4x1"]._slot_hi)
    out["gather_2x2"] = _gathers(meshes["2x2"])

    lm = lambda mesh=None, **kw: LMSessionService(lb, lp, **{**LM_KW, **kw},
                                                  mesh=mesh)
    lsvc = lm(meshes["4x1"])
    out["lm_4x1"] = lm_scenario(lsvc)
    out["lm_plain"] = lm_scenario(lm())
    out["lm_cache_4x1"] = _local_rows(lsvc.cache, lsvc._batch_axes)
    out["lm_2x2"] = lm_scenario(lm(meshes["2x2"]))
    out["lm_park_4x1"] = lm_park_scenario(lm(meshes["4x1"]))
    out["lm_park_plain"] = lm_park_scenario(lm())
    out["lm_never"] = lm_uninterrupted(lm())
    try:
        lm(meshes["4x1"], paged=True)
        out["paged_raises"] = None
    except ValueError as e:
        out["paged_raises"] = str(e)

    tree = {"states": svcs["4x1"].states, "bank": svcs["1x4"].bank,
            "cache": lsvc.cache}
    save(os.path.join(outdir, "ckpt4"), 1, tree)
    out["ckpt_full"] = _full(tree)
    out["ckpt_rows"] = _local_rows(tree["states"]) + _local_rows(
        tree["bank"]) + _local_rows(tree["cache"], lsvc._batch_axes)


def _restore(world: int, outdir: str, src: str, dst: str | None,
             out: dict) -> None:
    """Restore a checkpoint written at another world size under this
    world's meshes (slots over data, the bank over model), and save it
    again for the next world size."""
    from repro_torch.checkpoint.store import restore_into, save
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import named
    from repro_torch.sessions import (
        LMSessionService,
        StreamSessionService,
        bank_pspecs,
        column_pspecs,
        grid_pspecs,
    )

    tb, tp, tbn, lb, lp = _port_setup(None)
    dm = make_mesh((world, 1), ("data", "model"), device_type="cpu")
    mm = make_mesh((1, world), ("data", "model"), device_type="cpu")
    svc = StreamSessionService(tb, tp, tbn, **TCN_KW, mesh=dm)
    bsvc = StreamSessionService(tb, tp, tbn, **TCN_KW, mesh=mm)
    lsvc = LMSessionService(lb, lp, **LM_KW, mesh=dm)
    target = {"states": svc.states, "bank": bsvc.bank, "cache": lsvc.cache}
    shardings = {
        "states": named(dm, grid_pspecs(tb.cfg, dm, N_SLOTS)),
        "bank": named(mm, bank_pspecs(bsvc.bank, mm)),
        "cache": named(dm, column_pspecs(lb.cache_specs(N_SLOTS, 48),
                                         lsvc._batch_axes, dm))}
    step, tree = restore_into(os.path.join(outdir, src), target,
                              shardings=shardings)
    out["restored_step"] = step
    out["restored_full"] = _full(tree)
    out["restored_rows"] = _local_rows(tree["states"]) + _local_rows(
        tree["bank"]) + _local_rows(tree["cache"], lsvc._batch_axes)
    if dst is not None:
        save(os.path.join(outdir, dst), 2, tree)


def _world1(out: dict) -> None:
    """A one-rank mesh is the unsharded service bit for bit."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sessions import LMSessionService, StreamSessionService

    tb, tp, tbn, lb, lp = _port_setup(None)
    m = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    tsvc = StreamSessionService(tb, tp, tbn, **TCN_KW, mesh=m)
    out["one_tcn"] = tcn_scenario(tsvc)
    out["one_tcn_plain"] = tcn_scenario(StreamSessionService(
        tb, tp, tbn, **TCN_KW))
    lsvc = LMSessionService(lb, lp, **LM_KW, mesh=m)
    out["one_lm"] = lm_scenario(lsvc)
    # the sharded path, not a shortcut: slots over data, tenants over model
    out["one_entries"] = {"tcn": (tsvc._slot_entry, tsvc._tenant_entry),
                          "lm": (lsvc._slot_entry, None)}
    out["one_lm_plain"] = lm_scenario(LMSessionService(lb, lp, **LM_KW))


def _vs_jax(jax_dir: str, out: dict) -> None:
    """The JAX subprocess's scenarios on its params, through the port's
    services on the same meshes."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sessions import LMSessionService, StreamSessionService

    tb, tp, tbn, lb, lp = _port_setup(os.path.join(jax_dir, "params.npz"))
    m22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    m41 = make_mesh((4, 1), ("data", "model"), device_type="cpu")
    out["jax_tcn"] = tcn_scenario(StreamSessionService(
        tb, tp, tbn, **TCN_KW, t_chunk=8, mesh=m22))
    out["jax_lm"], out["jax_lm_logits"] = lm_logits_scenario(
        LMSessionService(lb, lp, **LM_KW, mesh=m41), lb)


def rank_main(rank: int, world: int, rdv: str, outdir: str,
              jax_dir: str | None) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=120))
    out: dict = {"rank": rank, "world": world}
    try:
        if world == 4:
            _world4(outdir, out)
            if jax_dir is not None:
                _vs_jax(jax_dir, out)
        elif world == 2:
            _restore(2, outdir, "ckpt4", "ckpt2", out)
        else:
            _restore(1, outdir, "ckpt2", None, out)
            _world1(out)
        with open(os.path.join(outdir, f"w{world}_r{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX package's side: a subprocess with four host devices
# ---------------------------------------------------------------------------

def jax_main(outdir: str) -> None:
    """The JAX package's services on 4 host devices (XLA_FLAGS set by the
    caller): the TCN scenario on a (2, 2) mesh, the LM scenario on (4, 1),
    each LM stream's per-step logits and top-2 margins from a token-by-
    token decode, and the params, written to ``outdir``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.models import build_bundle
    from repro.models.tcn import tcn_empty_state
    from repro.sessions import LMSessionService, StreamSessionService

    assert jax.device_count() == 4, jax.devices()
    tcfg = get_config("chameleon-tcn").replace(kernel_backend="ref", **SMALL)
    tb = build_bundle(tcfg)
    tp = tb.init(jax.random.key(0))
    rng = np.random.default_rng(7)
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        tcn_empty_state(tcfg))
    lcfg = get_config("olmo-1b").smoke().replace(act_dtype="float32", **TINY)
    lb = build_bundle(lcfg)
    lp = lb.init(jax.random.key(3))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    flat = _flat({"tcn": np_tree(tp), "bn": np_tree(bn), "lm": np_tree(lp)})
    np.savez(os.path.join(outdir, "params.npz"), **flat)

    m22 = make_mesh((2, 2), ("data", "model"))
    m41 = make_mesh((4, 1), ("data", "model"))
    tcn = tcn_scenario(StreamSessionService(
        tb, tp, bn, **TCN_KW, t_chunk=8, kernel_backend="ref", mesh=m22))
    lsvc = LMSessionService(lb, lp, **LM_KW, mesh=m41)
    lm = lm_scenario(lsvc)
    dec = jax.jit(lb.decode_fn)
    logits, margins = [], []
    for i, prompt in enumerate(lm_prompts()):
        toks = [t for wave in lm for t in wave[i]]
        seq = np.concatenate([prompt, toks]).astype(np.int32)
        cache = lb.empty_cache(1, LM_KW["seq_cap"])
        lg_i, m_i = [], []
        for j in range(len(seq) - 1):
            lg, cache = dec(lp, cache, {"tokens": jnp.asarray(seq[None, j:j + 1]),
                                        "pos": jnp.int32(j)})
            if j >= len(prompt) - 1:
                row = np.asarray(lg[0], np.float32)
                lg_i.append(row)
                top = np.sort(row)[-2:]
                m_i.append(float(top[1] - top[0]))
        logits.append(np.stack(lg_i))
        margins.append(m_i)
    with open(os.path.join(outdir, "jax.pkl"), "wb") as f:
        pickle.dump({"tcn": tcn, "lm": lm, "lm_logits": logits,
                     "lm_margins": margins}, f)
