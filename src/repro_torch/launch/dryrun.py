"""Multi-pod dry-run launcher, the port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 2x2 --smoke \\
        --arch olmo-1b --shape train_4k --device cpu --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k        # the 16 x 16 production mesh

Runs the train, prefill and decode steps of every ``ASSIGNED`` arch
(``--arch``/``--shape`` pick one) once, laid out on a 16 x 16 ``(data,
model)`` mesh (2 x 16 x 16 ``(pod, data, model)`` with ``--multi-pod``,
or ``--mesh``), and writes one JSON record a cell with the reference's
keys.  The world is a fake process group (``FakeStore``, backend
``"fake"``) of the mesh's size in this one process, seen from rank 0:
its collectives move nothing and return at once.  The params, the
optimizer state, the batch and the cache are fake tensors
(``FakeTensorMode``): shapes, dtypes and a device, no storage, so
nothing is allocated and no kernel runs, on the card or anywhere; the
dry-run is the one entry point that never touches a card.  They are
placed as the reference places them: the params by ``param_pspecs``, the
optimizer state by ``train_state_pspecs``, the batch by ``batch_pspecs``
and the cache by ``cache_pspecs``, and the step runs once under
``shard_ctx``, so the models' ``constrain`` sites act.

The record:
  * ``cost_analysis_flops_raw``: ``FlopCounterMode`` over rank 0's local
    ops (its blocks of every product);
  * ``cost_analysis_bytes_raw``: the bytes of every op's local inputs and
    outputs, summed over every dispatched op: an eager step materializes
    each op's result, where XLA fuses ops and reads and writes fewer
    bytes, so this number is larger than the reference's;
  * ``memory_analysis``: ``argument_size_in_bytes`` and
    ``output_size_in_bytes``, the bytes of rank 0's local shards of the
    step's inputs and outputs; ``temp_size_in_bytes``, the peak of the
    bytes the step itself allocated on rank 0 (``MemTracker`` over the
    fake local tensors: its temporaries and the outputs live at that
    peak, the arguments, allocated before, not), where the reference
    reports its compiled program's scratch (a second run of the step,
    alone under the tracker);
  * ``collective_*``: ``utils/hlo.collective_bytes`` of the collectives
    rank 0 issued (``CollectiveRecorder``);
  * ``lower_s``: the seconds the recorded step took on fake tensors;
    ``compile_s`` and ``hlo_chars`` are 0: nothing is compiled and no
    HLO exists;
  * the analytic fields from ``launch/analytic.count_cell``.

Importing the module touches no process group and sets no environment
variable (the reference's ``XLA_FLAGS`` lines have no twin): ``main``
makes the fake world.  ``--device`` (default ``cuda``) is the device the
fake tensors name.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED, LONG_CONTEXT_ARCHS, SHAPES, get_config
from repro_torch.kernels.dispatch import require_device
from repro_torch.launch.analytic import count_cell
from repro_torch.launch.mesh import n_chips
from repro_torch.launch.specs import (
    batch_pspecs,
    cache_pspecs,
    named,
    place_tree,
    train_state_pspecs,
)
from repro_torch.models import build_bundle
from repro_torch.models.params import ParamDef, map_defs
from repro_torch.sharding.ctx import shard_ctx
from repro_torch.sharding.rules import DEFAULT_RULES, P, map_specs, param_pspecs
from repro_torch.training import TrainState, make_train_step
from repro_torch.training.optim import AdamState, adamw
from repro_torch.utils.hlo import (
    CollectiveRecorder,
    collective_bytes,
    parse_cost_analysis,
)
from repro_torch.utils.trees import tree_map

# --- named experiments: the reference's hillclimb levers -------------------
# Each experiment = (rules overrides, config overrides).
EXPERIMENTS = {
    "baseline": ({}, {}),
    # no sequence-parallel activations (ablation: SP off)
    "no_sp": ({"seq_act": None}, {}),
    # save matmul outputs instead of full remat
    "remat_dots": ({}, {"remat_policy": "dots"}),
    # larger loss chunk (fewer loop iterations, bigger live logits)
    "logit_chunk_2k": ({}, {"logit_chunk": 2048}),
    # both remat_dots and no_sp
    "remat_dots_no_sp": ({"seq_act": None}, {"remat_policy": "dots"}),
    # ablation: materialized-scores attention instead of flash-chunked
    "dense_attn": ({}, {"attn_chunk_threshold": 1 << 30}),
    # no FSDP: params sharded over model (TP) only
    "no_fsdp": ({"embed": None}, {}),
    # serving: bf16 params (2x fewer weight bytes; decode is weight-bound)
    "serve_bf16": ({}, {}),
    # serving: bf16 + no FSDP (no per-step param all-gather at decode)
    "serve_bf16_no_fsdp": ({"embed": None}, {}),
    # hybrid/mamba: replicate the mamba projections and shard the
    # sequence over `model` instead of TP
    "mamba_seqshard": ({"ffn": None, "heads": None, "attn_out": None}, {}),
    # MLA decode with weight absorption + serving dtype/layout
    "mla_absorb_serve": ({"embed": None}, {"mla_absorb": True}),
}

_SERVE_DTYPE = {"serve_bf16": 2, "serve_bf16_no_fsdp": 2,
                "mla_absorb_serve": 2}


def _cast_param_defs(defs, dtype):
    """Every fp32 ParamDef as ``dtype`` (2: bf16)."""
    to = torch.bfloat16 if dtype == 2 else dtype

    def cast(d):
        if d.dtype == torch.float32:
            return ParamDef(d.shape, d.axes, d.init, to, d.scale)
        return d

    return map_defs(cast, defs)


class _OpBytes(TorchDispatchMode):
    """The bytes of every dispatched op's tensor inputs and outputs (a
    DTensor's local shard)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += _bytes([args, kwargs or {}, out])
        return out


def _bytes(tree) -> int:
    """Local bytes of every tensor in ``tree`` (lists, tuples, dicts)."""
    if isinstance(tree, torch.Tensor):
        t = getattr(tree, "_local_tensor", tree)
        return t.numel() * t.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return 0


def _fake(spec_tree, device):
    """A fake tensor of each leaf's shape and dtype on ``device``."""
    return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device=device), spec_tree)


def _run_cell(cfg, bundle, s, mesh, resolved, device):
    """(inputs, outputs) of one step of kind ``s.kind`` on placed fake
    tensors; the caller records around it."""
    pspecs = param_pspecs(bundle.param_defs, resolved, mesh)
    aparams = map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                             device="meta"),
                       bundle.param_defs)
    params = place_tree(named(mesh, pspecs), _fake(aparams, device))
    ispecs = bundle.input_specs(s.name)
    batch = _fake(ispecs, device)
    bspecs = batch_pspecs(cfg, ispecs, mesh)
    if s.kind == "train":
        opt = adamw(1e-4)
        accum = max(1, cfg.train_microbatch)
        step_fn = make_train_step(bundle.loss_fn, opt, grad_accum=accum)
        if accum > 1:  # batch leaves become (accum, B/accum, ...)
            batch = tree_map(lambda x: x.reshape(
                (accum, x.shape[0] // accum) + tuple(x.shape[1:])), batch)
            bspecs = map_specs(lambda p: P(None, *p), bspecs)
        batch = place_tree(named(mesh, bspecs), batch)
        aopt = opt[0](aparams)
        st_specs = train_state_pspecs(pspecs, aopt)
        i32 = torch.zeros((), dtype=torch.int32, device=device)
        full = TrainState(params, AdamState(i32, _fake(aopt.mu, device),
                                            _fake(aopt.nu, device)),
                          {}, {}, i32)
        state = TrainState(
            params,
            place_tree(named(mesh, st_specs.opt_state), full.opt_state),
            {}, {}, place_tree(named(mesh, st_specs.step), i32))
        inputs = (state, batch)
        return inputs, step_fn(state, batch)
    batch = place_tree(named(mesh, bspecs), batch)
    if s.kind == "prefill":
        inputs = (params, batch)
        return inputs, bundle.prefill_fn(params, batch)
    acache = bundle.cache_specs(s.global_batch, s.seq_len)
    cspecs = cache_pspecs(cfg, acache, mesh)
    cache = place_tree(named(mesh, cspecs), _fake(acache, device))
    inputs = (params, cache, batch)
    return inputs, bundle.decode_fn(params, cache, batch)


def lower_cell(arch: str, shape_name: str, mesh, *, exp: str = "baseline",
               verbose: bool = True, smoke: bool = False,
               device: str = "cuda"):
    """Run one (arch x shape) cell once on placed fake tensors over
    ``mesh``; return the roofline record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    rules_over, cfg_over = EXPERIMENTS[exp]
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if cfg_over:
        cfg = cfg.replace(**cfg_over)
    bundle = build_bundle(cfg, device)
    param_bytes = _SERVE_DTYPE.get(exp, 4)
    if param_bytes != 4:
        bundle.param_defs = _cast_param_defs(bundle.param_defs, param_bytes)
    s = SHAPES[shape_name]
    rules = dict(DEFAULT_RULES)
    rules.update(rules_over)
    from torch.distributed._tools.mem_tracker import MemTracker

    coll, nbytes = CollectiveRecorder(), _OpBytes()
    flops, mem_tracker = FlopCounterMode(display=False), MemTracker()
    grad = torch.enable_grad if s.kind == "train" else torch.no_grad
    with FakeTensorMode(allow_non_fake_inputs=False), \
            shard_ctx(mesh, rules) as resolved:
        t0 = time.time()
        with grad(), flops, coll, nbytes:
            inputs, outputs = _run_cell(cfg, bundle, s, mesh, resolved,
                                        device)
        t_run = time.time() - t0
        mem = {"argument_size_in_bytes": _bytes(inputs),
               "output_size_in_bytes": _bytes(outputs)}
        # the peak in a run of its own: the tracker's mode beside the
        # recorders changes which collectives DTensor issues
        with grad(), mem_tracker:
            _run_cell(cfg, bundle, s, mesh, resolved, device)
        peak = mem_tracker.get_tracker_snapshot("peak")
        mem["temp_size_in_bytes"] = sum(int(d["Total"])
                                        for d in peak.values())

    cost = parse_cost_analysis(flops.get_total_flops())
    cb = collective_bytes(coll.records)
    ana = count_cell(cfg, bundle.param_defs, shape_name,
                     param_bytes=param_bytes)
    rec = {
        "arch": arch, "shape": shape_name, "exp": exp,
        "mesh": [mesh.size(i) for i in range(mesh.ndim)],
        "axes": list(mesh.mesh_dim_names),
        "n_chips": n_chips(mesh),
        "kind": s.kind, "seq_len": s.seq_len, "global_batch": s.global_batch,
        "cost_analysis_flops_raw": cost.get("flops", 0.0),
        "cost_analysis_bytes_raw": float(nbytes.total),
        "flops_global_analytic": ana.flops_global,
        "bytes_global_analytic": ana.bytes_global,
        "model_flops": ana.model_flops,
        "n_params": ana.n_params,
        "n_params_active": ana.n_params_active,
        "collective_bytes_per_device": cb["total"],
        "collective_by_type": cb["by_type"],
        "collective_count": cb["count"],
        "memory_analysis": mem,
        "lower_s": round(t_run, 2), "compile_s": 0.0,
        "hlo_chars": 0,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} ({exp}) on {rec['mesh']}: "
              f"flops(analytic,global)={rec['flops_global_analytic']:.3e} "
              f"coll/dev={rec['collective_bytes_per_device']:.3e} "
              f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB "
              f"(step on fake tensors {t_run:.0f}s)", flush=True)
    return rec


def cell_path(out_dir, arch, shape, mesh_tag, exp):
    return os.path.join(out_dir, f"{mesh_tag}__{arch}__{shape}__{exp}.json")


def fake_mesh(dims: tuple, axes: tuple, device: str):
    """A ``DeviceMesh`` of ``dims`` over a fake world of their product,
    made here (rank 0): no card is bound, nothing is sent."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = math.prod(dims)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return init_device_mesh(device, dims, mesh_dim_names=axes)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run launcher")
    ap.add_argument("--arch", default=None,
                    help="arch id (default: all assigned)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="override mesh, e.g. 2x2 (axes data,model) for tests")
    ap.add_argument("--exp", default="baseline", choices=sorted(EXPERIMENTS))
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (CI sharding test, not the real "
                         "dry-run)")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors name (cuda or cpu)")
    args = ap.parse_args(argv)
    require_device(args.device)

    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        axes = ("pod", "data", "model")[-len(dims):]
        mesh_tag = "x".join(map(str, dims))
    else:
        dims = (2, 16, 16) if args.multi_pod else (16, 16)
        axes = ("pod", "data", "model") if args.multi_pod \
            else ("data", "model")
        mesh_tag = "pod2x16x16" if args.multi_pod else "pod16x16"
    mesh = fake_mesh(dims, axes, args.device)

    archs = [args.arch] if args.arch else [c.name for c in ASSIGNED]
    shapes = [args.shape] if args.shape else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                print(f"[dryrun] SKIP {arch} x long_500k "
                      f"(full-attention arch)", flush=True)
                continue
            path = cell_path(args.out, arch, shape, mesh_tag, args.exp)
            if os.path.exists(path) and not args.force:
                print(f"[dryrun] cached {path}", flush=True)
                continue
            try:
                rec = lower_cell(arch, shape, mesh, exp=args.exp,
                                 smoke=args.smoke, device=args.device)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}", flush=True)
        raise SystemExit(1)
    print("[dryrun] all cells OK", flush=True)


if __name__ == "__main__":
    main()
