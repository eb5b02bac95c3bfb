"""Multi-tenant streaming KWS (the PyTorch/CUDA port): the paper's per-user
deployment story as a service.  Two tenants enroll *different*
personalized keyword sets (FSL through the shared TCN embedder) while
their audio streams are live; a burst of extra sessions then overflows
the slot grid, forcing LRU eviction to the host parking lot and a
bit-exact resume, checked against a service that never evicted alice.

The KWS preset at full width (4 blocks of 24 channels, k=3, 28 MFCC
inputs) on the fused kernel path (``RuntimeConfig.resolve(fused=True)``:
BN folded at construction, one ``tcn_chunk`` launch a tick, the strip
entry of ``tcn_block`` for enrollment); ``run(fused=False)`` runs the
per-step executor.  The twin of ``examples/serve_multitenant.py``.

    PYTHONPATH=src python examples/serve_multitenant_torch.py
    PYTHONPATH=src python examples/serve_multitenant_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import RuntimeConfig, get_config
from repro_torch.data import KeywordAudio
from repro_torch.models import build_bundle
from repro_torch.models.tcn import tcn_empty_state
from repro_torch.sessions import StreamSessionService

ALICE_CLASSES, BOB_CLASSES, BOB_NEW_CLASS = (0, 1), (2, 3), 4


def make_service(device="cuda", fused: bool = True, params=None):
    """(service, audio): 4 slots, 4 tenants of 4 ways, 12 sessions, over
    ``params`` (seeded when None)."""
    cfg = get_config("chameleon-tcn-kws")
    bundle = build_bundle(cfg, device)
    if params is None:
        params = bundle.init(torch.Generator().manual_seed(0))
    svc = StreamSessionService(bundle, params,
                               tcn_empty_state(cfg, bundle.device),
                               n_slots=4, max_tenants=4, max_ways=4,
                               max_sessions=12,
                               runtime=RuntimeConfig.resolve(fused=fused))
    return svc, KeywordAudio(n_classes=6, seed=0)


def stream_clip(svc, sid, frames):
    """Push a whole (T, C_in) clip as ONE ragged chunk (ceil(T / t_chunk)
    ticks) and return the end-of-chunk view of the result."""
    res = svc.push({sid: frames})[sid]
    tl = res["tenant_logits"]
    return {"pred": res["pred"], "step": res["step"],
            "emb": res["emb"][-1], "logits": res["logits"][-1],
            "tenant_logits": None if tl is None else tl[-1]}


def enroll(svc, audio, sid, classes) -> None:
    for cls in classes:
        svc.enroll_shots(sid, audio.mfcc(audio.sample(cls, 3, seed=cls)))


def queries(audio):
    """alice's class-0 query and bob's class-3 query, (63, 28) each."""
    return (audio.mfcc(audio.sample(0, 1, seed=50))[0],
            audio.mfcc(audio.sample(3, 1, seed=51))[0])


def run(device="cuda", fused: bool = True, params=None) -> dict:
    """Drive the scenario; returns the results ``main`` prints: ``alice``,
    ``bob``, ``bob_new`` (end-of-clip views), ``alice_resumed`` (the push
    after her eviction), ``n_ways`` and ``state`` per step name, the
    service's ``stats``, alice's result on a service that never evicted
    her (``control``) and whether the two are the same bits
    (``resume_exact``), and both services' ``dispatches``."""
    svc, audio = make_service(device, fused, params)
    out = {"n_ways": {}, "state": {}}
    alice = svc.open_session(tenant=None)
    bob = svc.open_session(tenant=None)
    enroll(svc, audio, alice, ALICE_CLASSES)
    enroll(svc, audio, bob, BOB_CLASSES)
    qa, qb = queries(audio)
    out["alice"] = stream_clip(svc, alice, qa)
    out["bob"] = stream_clip(svc, bob, qb)
    out["n_ways"]["alice"] = svc.poll(alice)["n_ways"]
    out["n_ways"]["bob"] = svc.poll(bob)["n_ways"]

    # continual learning: bob appends a way mid-stream
    enroll(svc, audio, bob, (BOB_NEW_CLASS,))
    out["bob_new"] = stream_clip(
        svc, bob, audio.mfcc(audio.sample(BOB_NEW_CLASS, 1, seed=52))[0])
    out["n_ways"]["bob_new"] = svc.poll(bob)["n_ways"]

    # slot pressure: 6 more sessions on a 4-slot grid evict alice
    burst = [svc.open_session() for _ in range(6)]
    svc.push({sid: qa[:10] for sid in burst[:4]})  # one chunked tick
    out["stats"] = svc.stats()
    out["state"]["burst"] = svc.poll(alice)["state"]
    out["alice_resumed"] = svc.push({alice: qa[0]})[alice]
    out["state"]["resumed"] = svc.poll(alice)["state"]
    for sid in burst:
        svc.close(sid)
    out["control"], ctl_dispatches = alice_control(device, fused, params)
    out["resume_exact"] = same_bits(out["alice_resumed"], out["control"])
    out["dispatches"] = {"service": svc.dispatches,
                         "control": ctl_dispatches}
    return out


def alice_control(device="cuda", fused: bool = True, params=None):
    """alice's pushes on a service of the same geometry that never evicts
    her (no bob, no burst): (her last result, the service's dispatches)."""
    svc, audio = make_service(device, fused, params)
    alice = svc.open_session(tenant=None)
    enroll(svc, audio, alice, ALICE_CLASSES)
    qa, _ = queries(audio)
    svc.push({alice: qa})
    return svc.push({alice: qa[0]})[alice], svc.dispatches


def same_bits(a: dict, b: dict) -> bool:
    return a["pred"] == b["pred"] and a["step"] == b["step"] and all(
        np.array_equal(a[k], b[k]) for k in ("emb", "logits",
                                             "tenant_logits"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    ra, rb, rb2 = out["alice"], out["bob"], out["bob_new"]
    print("== two tenants enroll different keyword sets, streams live ==")
    print(f"   alice heard class 0 -> way {ra['pred']} of "
          f"{out['n_ways']['alice']} (tenant logits "
          f"{np.round(ra['tenant_logits'][:2], 1)})")
    print(f"   bob   heard class 3 -> way {rb['pred']} of "
          f"{out['n_ways']['bob']} (tenant logits "
          f"{np.round(rb['tenant_logits'][:2], 1)})")
    print("== continual learning: bob appends a way mid-stream ==")
    print(f"   bob now has {out['n_ways']['bob_new']} ways; class 4 query -> "
          f"way {rb2['pred']}")
    print("== slot pressure: 6 more sessions on a 4-slot grid ==")
    print(f"   stats: {out['stats']}")
    print(f"   alice is {out['state']['burst']} (evicted to the parking lot)")
    ra2 = out["alice_resumed"]
    print(f"   alice resumed at step {ra2['step']}, state "
          f"{out['state']['resumed']}, pred way {ra2['pred']}; equal bit "
          f"for bit to a service that never evicted her: "
          f"{out['resume_exact']}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
