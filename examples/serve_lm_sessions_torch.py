"""LM sessions on the PyTorch port: many more requests than slots, on one
fixed grid.  The twin of ``examples/serve_lm_sessions.py``:

  * chunked prefill: ``open_session`` feeds the prompt through multi-token
    cached steps in power-of-two chunks (the recurrent families, RWKV and
    the zamba hybrid, feed it token by token in the first decode instead:
    their chunk forms are not bit for bit the steps);
  * chunked multi-token decode: one dispatch advances every pushed session
    by up to t_chunk greedy tokens;
  * speculative decode: the n-gram self-drafter proposes K tokens per lane
    and one dispatch verifies them (``repro_torch.sessions.spec``); the
    scan mode is bit-identical to plain decode for any drafter (on the
    recurrent families through the alive-masked verify scan, which rolls
    their state back by value), the parallel mode verifies all K+1
    positions in one multi-token step (pure-KV families only);
  * oversubscription: opening more sessions than slots parks an idle one
    to a host blob truncated to its position (O(pos) bytes);
  * bit-identical resume, spill to disk and restore into a fresh service;
  * the async serving plane: concurrent clients batched into shared
    dispatches.

``--config`` picks the model: olmo-1b (GQA, dense), deepseek-v2-lite-16b
(MLA attention, MoE FFN), rwkv6-1.6b (recurrent wkv state), zamba2-1.2b
(Mamba2 layers and a shared attention block), internvl2-76b (patch
embeddings in front of the text) or seamless-m4t-large-v2 (an encoder
over frame embeddings, cross attention in the decoder), all cut narrow
and shallow, seeded random weights.  The last two first run the bundle's
prefill over seeded patch or frame embeddings and enroll a 5-way 1-shot
head through ``adapt`` over their ``embed_fn``; sessions take token
prompts (seamless's cross K/V stay zero there, as in the reference).
It runs on the card; ``--device cpu`` runs the same code on the CPU.

    PYTHONPATH=src python examples/serve_lm_sessions_torch.py
    PYTHONPATH=src python examples/serve_lm_sessions_torch.py \\
        --config deepseek-v2-lite-16b --speculative 4 --device cpu
    PYTHONPATH=src python examples/serve_lm_sessions_torch.py \\
        --config zamba2-1.2b --device cpu
    PYTHONPATH=src python examples/serve_lm_sessions_torch.py \\
        --config seamless-m4t-large-v2 --device cpu
"""

import argparse
import asyncio
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.protonet import adapt
from repro_torch.models import build_bundle
from repro_torch.obs import MetricsRegistry
from repro_torch.serving import ServingPlane
from repro_torch.sessions import (
    LMSessionService,
    SpeculativeDecoder,
    ngram_drafter,
    parked_bytes,
)
from repro_torch.utils.trees import tree_leaves

CONFIGS = ("olmo-1b", "deepseek-v2-lite-16b", "rwkv6-1.6b", "zamba2-1.2b",
           "internvl2-76b", "seamless-m4t-large-v2")
VOCAB = 64


def front_end(bundle, params, rng):
    """The bundle's own front end: one prefill over seeded patch or frame
    embeddings (the reference's stubs for InternViT and the speech
    encoder's input), and a 5-way 1-shot head enrolled through ``adapt``
    over ``embed_fn``."""
    cfg, dev = bundle.cfg, bundle.device
    key, n = ("patches", cfg.n_patches) if cfg.family == "vlm" \
        else ("frames", 40)
    emb = torch.from_numpy(rng.normal(size=(5, n, cfg.d_model)).astype(
        np.float32)).to(dev, torch.bfloat16)
    toks = torch.from_numpy(rng.integers(0, VOCAB, (5, 6)).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        logits, cache = bundle.prefill_fn(params, {key: emb[:1],
                                                   "tokens": toks[:1]})
        w, b = adapt(bundle.embed_fn, params, {key: emb, "tokens": toks},
                     torch.arange(5, device=dev), 5, 1)
    print(f"== front end: {n} {key} + 6 tokens ==")
    print(f"   prefill logits {tuple(logits.shape)}, argmax "
          f"{int(logits.argmax())}; cache leaves "
          f"{[tuple(t.shape) for t in tree_leaves(cache)]}")
    print(f"   5-way 1-shot head from embed_fn: W {tuple(w.shape)}, "
          f"b {[round(float(x), 2) for x in b]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=CONFIGS, default="olmo-1b")
    ap.add_argument("--speculative", type=int, default=4, metavar="K",
                    help="draft length of the speculative decode (>= 1)")
    ap.add_argument("--verify", choices=("scan", "parallel"),
                    default="scan")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.config).smoke().replace(
        n_layers=2, d_model=32, d_ff=64, vocab_size=VOCAB, rwkv_head_dim=16)
    bundle = build_bundle(cfg, args.device)
    dev = bundle.device
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    print(f"{cfg.name} (cut to {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'the CPU'}")

    if cfg.family in ("vlm", "audio"):
        front_end(bundle, params, np.random.default_rng(1))

    def service():
        # 2 slots, up to 6 live sessions: churn by construction
        return LMSessionService(bundle, params, n_slots=2, seq_cap=96,
                                t_chunk=16, max_sessions=6)

    svc = service()
    print("== chunked prefill + chunked decode ==")
    rng = np.random.default_rng(0)
    d0 = svc.dispatches
    a = svc.open_session(rng.integers(0, VOCAB, size=33).astype(np.int32))
    if svc.parallel_safe:
        print(f"   33-token prompt chunk-prefilled in {svc.dispatches - d0} "
              "dispatches (power-of-two chunks)")
    else:
        print("   a cache leaf without a sequence axis (recurrent state, "
              "cross K/V): the 33-token prompt is fed token by token by "
              "the first decode")
    b = svc.open_session(rng.integers(0, VOCAB, size=3).astype(np.int32))
    d0 = svc.dispatches
    out = svc.push({a: 24, b: 24})
    print(f"   2 sessions x 24 tokens in {svc.dispatches - d0} dispatches "
          f"(vs {24 + (0 if svc.parallel_safe else 33 - 1)} per-token)")
    print(f"   a: {out[a][:8]}...  b: {out[b][:8]}...")

    print(f"== speculative decode ({args.verify}): draft "
          f"{args.speculative}, verify in one dispatch ==")
    spec = SpeculativeDecoder(svc, ngram_drafter(), k=args.speculative,
                              verify=args.verify)
    d0 = svc.dispatches
    more = spec.decode({a: 16, b: 16})
    print(f"   16 more tokens each in {svc.dispatches - d0} dispatches, "
          f"acceptance={spec.acceptance_rate:.2f}")
    if args.verify == "scan":  # the plain stream, continued
        twin = service()
        ta = twin.open_session(np.asarray(svc.sessions[a].prompt))
        assert twin.decode({ta: 40})[ta] == svc.outputs[a]
        print("   bit-identical to plain greedy decode")
    assert len(more[a]) == len(more[b]) == 16

    print("== oversubscription: the grid parks, sessions never notice ==")
    c = svc.open_session(rng.integers(0, VOCAB, size=4).astype(np.int32))
    parked = [s for s in (a, b) if svc.poll(s)["state"] == "parked"]
    blob = parked_bytes(svc.parking[parked[0]])
    print(f"   opened a 3rd session on a 2-slot grid -> session "
          f"{parked[0]} parked ({blob} host bytes: KV rows up to its "
          "position, leaves without a sequence axis whole)")
    svc.decode({c: 8})
    resumed = svc.decode({parked[0]: 8})[parked[0]]
    print(f"   resumed {parked[0]} bit-identically: {resumed[:8]}")

    print("== spill to disk, restore into a fresh service ==")
    with tempfile.TemporaryDirectory() as d:
        path = svc.spill_parking(f"{d}/lm_lot.npz", include_bound=True)
        fresh = service()
        restored = fresh.restore_parking(path)
        tail = fresh.decode({restored[0]: 4})[restored[0]]
        print(f"   restored sessions {restored}; session {restored[0]} "
              f"continued with {tail}")
    print(f"   stats: {svc.stats()['evictions']} evictions, "
          f"{svc.stats()['dispatches']} dispatches total")

    print("== async serving plane: concurrent clients, batched dispatches ==")

    async def plane_demo():
        worker = service()

        async def client(tenant, n):
            psid = await plane.open_session(
                rng.integers(0, VOCAB, size=2).astype(np.int32),
                tenant=tenant)
            toks = await plane.push(psid, n)
            await plane.close(psid)
            return toks

        async with ServingPlane(worker, metrics=MetricsRegistry()) as plane:
            d0 = worker.dispatches
            streams = await asyncio.gather(client("alice", 8),
                                           client("bob", 8))
            print(f"   2 concurrent clients x 8 tokens in "
                  f"{worker.dispatches - d0} shared dispatches: "
                  f"{[s[:4] for s in streams]}...")

    asyncio.run(plane_demo())
    print("done.")


if __name__ == "__main__":
    main()
