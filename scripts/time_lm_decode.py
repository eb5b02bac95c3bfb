"""Time the port's unsharded LM decode on the card: one tree against another.

    python scripts/time_lm_decode.py --src build/parent/src --tag parent
    python scripts/time_lm_decode.py --src src --tag change

olmo-1b at full width and depth on seeded random weights (baked to bf16),
served by ``LMServer`` as ``chip_smoke.py``'s lm phase serves it: 8 lanes,
``seq_cap`` 1,024, prompts of 37-300 tokens, 64 greedy tokens first.  Then
it times, with CUDA events around each call (which returns host tokens):

  * ``t1_ms``: a T=1 dispatch over the 8 lanes (p50 of 20), a token a lane;
  * ``t16_ms``: a token in T=16 dispatches (p50 of 5, divided by 16);
  * ``spec_ms``: a speculative ``step(4)`` over the 8 lanes (K = 4, scan
    mode, the n-gram drafter, ``device_counters=True``), p50 of 20.

``--src`` is the ``src`` directory of the tree to time (its
``repro_torch`` is imported), so two commits are compared in one call on
one card: run parent, change, change, parent.  Prints the card's name and
power limit and one JSON line a run.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SLOTS, SEQ_CAP, T_CHUNK, PREFILL_CHUNK = 8, 1024, 16, 64
PROMPT_LEN, WARM_GEN, TIMED, SPEC_K = (37, 300), 64, 20, 4


def event_ms(fn, n: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=Path("src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--seed", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.src.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_lm_decode: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_bundle
    from repro_torch.models.transformer import bake_lm_params
    from repro_torch.serving import LMServer, ServeConfig

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    bundle = build_bundle(cfg, dev)
    params = bake_lm_params(bundle.init(
        torch.Generator(device=dev).manual_seed(args.seed)), cfg)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(
        PROMPT_LEN[0], PROMPT_LEN[1] + 1))).astype(np.int32)
        for _ in range(SLOTS)]

    def server(**kw):
        srv = LMServer(bundle, params, ServeConfig(
            max_batch=SLOTS, seq_cap=SEQ_CAP, decode_chunk=T_CHUNK,
            prefill_chunk=PREFILL_CHUNK, **kw),
            device_counters=bool(kw.get("speculative")))
        sids = [srv.open_session(p) for p in prompts]
        srv.step(WARM_GEN)
        torch.cuda.synchronize()
        return srv, sids

    t0 = time.perf_counter()
    srv, sids = server()
    t1 = event_ms(lambda: srv.push({s: 1 for s in sids}), TIMED)
    t16 = event_ms(lambda: srv.push({s: T_CHUNK for s in sids}),
                   TIMED // 4) / T_CHUNK
    del srv
    spec, sids = server(speculative=SPEC_K)
    spec_ms = event_ms(lambda: spec.step(SPEC_K), TIMED)
    del spec
    print(json.dumps({
        "tag": args.tag, "package": str(Path(repro_torch.__file__).parent),
        "t1_ms": t1, "t16_ms": t16, "spec_ms": spec_ms,
        "seconds": time.perf_counter() - t0, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
