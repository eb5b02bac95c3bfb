"""Serving example (the PyTorch/CUDA port): (a) real-time streaming KWS
through the session service (the fused path: one ``tcn_chunk`` launch a
tick), and (b) batched LM serving with slot reuse through ``LMServer``
(each ``step()`` one dispatch for every live request, prefill folded
into the first decode chunk).  For multi-tenant personalization,
eviction and park/resume see ``examples/serve_multitenant_torch.py`` (TCN)
and ``examples/serve_lm_sessions_torch.py`` (LM).  The twin of
``examples/serve_stream.py``.

    PYTHONPATH=src python examples/serve_stream_torch.py
    PYTHONPATH=src python examples/serve_stream_torch.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import RuntimeConfig, get_config
from repro_torch.data import KeywordAudio
from repro_torch.models import build_bundle
from repro_torch.models.tcn import tcn_empty_state
from repro_torch.serving import LMServer, ServeConfig
from repro_torch.sessions import StreamSessionService

# the LM half's requests: (name, prompt); r3 reuses r1's slot
LM_PROMPTS = {"r1": [1, 2, 3], "r2": [9, 8], "r3": [5]}
LM_STEPS = 8


def stream_kws(device="cuda", params=None) -> dict:
    """Two sessions stream a 63-frame MFCC clip each (the KWS preset at
    full width) in one ragged push: ceil(63 / 16) = 4 ticks.  Returns the
    end-of-clip ``logits`` (2, n_classes), ``frames`` and ``dispatches``."""
    cfg = get_config("chameleon-tcn-kws")
    bundle = build_bundle(cfg, device)
    if params is None:
        params = bundle.init(torch.Generator().manual_seed(0))
    svc = StreamSessionService(bundle, params,
                               tcn_empty_state(cfg, bundle.device),
                               n_slots=2, max_tenants=1, t_chunk=16,
                               runtime=RuntimeConfig.resolve(fused=True))
    audio = KeywordAudio(n_classes=4, seed=0)
    clips = np.concatenate([audio.sample(0, 1, seed=1),
                            audio.sample(2, 1, seed=2)])
    frames = audio.mfcc(clips)  # (2, 63, 28)
    streams = [svc.open_session() for _ in range(2)]
    res = svc.push_audio({sid: frames[i] for i, sid in enumerate(streams)})
    return {"logits": np.stack([res[sid]["logits"][-1] for sid in streams]),
            "frames": frames.shape, "dispatches": svc.dispatches}


def lm_server(device="cuda", params=None) -> LMServer:
    """A tiny olmo-1b cut (2 layers, d_model 32, d_ff 64, vocab 64,
    head_dim 16) behind ``LMServer(max_batch=4, seq_cap=48)``; its params
    drawn from seed 1 on the device when None."""
    cfg = get_config("olmo-1b").smoke().replace(
        n_layers=2, d_model=32, d_ff=64, vocab_size=64, head_dim=16)
    bundle = build_bundle(cfg, device)
    if params is None:
        params = bundle.init(torch.Generator(bundle.device).manual_seed(1))
    return LMServer(bundle, params, ServeConfig(max_batch=4, seq_cap=48))


def serve_lm(lm: LMServer) -> dict:
    """r1 and r2 decode ``LM_STEPS`` steps together; r1 finishes and r3
    takes its slot for one step.  Returns each request's tokens."""
    sid = {n: lm.open_session(np.array(LM_PROMPTS[n], np.int32))
           for n in ("r1", "r2")}
    for _ in range(LM_STEPS):
        lm.step()
    out = {n: list(lm.outputs[s]) for n, s in sid.items()}
    lm.close(sid["r1"])
    r3 = lm.open_session(np.array(LM_PROMPTS["r3"], np.int32))
    lm.step()
    out["r3"] = list(lm.outputs[r3])
    return out


def run(device="cuda", params=None, lm_params=None) -> dict:
    """Both halves: ``stream_kws``'s dict and ``serve_lm``'s tokens under
    ``"lm"``."""
    return {**stream_kws(device, params),
            "lm": serve_lm(lm_server(device, lm_params))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.device)
    print("== streaming KWS (ring-buffer TCN, MFCC frontend, chunked) ==")
    print(f"   streamed {out['frames'][1]} frames x2 sessions in "
          f"{out['dispatches']} dispatches -> end-of-clip logits "
          f"{out['logits'].shape}, argmax {out['logits'].argmax(-1)}")
    print("== batched LM serving (slot reuse) ==")
    print(f"   req r1: {out['lm']['r1']}")
    print(f"   req r2: {out['lm']['r2']}")
    print(f"   slot reused for req r3: {out['lm']['r3']}")
    print("done.")
    return out


if __name__ == "__main__":
    main()
