"""Batched serving engines: the LM server and the TCN streaming server.

The port of ``repro/serving/engine.py``.  Both keep a fixed batch shape and
move requests on and off slots between steps.

``LMServer`` wraps ``sessions/lm.LMSessionService`` (every LM family the
port builds: per-lane positions, chunked decode dispatches, chunked
prefill where every cache leaf is position-indexed, park/resume, seq_cap
retirement) behind the historical ``add_request``/``step``/``outputs``/
``finish`` surface.  ``ServeConfig`` sizes it: the paper's dual mode maps
to a full batch ("throughput") or a quarter of it ("low-power").  By
default ``max_sessions`` equals the batch, so admission beyond the grid
raises (back-pressure); a larger ``max_sessions`` oversubscribes the grid
with eviction to the host parking lot.  ``speculative=K > 0`` decodes
through ``sessions/spec.SpeculativeDecoder`` (K-token self-drafts per lane,
verified in one dispatch; ``spec_verify`` "scan" is bit-identical to plain
greedy decode, "parallel" is the throughput mode of the pure-KV families).

``TCNStreamServer`` wraps
``sessions/service.StreamSessionService``: one session per stream, all
advanced by the service's fused tick (one ``tcn_chunk`` launch per tick of
up to ``t_chunk`` samples), the paper's KWS deployment.  Use the service
directly for tenants, park/resume and session churn.

It exposes the ``sessions.SessionService`` surface (open_session / push /
park / resume / close / poll / enroll / metrics / stats) by delegation, so
it can sit behind the serving plane or be driven directly.  The historical
spellings — ``push(x_t)`` with one (n_streams, C_in) array, and
``push_chunk(x)`` — remain as shims that warn with ``DeprecationWarning``
naming the protocol call to use.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from repro_torch.sessions.lm import LMSessionService
from repro_torch.sessions.service import StreamSessionService
from repro_torch.sessions.spec import SpeculativeDecoder


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new} (the SessionService "
                  f"protocol surface)", DeprecationWarning, stacklevel=3)


@dataclass
class ServeConfig:
    max_batch: int = 8
    seq_cap: int = 512
    mode: str = "throughput"  # throughput | low-power (paper's dual mode)
    decode_chunk: int = 16    # token-chunk bucket cap per dispatch
    max_sessions: int | None = None  # None: == batch (no oversubscription)
    prefill_chunk: int = 64   # chunked prefill cap (0 = scan prefill)
    speculative: int = 0      # draft length K (0 = plain greedy decode)
    spec_verify: str = "scan"  # scan (exact) | parallel (throughput)

    def effective_batch(self):
        return self.max_batch if self.mode == "throughput" \
            else max(1, self.max_batch // 4)


class LMServer:
    """Historical add_request/step/outputs/finish surface over the LM
    session service, on the bundle's device.  One ``step()`` greedily
    decodes one token for every live request; a request's first step also
    consumes its pending prompt token.  ``service_kw`` passes further
    ``LMSessionService`` options (``paged``, ``block_len``, ``n_blocks``,
    ``metrics``, ``tracer``, ``device_counters``).  With
    ``cfg.speculative`` > 0, ``step(n)`` decodes through ``self.spec``, a
    ``SpeculativeDecoder`` with the n-gram self-drafter (a 1-token step
    has no room to draft and takes the plain scan inside it)."""

    def __init__(self, bundle, params, cfg: ServeConfig, **service_kw):
        self.bundle = bundle
        self.cfg = cfg
        B = cfg.effective_batch()
        self.service = LMSessionService(
            bundle, params, n_slots=B, seq_cap=cfg.seq_cap,
            t_chunk=cfg.decode_chunk, prefill_chunk=cfg.prefill_chunk,
            max_sessions=B if cfg.max_sessions is None else cfg.max_sessions,
            **service_kw)
        self.spec = (SpeculativeDecoder(self.service, k=cfg.speculative,
                                        verify=cfg.spec_verify)
                     if cfg.speculative else None)

    # historical mirrors -----------------------------------------------------
    @property
    def sched(self):
        return self.service.sched

    @property
    def outputs(self) -> dict[int, list[int]]:
        return self.service.outputs

    @property
    def pos(self) -> np.ndarray:
        """Per-slot int32 positions (0 for free slots)."""
        return self.service.slot_pos

    # protocol surface (sessions.SessionService, by delegation) --------------
    @property
    def n_slots(self) -> int:
        return self.service.n_slots

    def open_session(self, prompt) -> int:
        """Admit a request.  With the default ``max_sessions`` (== batch)
        a full grid raises AdmissionError (a RuntimeError); with a larger
        cap the LRU idle request is parked to host memory instead and
        resumes bit-identically."""
        return self.service.open_session(prompt)

    def push(self, work: dict[int, int]) -> dict[int, list[int]]:
        """{sid: token budget} -> {sid: new tokens} (protocol hot path)."""
        return self.service.push(work)

    def park(self, sid: int) -> None:
        self.service.park(sid)

    def resume(self, sid: int) -> None:
        self.service.resume(sid)

    def close(self, sid: int) -> None:
        self.service.close(sid)

    def poll(self, sid: int) -> dict:
        return self.service.poll(sid)

    def enroll(self, sid: int, shots, **kwargs) -> int:
        return self.service.enroll(sid, shots, **kwargs)

    def stats(self) -> dict:
        return self.service.stats()

    def metrics(self) -> dict:
        return self.service.metrics()

    # deprecation shims (historical spellings) -------------------------------
    def add_request(self, prompt) -> int:
        _deprecated("LMServer.add_request(prompt)",
                    "LMServer.open_session(prompt)")
        return self.open_session(prompt)

    def finish(self, rid: int):
        _deprecated("LMServer.finish(rid)", "LMServer.close(rid)")
        self.close(rid)

    def step(self, n: int = 1):
        """Advance every live request, bound and parked, by ``n`` greedy
        tokens, in waves of at most ``n_slots`` requests (a wave's binds
        may park the previous wave's LRU members; every request still
        gains exactly n tokens), speculatively with ``cfg.speculative``."""
        live = [sid for sid, s in sorted(self.service.sessions.items())
                if not s.done]
        decode = self.spec.decode if self.spec is not None \
            else self.service.decode
        for i in range(0, len(live), self.service.n_slots):
            decode({sid: n for sid in live[i:i + self.service.n_slots]})


class TCNStreamServer:
    """Real-time streaming classification over ``n_streams`` lockstep
    sessions on an ``n_streams``-slot grid (no churn, no tenants), on the
    bundle's device."""

    def __init__(self, bundle, params, bn_state, n_streams: int,
                 quantize: bool = False, t_chunk: int = 16):
        self.cfg = bundle.cfg
        self.service = StreamSessionService(
            bundle, params, bn_state, n_slots=n_streams, max_tenants=1,
            max_ways=1, quantize=quantize, t_chunk=t_chunk)
        self.sids = [self.service.open_session() for _ in range(n_streams)]

    # protocol surface (sessions.SessionService, by delegation) --------------
    @property
    def n_slots(self) -> int:
        return self.service.n_slots

    def open_session(self, *args, **kwargs) -> int:
        return self.service.open_session(*args, **kwargs)

    def push(self, work):
        """Protocol hot path: ``{sid: (T, C_in) chunk} -> {sid: result}``.

        The historical array spelling, ``push(x_t)`` with one
        ``(n_streams, C_in)`` sample per stream returning stacked
        ``(emb, logits)``, still works as a deprecation shim."""
        if isinstance(work, dict):
            return self.service.push(work)
        _deprecated("TCNStreamServer.push(x_t array)",
                    "TCNStreamServer.push({sid: chunk})")
        return self._stacked(np.asarray(work))

    def park(self, sid: int) -> None:
        self.service.park(sid)

    def resume(self, sid: int) -> None:
        self.service.resume(sid)

    def close(self, sid: int) -> None:
        self.service.close(sid)

    def poll(self, sid: int) -> dict:
        return self.service.poll(sid)

    def enroll(self, sid: int, shots, **kwargs) -> int:
        return self.service.enroll(sid, shots, **kwargs)

    def stats(self) -> dict:
        return self.service.stats()

    def metrics(self) -> dict:
        return self.service.metrics()

    # deprecation shims (historical spellings) -------------------------------
    def push_chunk(self, x: np.ndarray):
        """x: (n_streams, T, C_in), a time chunk per stream.  Returns
        per-sample (embs (n_streams, T, V), logits (n_streams, T, n)), the
        same bits as T one-sample pushes in ceil(T / t_chunk) ticks."""
        _deprecated("TCNStreamServer.push_chunk(x)",
                    "TCNStreamServer.push({sid: chunk})")
        return self._stacked(np.asarray(x))

    def _stacked(self, x: np.ndarray):
        res = self.service.push({sid: x[i] for i, sid in enumerate(self.sids)})
        return (np.stack([res[sid]["emb"] for sid in self.sids]),
                np.stack([res[sid]["logits"] for sid in self.sids]))
