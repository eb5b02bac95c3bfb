"""Batched serving engine: the TCN streaming server.

The port of ``repro/serving/engine.py``, TCN half (``LMServer`` and
``ServeConfig`` wait for the LM family).  ``TCNStreamServer`` wraps
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

import numpy as np

from repro_torch.sessions.service import StreamSessionService


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new} (the SessionService "
                  f"protocol surface)", DeprecationWarning, stacklevel=3)


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
