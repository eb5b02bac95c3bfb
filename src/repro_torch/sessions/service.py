"""Request-loop façades over the streaming slot grid.

The port of ``repro/sessions/service.py``, dense-bank half:

``SlotGridService`` is the service-agnostic core: a fixed slot grid,
admission control and LRU/cost eviction (sessions/scheduler), a host-side
parking lot of packed slot columns, and power-of-two chunk buckets.
Concrete services supply ``_pack``/``_unpack``/``_reset``.

``StreamSessionService`` is the TCN streaming façade:

    open_session / push_audio / enroll_shots / poll / park / resume / close

``push_audio`` takes ragged per-session chunks {sid: (t_i, C_in)}, pads
them onto the (S, T_chunk) grid and advances every pushed session per
tick; short chunks and absent sessions stay frozen.  ``fused=True`` (the
default, so a service on the card runs the ``tcn_block`` kernel) bakes BN
and the log2 weight quantization once at construction
(models/tcn.bake_stream_params) and runs each tick through one
``tcn_block`` kernel call per block; ``fused=False`` runs the plain
per-step executor, the reference the fused path is tested against.  Enrollment embeds shots through ``make_fused_forward`` on a
fused service (the ``tcn_block`` kernel again) and through the eval-mode
forward otherwise.  A parked session resumes bit-exactly in any free slot.

Counters are plain integers (``dispatches``, ``evictions``, ``enrolls``).
Not ported yet: the ``SessionService`` protocol verbs (``push``,
``enroll``), cost-aware eviction options, paged banks, the rehearsal
buffer, spill/restore and handoff, meshes, in-dispatch device counters,
metrics and trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.protonet import pn_logits_banked
from repro_torch.models.tcn import (
    bake_stream_params,
    make_fused_forward,
    tcn_empty_state,
)
from repro_torch.sessions.scheduler import AdmissionError, SlotScheduler
from repro_torch.sessions.state import (
    grid_init,
    grid_scan,
    make_grid_fused,
    pack_slot,
    parked_bytes,
    reset_slot,
    slot_park_bytes,
    unpack_slot,
)
from repro_torch.sessions.tenancy import (
    bank_add_class,
    bank_clear_tenant,
    bank_fc,
    bank_init,
    bank_row_bytes,
    bank_update_class,
)

NO_TENANT = -1


@dataclass
class SessionRecord:
    """Per-session host record.  ``steps == 0`` marks a fresh session,
    which gets a zeroed column instead of a parked blob."""
    steps: int = 0
    last: dict | None = None


class SlotGridService:
    """Fixed slot grid + scheduler + parking lot.  Subclasses provide
    ``_pack(slot, sid)``, ``_unpack(slot, blob)`` and ``_reset(slot)``."""

    _service_name = "grid"

    def __init__(self, n_slots: int, *, t_chunk: int = 1,
                 max_sessions: int | None = None):
        if t_chunk < 1:
            raise ValueError(f"t_chunk must be >= 1, got {t_chunk}")
        self.n_slots = n_slots
        self.t_chunk = t_chunk
        self.sched = SlotScheduler(n_slots, max_sessions)
        self.parking: dict[int, dict] = {}   # sid -> host blob
        self.sessions: dict[int, Any] = {}   # sid -> session record
        self._next_sid = 0
        self.dispatches = 0  # executor calls (one per tick)
        self.evictions = 0

    @property
    def parked_blob_bytes(self) -> int:
        return sum(parked_bytes(b) for b in self.parking.values())

    # -- state hooks (subclass responsibility) ------------------------------
    def _pack(self, slot: int, sid: int) -> dict:
        raise NotImplementedError

    def _unpack(self, slot: int, blob: dict) -> None:
        raise NotImplementedError

    def _reset(self, slot: int) -> None:
        raise NotImplementedError

    def _on_bind(self, sid: int, slot: int) -> None:
        pass

    def _on_unbind(self, slot: int) -> None:
        pass

    def _on_close(self, sid: int, sess) -> None:
        pass

    # -- lifecycle ----------------------------------------------------------
    def _alloc_sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    def _bind(self, sid: int, pinned: set[int] = frozenset()) -> int:
        slot, evicted = self.sched.bind(sid, pinned)
        if evicted is not None:
            self.parking[evicted] = self._pack(slot, evicted)
            self.evictions += 1
        if sid in self.parking:
            self._unpack(slot, self.parking.pop(sid))
        elif self.sessions[sid].steps == 0:
            self._reset(slot)
        else:  # rebinding after evicted==None cannot lose state
            raise AssertionError("bound session missing parked state")
        self._on_bind(sid, slot)
        return slot

    def park(self, sid: int) -> None:
        """Swap a session's slot column to host memory (no-op if parked)."""
        if sid not in self.sessions:
            raise KeyError(f"unknown session {sid}")
        slot = self.sched.park(sid)
        if slot is not None:
            self.parking[sid] = self._pack(slot, sid)
            self._on_unbind(slot)

    def resume(self, sid: int) -> None:
        """Bind a parked session back onto a slot without advancing it
        (``push`` also resumes lazily, so this only prepays the unpack)."""
        if sid not in self.sessions:
            raise KeyError(f"unknown session {sid}")
        self.sched.touch(sid)
        if not self.sched.is_bound(sid):
            self._bind(sid)

    def close(self, sid: int) -> None:
        slot = self.sched.release(sid)
        if slot is not None:
            self._on_unbind(slot)
        self.parking.pop(sid, None)
        sess = self.sessions.pop(sid)
        self._on_close(sid, sess)

    def _touch_and_bind(self, sids) -> None:
        """Pin this tick's sessions, then bind any that are parked."""
        pinned = set(sids)
        for sid in sids:
            if sid not in self.sessions:
                raise KeyError(f"unknown session {sid}")
            self.sched.touch(sid)
            if not self.sched.is_bound(sid):
                self._bind(sid, pinned)

    def _tick_len(self, remaining: int) -> int:
        """Full T_chunk while enough work remains, else the next power of
        two — log2(T_chunk)+1 tick shapes instead of one per length."""
        if remaining >= self.t_chunk:
            return self.t_chunk
        n = 1
        while n < remaining:
            n <<= 1
        return min(n, self.t_chunk)

    # -- introspection ------------------------------------------------------
    def _slot_state_bytes(self) -> int:
        raise NotImplementedError

    def _extra_stats(self) -> dict:
        return {}

    def stats(self) -> dict:
        return {
            "service": self._service_name,
            "n_slots": self.n_slots,
            "t_chunk": self.t_chunk,
            "bound": len(self.sched.slot_of),
            "parked": len(self.parking),
            "live_sessions": self.sched.live_sessions,
            "evictions": self.evictions,
            "dispatches": self.dispatches,
            "parked_blob_bytes": self.parked_blob_bytes,
            "slot_state_bytes": self._slot_state_bytes(),
            **self._extra_stats(),
        }


@dataclass
class _Session(SessionRecord):
    tenant: int = NO_TENANT
    dedicated: bool = False  # tenant row was created for this session


class StreamSessionService(SlotGridService):
    """Multi-tenant streaming TCN service over a fixed slot grid, on the
    bundle's device."""

    _service_name = "tcn"

    def __init__(self, bundle, params, bn_state=None, *, n_slots: int = 8,
                 max_tenants: int = 8, max_ways: int = 8,
                 max_sessions: int | None = None, quantize: bool = False,
                 t_chunk: int = 16, fused: bool = True,
                 kernel_backend: str | None = None):
        super().__init__(n_slots, t_chunk=t_chunk, max_sessions=max_sessions)
        cfg = bundle.cfg
        dev = bundle.device
        self.cfg = cfg
        self.device = dev
        self.max_ways = max_ways
        self.quantize = quantize
        self.fused = fused
        self.enrolls = 0
        bn_state = bn_state if bn_state is not None \
            else tcn_empty_state(cfg, dev)
        self._fused_params = None
        if self.fused:
            params, bn_state, self._fused_params = bake_stream_params(
                params, bn_state, cfg, quantize=quantize)
            self._fused_chunk = make_grid_fused(
                cfg, quantize=quantize, backend=kernel_backend, device=dev)
            fwd = make_fused_forward(cfg, quantize=quantize,
                                     backend=kernel_backend, device=dev)
            self._embed = lambda x: fwd(self._fused_params, x)[0]
        else:
            self._embed = lambda x: bundle.embed_fn(
                params, {"x": x}, state=bn_state, quantize=quantize)
        self._params = params
        self._bn = bn_state
        self.states = grid_init(cfg, n_slots, dev)
        self.bank = bank_init(max_tenants, max_ways, cfg.embed_dim, dev)
        self.tenant_of_slot = np.full(n_slots, NO_TENANT, np.int32)
        self._free_tenants = list(range(max_tenants))
        self._tenant_ways = np.zeros(max_tenants, np.int32)  # host mirror
        # label-keyed enrollment: repeated enroll(label=...) calls fold
        # into ONE way's running mean
        self._tenant_labels: dict[int, dict] = {}

    # -- slot-column state hooks --------------------------------------------
    def _pack(self, slot: int, sid: int) -> dict:
        return pack_slot(self.states, slot, pack_u4=self.quantize,
                         act_scale=self.cfg.act_scale)

    def _unpack(self, slot: int, blob: dict) -> None:
        self.states = unpack_slot(self.states, slot, blob)

    def _reset(self, slot: int) -> None:
        self.states = reset_slot(self.states, slot)

    def _on_bind(self, sid: int, slot: int) -> None:
        self.tenant_of_slot[slot] = self.sessions[sid].tenant

    def _on_unbind(self, slot: int) -> None:
        self.tenant_of_slot[slot] = NO_TENANT

    # -- tenants ------------------------------------------------------------
    def create_tenant(self) -> int:
        if not self._free_tenants:
            raise RuntimeError("tenant bank full")
        return self._free_tenants.pop(0)

    def close_tenant(self, tenant: int) -> None:
        if any(s.tenant == tenant for s in self.sessions.values()):
            raise RuntimeError(f"tenant {tenant} still has open sessions")
        self.bank = bank_clear_tenant(self.bank, tenant)
        self._tenant_labels.pop(tenant, None)
        self._tenant_ways[tenant] = 0
        self._free_tenants.append(tenant)

    def open_session(self, tenant: int | None = NO_TENANT) -> int:
        """Admit a session.  ``tenant=None`` creates a dedicated tenant
        (freed when the session closes); ``NO_TENANT`` (default)
        classifies with the shared global head."""
        dedicated = tenant is None
        claimed = dedicated
        if dedicated:
            tenant = self.create_tenant()
        elif tenant != NO_TENANT:
            if not 0 <= tenant < len(self._tenant_ways):
                raise ValueError(f"tenant {tenant} out of range "
                                 f"[0, {len(self._tenant_ways)})")
            if tenant in self._free_tenants:  # claim an uncreated row
                self._free_tenants.remove(tenant)
                claimed = True
        sid = self._alloc_sid()
        try:
            self.sched.admit(sid)  # may raise AdmissionError (back-pressure)
        except AdmissionError:
            if claimed:  # don't leak the tenant row on refused admission
                self._free_tenants.insert(0, tenant)
            raise
        self.sessions[sid] = _Session(tenant=tenant, dedicated=dedicated)
        self._bind(sid)
        return sid

    def _on_close(self, sid: int, sess) -> None:
        # a dedicated tenant row dies with its last session; if others
        # share the row, ownership passes to one of them
        if sess.dedicated:
            sharers = [s for s in self.sessions.values()
                       if s.tenant == sess.tenant]
            if sharers:
                sharers[0].dedicated = True
            else:
                self.close_tenant(sess.tenant)

    # -- the hot path -------------------------------------------------------
    def _banked(self, emb: torch.Tensor, tenant_ids: torch.Tensor):
        """Tenant logits (S, T, max_ways), one time step at a time so a
        step's bits do not depend on the tick length."""
        w, b = bank_fc(self.bank)
        return torch.stack([pn_logits_banked(emb[:, i].contiguous(), w, b,
                                             tenant_ids)
                            for i in range(emb.shape[1])], dim=1)

    def push_audio(self, chunks: dict[int, Any]) -> dict[int, dict]:
        """Advance sessions by ragged time chunks.

        chunks: {sid: x}, x a (t_i, C_in) chunk or a single (C_in,) sample.
        Returns {sid: result}: per-sample emb (t_i, V), logits (t_i, n),
        tenant_logits (t_i, ways) | None, the end-of-chunk ``pred`` and the
        cumulative ``step``; a (C_in,) sample gets the last row only."""
        if len(chunks) > self.n_slots:
            raise ValueError(
                f"{len(chunks)} sessions pushed but only {self.n_slots} "
                "slots; split the push or grow the grid")
        c_in = self.cfg.tcn_in_channels
        arrs, scalar = {}, {}
        for sid, v in chunks.items():
            a = np.asarray(v, np.float32)
            scalar[sid] = a.ndim == 1
            if a.ndim == 1:
                a = a[None]
            if a.ndim != 2 or a.shape[1] != c_in:
                raise ValueError(
                    f"session {sid}: expected (C_in,) or (t, C_in) with "
                    f"C_in={c_in}, got shape {np.asarray(v).shape}")
            if a.shape[0] == 0:
                raise ValueError(f"session {sid}: empty chunk")
            arrs[sid] = a
        self._touch_and_bind(chunks)

        slot_of = {sid: self.sched.slot_of[sid] for sid in arrs}
        lens = {sid: a.shape[0] for sid, a in arrs.items()}
        max_len = max(lens.values())
        pieces = {sid: [] for sid in arrs}
        tenant_ids = torch.tensor(self.tenant_of_slot).to(self.device)
        off = 0
        while off < max_len:
            t_pad = self._tick_len(max_len - off)
            x = np.zeros((self.n_slots, t_pad, c_in), np.float32)
            tick_lens = np.zeros(self.n_slots, np.int32)
            for sid, a in arrs.items():
                seg = a[off:off + t_pad]
                if seg.shape[0]:
                    x[slot_of[sid], :seg.shape[0]] = seg
                    tick_lens[slot_of[sid]] = seg.shape[0]
            xt = torch.from_numpy(x).to(self.device)
            lt = torch.from_numpy(tick_lens).to(self.device)
            if self.fused:
                self.states, emb, logits = self._fused_chunk(
                    self._fused_params, self.states, xt, lt)
            else:
                valid = torch.arange(t_pad, device=self.device)[None, :] \
                    < lt[:, None]
                self.states, emb, logits = grid_scan(
                    self._params, self._bn, self.cfg, self.states, xt, valid,
                    quantize=self.quantize)
            tlogits = self._banked(emb, tenant_ids)
            emb, logits, tlogits = (emb.cpu().numpy(), logits.cpu().numpy(),
                                    tlogits.cpu().numpy())
            self.dispatches += 1
            for sid in arrs:
                n = min(max(lens[sid] - off, 0), t_pad)
                if n:
                    s = slot_of[sid]
                    pieces[sid].append(
                        (emb[s, :n], logits[s, :n], tlogits[s, :n]))
            off += t_pad

        out = {}
        for sid in arrs:
            sess = self.sessions[sid]
            sess.steps += lens[sid]
            e, lg, tl = (np.concatenate([p[i] for p in pieces[sid]])
                         for i in range(3))
            personalized = (sess.tenant != NO_TENANT
                            and self._tenant_ways[sess.tenant] > 0)
            head = tl if personalized else lg
            if scalar[sid]:
                e, lg, tl = e[-1], lg[-1], tl[-1]
            res = {"emb": e, "logits": lg,
                   "tenant_logits": tl if personalized else None,
                   "pred": int(head[-1].argmax()), "step": sess.steps}
            sess.last = res
            out[sid] = res
        return out

    # -- FSL / CL enrollment (live, mid-stream) -----------------------------
    def enroll_shots(self, sid: int, shots, *, embedded: bool = False,
                     way: int | None = None, label=None) -> int:
        """Fold k shots into the session's tenant bank; returns the way.
        shots: (k, T, C_in) raw clips, or (k, V) embeddings when
        ``embedded``.  ``way=None, label=None`` appends a new way; ``way=j``
        refines way j; ``label=x`` appends on the first enroll of x and
        refines on later ones.  The next push classifies against it."""
        tenant = self.sessions[sid].tenant
        if tenant == NO_TENANT:
            raise ValueError("session has no tenant; open with tenant=None "
                             "or an explicit tenant id to personalize")
        x = torch.tensor(np.asarray(shots, np.float32)).to(self.device)
        emb = x if embedded else self._embed(x)
        if label is not None:
            if way is not None:
                raise ValueError("pass way= or label=, not both")
            way = self._tenant_labels.setdefault(tenant, {}).get(label)
        if way is None:
            if self._tenant_ways[tenant] >= self.max_ways:
                raise RuntimeError(
                    f"tenant {tenant} at max_ways={self.max_ways}")
            self.bank = bank_add_class(self.bank, tenant, emb)
            way = int(self._tenant_ways[tenant])
            self._tenant_ways[tenant] += 1
            if label is not None:
                self._tenant_labels[tenant][label] = way
        else:
            if not 0 <= way < self._tenant_ways[tenant]:
                raise ValueError(
                    f"way {way} not enrolled for tenant {tenant} "
                    f"({self._tenant_ways[tenant]} ways); omit way= to "
                    "enroll")
            self.bank = bank_update_class(self.bank, tenant, way, emb)
        self.enrolls += 1
        return way

    # -- introspection ------------------------------------------------------
    def poll(self, sid: int) -> dict:
        sess = self.sessions[sid]
        return {
            "state": "active" if self.sched.is_bound(sid) else "parked",
            "slot": self.sched.slot_of.get(sid),
            "tenant": None if sess.tenant == NO_TENANT else sess.tenant,
            "n_ways": int(self._tenant_ways[sess.tenant])
                      if sess.tenant != NO_TENANT else 0,
            "steps": sess.steps,
            "last": sess.last,
        }

    def _slot_state_bytes(self) -> int:
        return slot_park_bytes(self.cfg, quantize=self.quantize)

    def _extra_stats(self) -> dict:
        return {"tenant_row_bytes": bank_row_bytes(self.bank),
                "fused": self.fused, "enrolls": self.enrolls}
