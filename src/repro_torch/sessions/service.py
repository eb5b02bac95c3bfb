"""Request-loop façades over the streaming slot grid.

The port of ``repro/sessions/service.py`` (the LM service, which builds on
``SlotGridService``, is sessions/lm.py):

``SlotGridService`` is the service-agnostic core: a fixed slot grid,
admission control and LRU/cost-aware eviction (sessions/scheduler), a
host-side parking lot of packed slot columns with incremental byte
accounting, power-of-two chunk buckets, the telemetry (a metrics
registry, a tracer, per-shape dispatch latency), spill/restore of the
parking lot through checkpoint/store, and the handoff verbs the serving
plane builds on (``export_session``/``detach_session``/``adopt_session``).
Concrete services supply ``_pack``/``_unpack``/``_reset`` and the spill
meta hooks.

``StreamSessionService`` is the TCN streaming façade:

    open_session / push_audio / enroll_shots / poll / park / resume / close

with ``push = push_audio`` and ``enroll = enroll_shots``, the
``SessionService`` protocol verbs (sessions/__init__.py).  ``push_audio``
takes ragged per-session chunks {sid: (t_i, C_in)}, pads them onto the
(S, T_chunk) grid and advances every pushed session per tick; short
chunks and absent sessions stay frozen.  ``fused=True`` (the default, so
a service on the card runs the kernels; ``REPRO_TORCH_TCN_FUSED`` or
``runtime=`` set it otherwise) bakes BN and the log2 weight quantization
once at construction (models/tcn.bake_stream_params) and runs each tick's
TCN body through one ``tcn_chunk`` kernel launch; ``fused=False`` runs the
plain per-step executor, the reference the fused path is tested against.
Enrollment embeds shots through ``make_fused_forward`` on a fused service
(the ``tcn_block`` strip kernel) and through the eval-mode forward
otherwise.  A parked session resumes bit-exactly in any free slot, and
in any service of the same configuration, so a spilled lot restores into
a fresh service and a detached session continues on a peer.

Tenant banks are dense (``TenantBank``, max_tenants x max_ways rows) or,
with ``paged_bank=True``, paged (sessions/bankpool.py): way rows are
allocated a block at a time from a shared pool as a tenant enrolls, and a
tenant none of whose sessions is bound holds zero device rows (its blocks
park to host and come back on its next push or enroll).  At equal way
counts the two layouts give the same tenant logits bit for bit.  With
``rehearsal_cap > 0`` every enrolled shot is also offered to a bounded u4
rehearsal buffer (sessions/rehearsal.py) and ``rehearse_tenant`` rebuilds
a tenant's prototypes from it.  ``export_tenant``/``adopt_tenant`` move a
tenant's learned state (running sums, labels, reservoirs) between
services of either layout.

The service owns its slot grid (``self.states``): nothing outside it holds
the grid's tensors, so the fused tick updates the rings and step counters
in place (``make_grid_fused(inplace=True)``) and moves only the chunk's
new ring rows, not a copy of every ring; parking copies a slot's column
out, and resuming writes it back in place.

Telemetry: ``dispatches``/``evictions``/``enrolls`` read the service's
``MetricsRegistry`` (``metrics()`` returns its snapshot); each tick is one
sample of the ``dispatch_latency_us`` histogram of its shape, timed after
the tick's outputs reached the host (so it includes the device work), and
``device_counters=True`` adds the tick's occupancy, computed on the device
from the tick's lengths (obs/device.py).  The tracer (obs/trace.py) gets
one span per layer of a call, never one per step: a push is ``push.pack``
(checks, binds, banks made resident), ``slot_fc``, then per tick
``tick.pack``, ``dispatch`` (inside it ``upload``, the fused chunk's
``chunk`` and ``head``, ``banked``, ``gather`` on a mesh, ``readback``)
and ``tick.scatter``, then ``push.results``; an enrollment is ``enroll``
(inside it ``enroll.upload``, ``enroll.embed``, ``enroll.bank``,
``enroll.sync``).  The spans carry their counts (streams, steps, bytes,
ways, ...) as args, and ``call``: ``calls``, the service's running number
of its pushes and enrollments.  While torch.profiler records, each span
is also a ``repro_torch.<name>`` range on the profiler's clock.

``readback`` (arg ``pinned``) copies a tick's outputs to the host.  On a
card they go through one page-locked staging buffer the service owns
(utils/host.StagingBuffer): allocated at the first tick, reused by every
later one, grown only when a tick needs more bytes, kept for the service's
life; the three copies are queued on the current stream and waited for
once, inside ``readback``.  The gauge ``readback_staging_bytes`` and the
counter ``readback_staging_allocs_total`` count its bytes and
allocations.  No returned array aliases the buffer, since the next tick
overwrites it: a tick that another follows copies its slices out, and
``push.results`` concatenates each stream's.  On the CPU the outputs
already are host tensors and are returned as they are.

Passing ``mesh=`` (a ``DeviceMesh`` of launch/mesh.py, one process per
rank) shards the slot grid over the mesh's ``data`` axis and the dense
tenant bank over ``model`` (sessions/state.grid_pspecs,
sessions/tenancy.bank_pspecs): ``states`` and ``bank`` hold DTensors, a
paged pool stays whole on every rank.  Every rank makes the same calls
with the same arguments, so the host side (scheduler, parking lot,
tenant registry) is the same everywhere, and every rank returns the same
results.  A tick runs ``tcn_chunk`` on each rank's own slots; the slots'
tenant rows are gathered once a push and the per-slot outputs once a
tick.  A slot's or a tenant's owner packs it and sends the blob to every
rank; unpacking writes only where the shard lives.  On a one-rank mesh
nothing is sent and every result is the unsharded service's bit for bit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.store import load_sessions, save_sessions
from repro_torch.configs.runtime import RuntimeConfig
from repro_torch.core.protonet import pn_logits_rows
from repro_torch.models.tcn import (
    bake_stream_params,
    make_fused_forward,
    tcn_empty_state,
)
from repro_torch.obs.device import decode_occupancy, occupancy_stats
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer
from repro_torch.sessions.bankpool import PagedBankPool, paged_bank_fc
from repro_torch.sessions.rehearsal import RehearsalBuffer
from repro_torch.sessions.scheduler import AdmissionError, SlotScheduler
from repro_torch.sessions.state import (
    grid_init,
    grid_pspecs,
    grid_scan,
    make_grid_fused,
    pack_slot,
    parked_bytes,
    reset_slot,
    slot_park_bytes,
    unpack_slot,
)
from repro_torch.sessions.tenancy import (
    TenantBank,
    bank_add_class,
    bank_clear_tenant,
    bank_fc,
    bank_init,
    bank_pack_tenant,
    bank_pspecs,
    bank_row_bytes,
    bank_unpack_tenant,
    bank_update_class,
)
from repro_torch.sharding import spmd
from repro_torch.sharding.rules import map_specs
from repro_torch.utils.host import StagingBuffer

NO_TENANT = -1


@dataclass
class SessionRecord:
    """Per-session host record.  ``steps == 0`` marks a fresh session,
    which gets a zeroed column instead of a parked blob."""
    steps: int = 0
    last: dict | None = None


class SlotGridService:
    """Fixed slot grid + scheduler + parking lot + persistence.

    Subclasses provide ``_pack(slot, sid)``, ``_unpack(slot, blob)`` and
    ``_reset(slot)``, and may override the lifecycle hooks
    (``_on_bind``/``_on_unbind``/``_on_evict``/``_on_close``) and the
    spill/restore and adoption hooks."""

    _session_cls = SessionRecord
    _service_name = "grid"  # metrics/trace label; subclasses override
    # services with per-tenant state (prototype banks) set this, so the
    # serving plane forwards its routing tenant into open_session too
    tenant_aware = False

    def __init__(self, n_slots: int, *, t_chunk: int = 1,
                 max_sessions: int | None = None,
                 cost_fn: Callable[[int], float] | None = None,
                 stale_window: int = 0,
                 metrics: MetricsRegistry | None = None,
                 tracer=None, device_counters: bool | None = None,
                 runtime: RuntimeConfig | None = None):
        if t_chunk < 1:
            raise ValueError(f"t_chunk must be >= 1, got {t_chunk}")
        self.n_slots = n_slots
        self.t_chunk = t_chunk
        self.sched = SlotScheduler(n_slots, max_sessions, cost_fn=cost_fn,
                                   stale_window=stale_window)
        self.parking: dict[int, dict] = {}   # sid -> host blob
        self.sessions: dict[int, Any] = {}   # sid -> session record
        self._next_sid = 0
        # process switches: explicit kwarg > runtime/env > default
        self.runtime = runtime if runtime is not None \
            else RuntimeConfig.resolve()
        # telemetry: one registry per service unless ``metrics=`` shares
        # one; the tracer defaults to the process-global one
        self.metrics_registry = metrics if metrics is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.device_counters = bool(
            self.runtime.pick("device_counters", device_counters))
        svc = self._service_name
        reg = self.metrics_registry
        self._c_dispatches = reg.counter("dispatches_total", service=svc)
        self._c_evictions = reg.counter("evictions_total", service=svc)
        self._g_bound = reg.gauge("sessions_bound", service=svc)
        self._g_parked = reg.gauge("sessions_parked", service=svc)
        # the parking lot's host bytes, kept up to date where blobs are
        # stored and taken (summing every blob per change would cost
        # O(parked x leaves) on the bind path)
        self._g_parked_bytes = reg.gauge("parked_bytes", service=svc)
        self._parked_blob_bytes: dict[int, int] = {}  # sid -> host bytes
        self._lat_hists: dict[str, Any] = {}  # shape -> Histogram
        # a mesh's split of the slot axis: the mesh axes it is sharded
        # over (None: every rank holds every slot) and this rank's
        # [lo, hi); subclasses set the entry once their specs are known
        self.mesh = None
        self._set_slot_entry(None)

    # -- slots over a mesh ----------------------------------------------------
    def _set_slot_entry(self, entry) -> None:
        self._slot_entry = entry
        self._slot_lo, self._slot_hi = (0, self.n_slots) \
            if self._slot_entry is None \
            else spmd.local_range(self.mesh, entry, self.n_slots)

    def _holds_slot(self, slot: int) -> bool:
        return self._slot_lo <= slot < self._slot_hi

    def _from_slot(self, slot: int, fn):
        """``fn(local slot index)`` on the slot's owner, its host result
        on every rank."""
        if self._slot_entry is None:
            return fn(slot)
        src = spmd.owner(self.mesh, self._slot_entry, slot, self.n_slots)
        return spmd.from_owner(self.mesh, src,
                               lambda: fn(slot - self._slot_lo))

    def _gather_slots(self, rows):
        """Per-slot rows of this rank's slots -> every slot's, on every
        rank (one all-gather over the slot axes)."""
        return spmd.gather(rows, self.mesh, self._slot_entry)

    # -- parking-lot accounting ---------------------------------------------
    @property
    def parked_blob_bytes(self) -> int:
        """Host bytes of the parking lot (nibble-packed leaves count as
        stored)."""
        return sum(self._parked_blob_bytes.values())

    def _park_store(self, sid: int, blob) -> None:
        self.parking[sid] = blob
        self._parked_blob_bytes[sid] = parked_bytes(blob)
        self._g_parked_bytes.set(self.parked_blob_bytes)

    def _park_take(self, sid: int, default=None):
        blob = self.parking.pop(sid, default)
        if self._parked_blob_bytes.pop(sid, None) is not None:
            self._g_parked_bytes.set(self.parked_blob_bytes)
        return blob

    # -- telemetry ----------------------------------------------------------
    # the counters read and write through the registry, so
    # ``svc.dispatches`` and ``svc.metrics()["dispatches_total"]`` agree
    @property
    def dispatches(self) -> int:
        """Ticks run (one executor call each)."""
        return int(self._c_dispatches.value)

    @dispatches.setter
    def dispatches(self, v: int) -> None:
        self._c_dispatches.value = v

    @property
    def evictions(self) -> int:
        return int(self._c_evictions.value)

    @evictions.setter
    def evictions(self, v: int) -> None:
        self._c_evictions.value = v

    def metrics(self) -> dict:
        """JSON snapshot of the service's metrics registry."""
        return self.metrics_registry.snapshot()

    def _latency_hist(self, shape: str):
        h = self._lat_hists.get(shape)
        if h is None:
            h = self.metrics_registry.histogram(
                "dispatch_latency_us", service=self._service_name,
                shape=shape)
            self._lat_hists[shape] = h
        return h

    def _record_dispatch(self, seconds: float, shape: str) -> None:
        """One tick completed: count it, record its wall time in its
        shape's log2 histogram, refresh the occupancy gauges."""
        self._c_dispatches.inc()
        self._latency_hist(shape).record(seconds * 1e6)
        self._g_bound.set(len(self.sched.slot_of))
        self._g_parked.set(len(self.parking))

    def _ingest_occupancy(self, stats) -> None:
        """Fold one tick's device occupancy vector
        (obs.device.occupancy_stats) into the registry."""
        occ = decode_occupancy(stats)
        svc = self._service_name
        reg = self.metrics_registry
        reg.counter("device_live_steps_total", service=svc).inc(
            occ["live_steps"])
        reg.counter("device_masked_steps_total", service=svc).inc(
            occ["total_steps"] - occ["live_steps"])
        reg.gauge("device_lane_occupancy", service=svc).set(
            occ["lane_occupancy"])
        reg.gauge("device_pad_waste", service=svc).set(occ["pad_waste"])
        reg.gauge("device_live_step_ratio", service=svc).set(
            occ["live_step_ratio"])

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

    def _on_evict(self, sid: int, slot: int) -> None:
        """``sid`` was just packed off ``slot`` to make room for another
        session.  Distinct from ``_on_unbind`` (park/close), which fires
        when a slot goes idle: an evicted slot is re-occupied at once."""

    def _on_close(self, sid: int, sess) -> None:
        pass

    # -- lifecycle ----------------------------------------------------------
    def _alloc_sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    def open_session(self, **kw) -> int:
        """Admit a session and place it on a slot (may evict an idle one)."""
        sid = self._alloc_sid()
        self.sched.admit(sid)  # may raise AdmissionError (back-pressure)
        self.sessions[sid] = self._session_cls(**kw)
        self._bind(sid)
        return sid

    def _bind(self, sid: int, pinned: set[int] = frozenset()) -> int:
        name = self._service_name
        with self.tracer.span("bind", cat=name, sid=sid):
            slot, evicted = self.sched.bind(sid, pinned)
            if evicted is not None:
                with self.tracer.span("pack", cat=name, sid=evicted,
                                      slot=slot):
                    blob = self._pack(slot, evicted)
                self._park_store(evicted, blob)
                self._c_evictions.inc()
                self._on_evict(evicted, slot)
                if self.tracer.enabled:
                    cost = self.sched.cost_fn(evicted) \
                        if self.sched.cost_fn is not None else None
                    self.tracer.instant("evict", cat=name, victim=evicted,
                                        slot=slot, for_sid=sid,
                                        park_cost=cost)
            if sid in self.parking:
                with self.tracer.span("unpack", cat=name, sid=sid,
                                      slot=slot):
                    self._unpack(slot, self._park_take(sid))
                self.tracer.instant("resume", cat=name, sid=sid, slot=slot)
            elif self.sessions[sid].steps == 0:
                self._reset(slot)
            else:  # rebinding after evicted==None cannot lose state
                raise AssertionError("bound session missing parked state")
            self._on_bind(sid, slot)
        return slot

    def park(self, sid: int) -> None:
        """Swap a session's slot column to host memory (no-op if parked).
        Raises ``KeyError`` for a sid that was never admitted."""
        if sid not in self.sessions:
            raise KeyError(f"unknown session {sid}")
        slot = self.sched.park(sid)
        if slot is not None:
            with self.tracer.span("park", cat=self._service_name, sid=sid,
                                  slot=slot):
                self._park_store(sid, self._pack(slot, sid))
            self._on_unbind(slot)

    def resume(self, sid: int) -> None:
        """Bind a parked session back onto a slot without advancing it
        (``push`` also resumes lazily, so this only prepays the unpack).
        Raises ``KeyError`` for a sid that was never admitted."""
        if sid not in self.sessions:
            raise KeyError(f"unknown session {sid}")
        self.sched.touch(sid)
        if not self.sched.is_bound(sid):
            self._bind(sid)

    def push(self, work: dict[int, Any]) -> dict[int, Any]:
        """Advance sessions by one ragged batch of work (the protocol hot
        path; the TCN service aliases ``push_audio`` here)."""
        raise NotImplementedError

    def close(self, sid: int) -> None:
        slot = self.sched.release(sid)
        if slot is not None:
            self._on_unbind(slot)
        self._park_take(sid)
        sess = self.sessions.pop(sid)
        self._on_close(sid, sess)

    def enroll(self, sid: int, shots, **kwargs) -> int:
        """Protocol verb: streaming learning.  Services with a learnable
        head override it; the others keep the surface and refuse."""
        raise NotImplementedError(
            f"{self._service_name} service does not support enrollment")

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

    # -- persistence --------------------------------------------------------
    def _session_spill_meta(self, sid: int) -> dict:
        return {"steps": self.sessions[sid].steps}

    def _spill_extra(self) -> dict:
        return {}

    def _restore_validate(self, parking: dict, meta: dict) -> None:
        pass

    def _restore_apply(self, meta: dict) -> None:
        pass

    def _restore_session(self, info: dict):
        return self._session_cls(steps=int(info.get("steps", 0)))

    def spill_parking(self, path: str, *, include_bound: bool = False) -> str:
        """Write the parking lot to ``path`` (checkpoint/store), so
        sessions survive a restart.  ``include_bound=True`` parks every
        bound session first (a full drain for a planned shutdown).  On a
        mesh the first rank writes and every rank returns the path."""
        if include_bound:
            for sid in list(self.sched.slot_of):
                self.park(sid)
        meta = {"next_sid": self._next_sid,
                "sessions": {str(sid): self._session_spill_meta(sid)
                             for sid in self.parking}}
        meta.update(self._spill_extra())
        if self.mesh is None:
            return save_sessions(path, self.parking, meta)
        # every rank holds the same lot: the mesh's first rank writes it
        return spmd.from_owner(self.mesh, int(self.mesh.mesh.flatten()[0]),
                               lambda: save_sessions(path, self.parking,
                                                     meta))

    def restore_parking(self, path: str) -> list[int]:
        """Adopt a spilled parking lot into this (possibly fresh) service:
        sessions come back parked, with their sids and host records; the
        next push resumes them bit-exactly.  Returns the restored sids.

        All or nothing: every check (sid collisions, admission capacity,
        the service's own validation) runs before the first change, so a
        refused restore leaves the service untouched."""
        parking, meta = load_sessions(path)
        meta = meta or {"next_sid": 0, "sessions": {}}
        for sid in sorted(parking):
            if sid in self.sessions:
                raise ValueError(f"session {sid} already live; refuse to "
                                 "overwrite on restore")
        cap = self.sched.max_sessions
        if cap is not None and self.sched.live_sessions + len(parking) > cap:
            raise AdmissionError(
                f"restoring {len(parking)} sessions would exceed capacity "
                f"({self.sched.live_sessions}/{cap} live)")
        self._restore_validate(parking, meta)
        self._restore_apply(meta)
        restored = []
        for sid, parked in sorted(parking.items()):
            info = meta["sessions"].get(str(sid), {})
            self.sched.admit(sid)
            self.sessions[sid] = self._restore_session(info)
            self._park_store(sid, parked)
            restored.append(sid)
        self._next_sid = max(self._next_sid, int(meta.get("next_sid", 0)))
        self._post_restore(restored, meta)
        return restored

    def _post_restore(self, restored: list[int], meta: dict) -> None:
        """Hook: runs once after a successful restore, with the spill meta
        (so a subclass never re-reads the file)."""

    # -- live handoff / crash recovery --------------------------------------
    # The serving plane's drain, recovery, stealing and spill journal rest
    # on these verbs, which reuse park/spill, so every bit-exactness
    # property of park/resume carries over to a handoff.

    def export_session(self, sid: int) -> tuple[dict, dict]:
        """Snapshot one live session as ``(parked blob, spill meta)``
        without closing it.  A bound session is parked first (bit-exact,
        so the snapshot changes nothing) and re-binds on its next push.
        Raises ``KeyError`` for an unknown sid and ``RuntimeError`` for a
        session with no packable state."""
        if sid not in self.sessions:
            raise KeyError(f"unknown session {sid}")
        self.park(sid)
        if sid not in self.parking:
            raise RuntimeError(f"session {sid} holds no packable state; "
                               "nothing to export")
        return self.parking[sid], self._session_spill_meta(sid)

    def detach_session(self, sid: int) -> tuple[dict, dict]:
        """Remove a session and return its packed ``(blob, meta)`` for
        adoption by a peer (drain handoff, work stealing).  Unlike
        ``close`` the session is not ending: ``_on_close`` does not fire
        (a dedicated tenant stays); the meta carries what the peer needs to
        rebuild the host record through ``adopt_session``."""
        blob, meta = self.export_session(sid)
        self._park_take(sid)
        self.sched.release(sid)
        self.sessions.pop(sid)
        self._on_detach(sid)
        return blob, meta

    def _on_detach(self, sid: int) -> None:
        """Hook: the session just left for another worker (not a close)."""

    def adopt_session(self, blob: dict, meta: dict) -> int:
        """Admit a session exported by a peer under a fresh local sid
        (sids of different services may collide).  It enters parked and
        its next push resumes it bit-exactly.  Validation (geometry,
        capacity) runs before the first change."""
        meta = dict(meta or {})
        self._adopt_validate(blob, meta)
        cap = self.sched.max_sessions
        if cap is not None and self.sched.live_sessions + 1 > cap:
            raise AdmissionError(
                f"adopting a session would exceed capacity "
                f"({self.sched.live_sessions}/{cap} live)")
        sid = self._alloc_sid()
        self.sched.admit(sid)
        self.sessions[sid] = self._restore_session(meta)
        self._park_store(sid, blob)
        self._on_adopt(sid, meta)
        return sid

    def _adopt_validate(self, blob: dict, meta: dict) -> None:
        """Hook: refuse an incompatible blob before any change."""

    def _on_adopt(self, sid: int, meta: dict) -> None:
        """Hook: runs once after a successful single-session adoption."""

    # -- tenant-state handoff (tenant-aware services override) --------------
    def live_tenants(self) -> list:
        return []

    def export_tenant(self, tenant) -> dict:
        raise NotImplementedError(
            f"{self._service_name} service has no per-tenant state")

    def adopt_tenant(self, tenant, blob: dict) -> int:
        raise NotImplementedError(
            f"{self._service_name} service has no per-tenant state")

    # -- introspection ------------------------------------------------------
    def _slot_state_bytes(self) -> int:
        """Structural parked footprint of one session (content-free)."""
        raise NotImplementedError

    def _extra_stats(self) -> dict:
        return {}

    def stats(self) -> dict:
        """The keys of sessions.STATS_SCHEMA, then the service's extras."""
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

    _session_cls = _Session
    _service_name = "tcn"
    tenant_aware = True  # plane routing tenants bind real bank rows here

    def __init__(self, bundle, params, bn_state=None, *, n_slots: int = 8,
                 max_tenants: int = 8, max_ways: int = 8,
                 max_sessions: int | None = None, quantize: bool = False,
                 t_chunk: int = 16,
                 cost_fn: Callable[[int], float] | None = None,
                 stale_window: int = 0, fused: bool | None = None,
                 kernel_backend: str | None = None,
                 paged_bank: bool = False, bank_block_ways: int = 4,
                 bank_blocks: int | None = None, rehearsal_cap: int = 0,
                 metrics: MetricsRegistry | None = None, tracer=None,
                 device_counters: bool | None = None,
                 runtime: RuntimeConfig | None = None, mesh=None):
        super().__init__(n_slots, t_chunk=t_chunk, max_sessions=max_sessions,
                         cost_fn=cost_fn, stale_window=stale_window,
                         metrics=metrics, tracer=tracer,
                         device_counters=device_counters, runtime=runtime)
        cfg = bundle.cfg
        dev = bundle.device
        self.cfg = cfg
        self.device = dev
        self.max_ways = max_ways
        self.quantize = quantize
        # explicit kwarg > runtime / REPRO_TORCH_TCN_FUSED > on
        self.fused = bool(self.runtime.pick("fused", fused))
        kernel_backend = self.runtime.pick("kernel_backend", kernel_backend)
        bn_state = bn_state if bn_state is not None \
            else tcn_empty_state(cfg, dev)
        self._fused_params = None
        if self.fused:
            params, bn_state, self._fused_params = bake_stream_params(
                params, bn_state, cfg, quantize=quantize)
            self._fused_chunk = make_grid_fused(
                cfg, quantize=quantize, backend=kernel_backend, device=dev,
                inplace=True, tracer=self.tracer)
            fwd = make_fused_forward(cfg, quantize=quantize,
                                     backend=kernel_backend, device=dev)
            self._embed = lambda x: fwd(self._fused_params, x)[0]
        else:
            self._embed = lambda x: bundle.embed_fn(
                params, {"x": x}, state=bn_state, quantize=quantize)
        self._params = params
        self._bn = bn_state
        self.mesh = mesh
        self._tenant_entry = None
        self._tenant_lo = 0
        if mesh is None:
            self.states = grid_init(cfg, n_slots, dev)
        else:  # slots over data: each rank allocates its own block only
            self._grid_specs = grid_pspecs(cfg, mesh, n_slots)
            self._set_slot_entry(self._grid_specs["t"][0]
                                 if self._grid_specs["t"] else None)
            self._set_grid(grid_init(cfg, self._slot_hi - self._slot_lo,
                                     dev))
        # Bank layout: the dense (T, max_ways, V) table, or the paged pool
        # where max_ways is the per-tenant growth cap (rounded up to whole
        # blocks) rather than a pre-paid allocation
        self.paged_bank = bool(paged_bank)
        if self.paged_bank:
            mtb = -(-max_ways // bank_block_ways)
            if bank_blocks is None:
                bank_blocks = max_tenants * mtb
            self.bankpool = PagedBankPool(bank_blocks, bank_block_ways,
                                          cfg.embed_dim, mtb, dev)
            self.bank = None
        elif mesh is None:
            self.bankpool = None
            self.bank = bank_init(max_tenants, max_ways, cfg.embed_dim, dev)
        else:  # tenants over model
            self.bankpool = None
            self._bank_specs = bank_pspecs(
                bank_init(max_tenants, max_ways, cfg.embed_dim, "meta"), mesh)
            e = self._bank_specs.s_sums
            self._tenant_entry = e[0] if e else None
            lo, hi = (0, max_tenants) if self._tenant_entry is None \
                else spmd.local_range(mesh, self._tenant_entry, max_tenants)
            self._tenant_lo = lo
            self._set_bank(bank_init(hi - lo, max_ways, cfg.embed_dim, dev))
        self.tenant_of_slot = np.full(n_slots, NO_TENANT, np.int32)
        self._free_tenants = list(range(max_tenants))
        self._tenant_ways = np.zeros(max_tenants, np.int32)  # host mirror
        # label-keyed enrollment: repeated enroll(label=...) calls fold
        # into ONE way's running mean
        self._tenant_labels: dict[int, dict] = {}
        # bounded latent-replay memory (sessions/rehearsal.py)
        self.rehearsal = RehearsalBuffer(rehearsal_cap) \
            if rehearsal_cap > 0 else None
        self.calls = 0  # pushes and enrollments so far: their trace ids
        reg = self.metrics_registry
        self._c_enrolls = reg.counter("enrolls_total", service="tcn")
        self._c_enroll_shots = reg.counter("enroll_shots_total", service="tcn")
        self._h_enroll = reg.histogram("enroll_latency_us", service="tcn")
        if self.paged_bank:
            self._g_pool_live = reg.gauge("bank_pool_blocks_live",
                                          service="tcn")
            self._g_pool_free = reg.gauge("bank_pool_blocks_free",
                                          service="tcn")
            self._update_pool_gauges()
        if self.rehearsal is not None:
            self._g_rehearsal_bytes = reg.gauge("rehearsal_bytes",
                                                service="tcn")
        # a tick's outputs come back through one reused page-locked buffer
        # on a card; on the CPU they already are host tensors
        self._staging = None
        if torch.device(dev).type == "cuda":
            self._stage_readback(pinned=True)

    @property
    def enrolls(self) -> int:
        return int(self._c_enrolls.value)

    def _stage_readback(self, pinned: bool) -> None:
        """Copy each tick's outputs back through one ``StagingBuffer``
        (utils/host.py), page-locked when ``pinned``; its bytes held and its
        allocations are the ``readback_staging_bytes`` gauge and the
        ``readback_staging_allocs_total`` counter."""
        reg = self.metrics_registry
        self._staging = StagingBuffer(
            pinned,
            nbytes_gauge=reg.gauge("readback_staging_bytes", service="tcn"),
            allocs_counter=reg.counter("readback_staging_allocs_total",
                                       service="tcn"))

    # -- the grid and the bank on this rank -----------------------------------
    # Without a mesh these are ``states`` and ``bank`` themselves.  With
    # one, the local shards (cached; they share storage with the DTensors,
    # so in-place writes show in both), re-wrapped when an update returns
    # new tensors.
    def _grid(self) -> dict:
        return self.states if self.mesh is None else self._grid_local

    def _set_grid(self, local: dict) -> None:
        if self.mesh is None:
            self.states = local
        elif local is not getattr(self, "_grid_local", None):
            self._grid_local = local
            self.states = map_specs(
                lambda sp, a: spmd.wrap(a, self.mesh, sp),
                self._grid_specs, local)

    def _local_bank(self) -> TenantBank:
        return self.bank if self.mesh is None else self._bank_local

    def _set_bank(self, local: TenantBank) -> None:
        if self.mesh is None:
            self.bank = local
        else:
            self._bank_local = local
            self.bank = TenantBank(*(spmd.wrap(a, self.mesh, sp) for a, sp
                                     in zip(local, self._bank_specs)))

    def _bank_row(self, tenant: int, fn) -> None:
        """Keep ``fn(local bank, local row)``, the updated local bank, where
        the tenant's row lives; every other rank skips it."""
        lo = self._tenant_lo
        if lo <= tenant < lo + self._local_bank().counts.shape[0]:
            self._set_bank(fn(self._local_bank(), tenant - lo))

    def _pack_tenant_row(self, tenant: int) -> dict:
        """``bank_pack_tenant`` on the row's owner, on every rank."""
        if self._tenant_entry is None:
            return bank_pack_tenant(self._local_bank(), tenant)
        src = spmd.owner(self.mesh, self._tenant_entry, tenant,
                         len(self._tenant_ways))
        return spmd.from_owner(self.mesh, src, lambda: bank_pack_tenant(
            self._bank_local, tenant - self._tenant_lo))

    # -- slot-column state hooks --------------------------------------------
    def _pack(self, slot: int, sid: int) -> dict:
        return self._from_slot(slot, lambda s: pack_slot(
            self._grid(), s, pack_u4=self.quantize,
            act_scale=self.cfg.act_scale))

    def _unpack(self, slot: int, blob: dict) -> None:
        if self._holds_slot(slot):
            self._set_grid(unpack_slot(self._grid(), slot - self._slot_lo,
                                       blob))

    def _reset(self, slot: int) -> None:
        if self._holds_slot(slot):
            self._set_grid(reset_slot(self._grid(), slot - self._slot_lo))

    def _on_bind(self, sid: int, slot: int) -> None:
        self.tenant_of_slot[slot] = self.sessions[sid].tenant

    def _on_unbind(self, slot: int) -> None:
        tenant = int(self.tenant_of_slot[slot])
        self.tenant_of_slot[slot] = NO_TENANT
        self._maybe_park_tenant(tenant)

    def _on_evict(self, sid: int, slot: int) -> None:
        # the eviction path bypasses _on_unbind (the slot is re-occupied at
        # once), but the paged bank must still learn when a tenant's LAST
        # bound session left the grid
        self._maybe_park_tenant(int(self.tenant_of_slot[slot]))

    # -- tenants ------------------------------------------------------------
    def _tenant_idle(self, tenant: int) -> bool:
        """True when no BOUND session belongs to ``tenant``."""
        return all(self.sessions[sid].tenant != tenant
                   for sid in self.sched.slot_of)

    def _maybe_park_tenant(self, tenant: int) -> None:
        """Paged mode: spill an idle tenant's bank rows to host, so a tenant
        with no bound session holds zero device rows."""
        if (self.paged_bank and tenant != NO_TENANT
                and self.bankpool.is_resident(tenant)
                and self._tenant_idle(tenant)):
            self.bankpool.park(tenant)
            self._update_pool_gauges()

    def _ensure_bank_resident(self, tenant: int) -> None:
        if self.paged_bank and not self.bankpool.is_resident(tenant):
            self.bankpool.unpark(tenant)  # may raise PoolExhausted
            self._update_pool_gauges()

    def _update_pool_gauges(self) -> None:
        self._g_pool_live.set(self.bankpool.pool.n_live)
        self._g_pool_free.set(self.bankpool.pool.n_free)

    def create_tenant(self) -> int:
        if not self._free_tenants:
            raise RuntimeError("tenant bank full")
        tenant = self._free_tenants.pop(0)
        if self.paged_bank:
            self.bankpool.create(tenant)
        return tenant

    def close_tenant(self, tenant: int) -> None:
        if any(s.tenant == tenant for s in self.sessions.values()):
            raise RuntimeError(f"tenant {tenant} still has open sessions")
        if self.paged_bank:
            self.bankpool.drop(tenant)
            self._update_pool_gauges()
        else:
            self._bank_row(tenant, bank_clear_tenant)
        self._tenant_labels.pop(tenant, None)
        if self.rehearsal is not None:
            self.rehearsal.drop(tenant)
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
                if self.paged_bank:
                    self.bankpool.create(tenant)
                claimed = True
        sid = self._alloc_sid()
        try:
            self.sched.admit(sid)  # may raise AdmissionError (back-pressure)
        except AdmissionError:
            if claimed:  # don't leak the tenant row on refused admission
                if self.paged_bank:
                    self.bankpool.drop(tenant)
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

    # -- persistence hooks ---------------------------------------------------
    def _session_spill_meta(self, sid: int) -> dict:
        s = self.sessions[sid]
        return {"tenant": s.tenant, "dedicated": s.dedicated, "steps": s.steps}

    def _spill_extra(self) -> dict:
        """Each parked session's tenant bank, JSON-able: the paged pool's
        ``pack`` or the dense row through ``.tolist()`` (the reference's
        meta layout, so a spill crosses between the packages)."""
        tenant_meta = {}
        for sid in self.parking:
            t = self.sessions[sid].tenant
            if t == NO_TENANT or str(t) in tenant_meta:
                continue
            if self.paged_bank:
                tenant_meta[str(t)] = self.bankpool.pack(t)
            else:
                row = self._pack_tenant_row(t)
                tenant_meta[str(t)] = {
                    "s_sums": row["s_sums"].tolist(),
                    "counts": row["counts"].tolist(),
                    "n_ways": int(self._tenant_ways[t]),
                }
        return {"tenants": tenant_meta}

    def _restore_validate(self, parking: dict, meta: dict) -> None:
        for t_str in meta.get("tenants", {}):
            t = int(t_str)
            if t >= len(self._tenant_ways):
                raise ValueError(f"spill references tenant {t} beyond "
                                 f"max_tenants={len(self._tenant_ways)}")
            if t not in self._free_tenants:
                raise ValueError(f"tenant {t} already in use; refuse to "
                                 "overwrite its prototype row on restore")

    def _restore_apply(self, meta: dict) -> None:
        for t_str, row in meta.get("tenants", {}).items():
            t = int(t_str)
            self._free_tenants.remove(t)
            if self.paged_bank:
                # adopted parked (zero device rows); the first push or
                # enroll makes it resident
                self.bankpool.adopt(t, row)
            else:
                self._bank_row(t, lambda bank, r, row=row: bank_unpack_tenant(
                    bank, r, {
                        "s_sums": np.asarray(row["s_sums"], np.float32),
                        "counts": np.asarray(row["counts"], np.float32),
                        "n_ways": np.asarray(row["n_ways"], np.int32)}))
            self._tenant_ways[t] = int(row["n_ways"])

    def _restore_session(self, info: dict):
        return _Session(tenant=int(info.get("tenant", NO_TENANT)),
                        dedicated=bool(info.get("dedicated", False)),
                        steps=int(info.get("steps", 0)))

    # -- the hot path -------------------------------------------------------
    def _slot_fc(self):
        """Each slot's tenant FC rows, gathered once per push: W (S, N, V),
        b (S, N), N = max_ways (dense) or the block-granular table width
        (paged).  Dense rows come from ``bank_fc`` indexed by each slot's
        tenant (slots without one clamp to row 0; their tenant logits are
        never returned); paged rows from ``paged_bank_fc`` through the slot
        tables, built on the host and copied to the device in one piece.
        On a mesh: the rows of this rank's slots, from every rank's
        ``bank_fc`` rows when the bank is sharded (one all-gather)."""
        tenants = self.tenant_of_slot[self._slot_lo:self._slot_hi]
        if self.paged_bank:
            tables, ways = self.bankpool.slot_tables(tenants)
            tw = torch.from_numpy(
                np.concatenate([tables, ways[:, None]], axis=1)).to(self.device)
            return paged_bank_fc(self.bankpool.s_sums, self.bankpool.counts,
                                 tw[:, :-1], tw[:, -1])
        w, b = bank_fc(self._local_bank())
        if self._tenant_entry is not None:
            wb = spmd.gather(torch.cat([w, b[..., None]], dim=-1),
                             self.mesh, self._tenant_entry)
            w, b = wb[..., :-1], wb[..., -1]
        ids = torch.from_numpy(
            np.clip(tenants, 0, w.shape[0] - 1).astype(np.int64)
        ).to(self.device)
        return w[ids], b[ids]

    @staticmethod
    def _banked(emb: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        """Tenant logits (S, T, N) of every step of the tick against the
        rows ``_slot_fc`` gathered.  The contraction is elementwise in a
        fixed order (``pn_logits_rows``), so a step's bits are those of the
        step alone: they do not depend on the tick length, nor on the table
        width N, which differs between the dense and paged layouts."""
        return pn_logits_rows(emb, w, b)

    def push_audio(self, chunks: dict[int, Any]) -> dict[int, dict]:
        """Advance sessions by ragged time chunks.

        chunks: {sid: x}, x a (t_i, C_in) chunk or a single (C_in,) sample.
        Returns {sid: result}: per-sample emb (t_i, V), logits (t_i, n),
        tenant_logits (t_i, max_ways) | None, the end-of-chunk ``pred`` and
        the cumulative ``step``; a (C_in,) sample gets the last row only.
        A pushed session's parked tenant bank is made resident first.
        On a card each tick's outputs are copied back through the service's
        page-locked staging buffer; the returned arrays are copies, never
        views of it, so they stay as they are when later pushes refill it."""
        self.calls += 1
        with self.tracer.call_scope(self.calls):
            return self._push_audio(chunks)

    def _push_audio(self, chunks: dict[int, Any]) -> dict[int, dict]:
        tr = self.tracer
        with tr.span("push.pack", cat="tcn", streams=len(chunks)) as sp:
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
            if self.paged_bank:
                for sid in arrs:
                    t = self.sessions[sid].tenant
                    if t != NO_TENANT:
                        self._ensure_bank_resident(t)

            slot_of = {sid: self.sched.slot_of[sid] for sid in arrs}
            lens = {sid: a.shape[0] for sid, a in arrs.items()}
            max_len = max(lens.values())
            pieces = {sid: [] for sid in arrs}
            sp.set(steps=max_len)
        with tr.span("slot_fc", cat="tcn", paged=self.paged_bank):
            w, b = self._slot_fc()
        off = 0
        while off < max_len:
            t_pad = self._tick_len(max_len - off)
            with tr.span("tick.pack", cat="tcn", t_pad=t_pad):
                x = np.zeros((self.n_slots, t_pad, c_in), np.float32)
                tick_lens = np.zeros(self.n_slots, np.int32)
                for sid, a in arrs.items():
                    seg = a[off:off + t_pad]
                    if seg.shape[0]:
                        x[slot_of[sid], :seg.shape[0]] = seg
                        tick_lens[slot_of[sid]] = seg.shape[0]
            shape = f"T{t_pad}"
            t0 = time.perf_counter()
            with tr.span("dispatch", cat="tcn", shape=shape,
                         lanes=len(arrs), fused=self.fused):
                lo, hi = self._slot_lo, self._slot_hi  # this rank's slots
                with tr.span("upload", cat="tcn", bytes=x[lo:hi].nbytes
                             + tick_lens[lo:hi].nbytes):
                    xt = torch.from_numpy(x[lo:hi]).to(self.device)
                    lt = torch.from_numpy(tick_lens[lo:hi]).to(self.device)
                if self.fused:  # spans "chunk" and "head" inside
                    grid, emb, logits = self._fused_chunk(
                        self._fused_params, self._grid(), xt, lt)
                else:
                    with tr.span("chunk", cat="tcn", spans=0):
                        valid = torch.arange(t_pad, device=self.device)[
                            None, :] < lt[:, None]
                        grid, emb, logits = grid_scan(
                            self._params, self._bn, self.cfg, self._grid(),
                            xt, valid, quantize=self.quantize)
                self._set_grid(grid)
                # the paged table is block-granular (>= max_ways): keep the
                # result surface layout-independent
                with tr.span("banked", cat="tcn", ways=w.shape[1]):
                    tlogits = self._banked(emb, w, b)[..., :self.max_ways]
                if self._slot_entry is not None:  # every rank's slots
                    with tr.span("gather", cat="tcn"):
                        cut = np.cumsum([emb.shape[-1], logits.shape[-1]])
                        out = self._gather_slots(
                            torch.cat([emb, logits, tlogits], dim=-1))
                        emb, logits, tlogits = (out[..., :cut[0]],
                                                out[..., cut[0]:cut[1]],
                                                out[..., cut[1]:])
                        if self.device_counters:
                            lt = torch.from_numpy(tick_lens).to(self.device)
                with tr.span("readback", cat="tcn",
                             pinned=self._staging is not None
                             and self._staging.pinned) as sp:
                    # the occupancy reduces the uploaded lengths on the
                    # device; its copy is queued ahead of the outputs'
                    # copies on the same stream, so it adds no wait of
                    # its own
                    occ = occupancy_stats(lt, t_pad).to(
                        "cpu", non_blocking=True) \
                        if self.device_counters else None
                    if self._staging is None:
                        emb, logits, tlogits = (emb.cpu().numpy(),
                                                logits.cpu().numpy(),
                                                tlogits.cpu().numpy())
                    else:  # views of the staging buffer, one wait
                        emb, logits, tlogits = self._staging.fill(
                            (emb, logits, tlogits))
                    sp.set(bytes=emb.nbytes + logits.nbytes + tlogits.nbytes
                           + (occ.nbytes if occ is not None else 0))
            self._record_dispatch(time.perf_counter() - t0, shape)
            if occ is not None:
                self._ingest_occupancy(occ.numpy())
            with tr.span("tick.scatter", cat="tcn"):
                # staged outputs are views of the buffer the next tick
                # refills: a tick that another follows copies its slices
                keep = self._staging is None or off + t_pad >= max_len
                for sid in arrs:
                    n = min(max(lens[sid] - off, 0), t_pad)
                    if n:
                        s = slot_of[sid]
                        piece = (emb[s, :n], logits[s, :n], tlogits[s, :n])
                        pieces[sid].append(piece if keep else
                                           tuple(p.copy() for p in piece))
            off += t_pad

        with tr.span("push.results", cat="tcn"):
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

    # protocol verb (sessions.SessionService): the TCN payload is audio
    push = push_audio

    # -- FSL / CL enrollment (live, mid-stream) -----------------------------
    def enroll_shots(self, sid: int, shots, *, embedded: bool = False,
                     way: int | None = None, label=None) -> int:
        """Fold k shots into the session's tenant bank; returns the way.
        shots: (k, T, C_in) raw clips, or (k, V) embeddings when
        ``embedded``.  ``way=None, label=None`` appends a new way; ``way=j``
        refines way j; ``label=x`` appends on the first enroll of x and
        refines on later ones.  The next push classifies against it.

        Paged: the tenant's rows grow a block at a time from the shared
        pool (``PoolExhausted`` is back-pressure), and a parked tenant is
        made resident for the update and parked again if none of its
        sessions is bound.  The latency recorded in ``enroll_latency_us``
        ends when the bank update has landed on the device."""
        t0 = time.perf_counter()
        tenant = self.sessions[sid].tenant
        if tenant == NO_TENANT:
            raise ValueError("session has no tenant; open with tenant=None "
                             "or an explicit tenant id to personalize")
        self.calls += 1
        with self.tracer.call_scope(self.calls), \
                self.tracer.span("enroll", cat="tcn", sid=sid, tenant=tenant):
            way = self._enroll(tenant, shots, embedded, way, label)
        self._c_enrolls.inc()
        self._c_enroll_shots.inc(len(shots))
        self._h_enroll.record((time.perf_counter() - t0) * 1e6)
        return way

    # protocol verb (sessions.SessionService): learning is first-class
    enroll = enroll_shots

    def _enroll(self, tenant: int, shots, embedded: bool, way, label) -> int:
        tr = self.tracer
        with tr.span("enroll.upload", cat="tcn") as sp:
            x = torch.tensor(np.asarray(shots, np.float32)).to(self.device)
            sp.set(bytes=x.nbytes)
        if embedded:
            emb = x
        else:
            with tr.span("enroll.embed", cat="tcn", shots=x.shape[0],
                         steps=x.shape[1]):
                emb = self._embed(x)
        with tr.span("enroll.bank", cat="tcn") as sp:
            if label is not None:
                if way is not None:
                    raise ValueError("pass way= or label=, not both")
                way = self._tenant_labels.setdefault(tenant, {}).get(label)
            sp.set(new_way=way is None)
            if way is None:
                if self._tenant_ways[tenant] >= self.max_ways:
                    raise RuntimeError(
                        f"tenant {tenant} at max_ways={self.max_ways}")
                if self.paged_bank:
                    self._ensure_bank_resident(tenant)
                    way = self.bankpool.add_class(tenant, emb)
                    self._update_pool_gauges()
                else:
                    self._bank_row(tenant, lambda bank, r: bank_add_class(
                        bank, r, emb))
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
                if self.paged_bank:
                    self._ensure_bank_resident(tenant)
                    self.bankpool.update_class(tenant, way, emb)
                else:
                    self._bank_row(tenant, lambda bank, r: bank_update_class(
                        bank, r, way, emb))
            if self.rehearsal is not None:
                self.rehearsal.add(tenant, way, emb.cpu().numpy())
                self._g_rehearsal_bytes.set(self.rehearsal.nbytes())
        if self.device.type == "cuda":
            with tr.span("enroll.sync", cat="tcn"):
                torch.cuda.synchronize(self.device)  # the update has landed
        self._maybe_park_tenant(tenant)
        return way

    def rehearse_tenant(self, tenant: int) -> int:
        """Rebuild every enrolled way of ``tenant`` from the rehearsal
        buffer (dequantized u4 log2 embeddings re-summed), REPLACING the
        exact running sums.  Returns the number of ways rebuilt."""
        if self.rehearsal is None:
            raise RuntimeError(
                "service built with rehearsal_cap=0; no buffer to replay")
        n = int(self._tenant_ways[tenant])
        rows = [self.rehearsal.rebuild(tenant, way, self.cfg.embed_dim)
                for way in range(n)]
        if self.paged_bank:
            self._ensure_bank_resident(tenant)
            for way, (s, k) in enumerate(rows):
                self.bankpool.set_way(tenant, way, s, k)
            self._maybe_park_tenant(tenant)
        elif n:
            def rebuild(bank, r):
                s_sums, counts = bank.s_sums.clone(), bank.counts.clone()
                s_sums[r, :n] = torch.from_numpy(
                    np.stack([s for s, _ in rows])).to(self.device)
                counts[r, :n] = torch.tensor(
                    [float(k) for _, k in rows], device=self.device)
                return bank._replace(s_sums=s_sums, counts=counts)

            self._bank_row(tenant, rebuild)
        return n

    # -- tenant-state handoff ------------------------------------------------
    def live_tenants(self) -> list[int]:
        return [t for t in range(len(self._tenant_ways))
                if t not in self._free_tenants]

    def export_tenant(self, tenant: int) -> dict:
        """Layout-free host snapshot of one tenant's learned state: the
        running sums truncated to the enrolled ways (numpy), the label ->
        way registry and the rehearsal reservoirs.  Non-destructive; either
        bank layout, in either package, adopts it."""
        if not 0 <= tenant < len(self._tenant_ways) \
                or tenant in self._free_tenants:
            raise KeyError(f"tenant {tenant} not in use")
        n = int(self._tenant_ways[tenant])
        dim = self.cfg.embed_dim
        if self.paged_bank:
            row = self.bankpool.pack(tenant)
        else:
            row = self._pack_tenant_row(tenant)
        s = np.asarray(row["s_sums"], np.float32).reshape(-1, dim)[:n]
        c = np.asarray(row["counts"], np.float32).reshape(-1)[:n]
        blob = {"s_sums": s, "counts": c, "n_ways": n,
                "labels": dict(self._tenant_labels.get(tenant, {}))}
        if self.rehearsal is not None:
            blob["rehearsal"] = self.rehearsal.export_tenant(tenant)
        return blob

    def adopt_tenant(self, tenant: int | None, blob: dict) -> int:
        """Install an ``export_tenant`` blob under ``tenant`` (a free row)
        or under a fresh row when ``tenant is None``; returns the id used.
        A paged bank adopts the tenant parked (zero device rows until its
        first use)."""
        if tenant is None:
            if not self._free_tenants:
                raise RuntimeError("tenant bank full")
            tenant = self._free_tenants[0]
        if not 0 <= tenant < len(self._tenant_ways):
            raise ValueError(f"tenant {tenant} out of range "
                             f"[0, {len(self._tenant_ways)})")
        if tenant not in self._free_tenants:
            raise ValueError(f"tenant {tenant} already in use; refuse to "
                             "overwrite its prototype rows")
        n = int(blob["n_ways"])
        if n > self.max_ways:
            raise ValueError(f"blob carries {n} ways but this service caps "
                             f"at max_ways={self.max_ways}")
        dim = self.cfg.embed_dim
        s = np.asarray(blob["s_sums"], np.float32).reshape(-1, dim)[:n]
        c = np.asarray(blob["counts"], np.float32).reshape(-1)[:n]
        self._free_tenants.remove(tenant)
        if self.paged_bank:
            self.bankpool.adopt(tenant, {"s_sums": s, "counts": c,
                                         "n_ways": n})
        else:
            sp = np.zeros((self.max_ways, dim), np.float32)
            cp = np.zeros((self.max_ways,), np.float32)
            sp[:n], cp[:n] = s, c
            self._bank_row(tenant, lambda bank, r: bank_unpack_tenant(
                bank, r, {"s_sums": sp, "counts": cp, "n_ways": n}))
        self._tenant_ways[tenant] = n
        if blob.get("labels"):
            self._tenant_labels[tenant] = dict(blob["labels"])
        if self.rehearsal is not None and blob.get("rehearsal"):
            self.rehearsal.adopt_tenant(tenant, blob["rehearsal"])
        return tenant

    def _adopt_validate(self, blob: dict, meta: dict) -> None:
        t = int(meta.get("tenant", NO_TENANT))
        if t == NO_TENANT:
            return
        if not 0 <= t < len(self._tenant_ways):
            raise ValueError(f"session references tenant {t} beyond "
                             f"max_tenants={len(self._tenant_ways)}")
        if t in self._free_tenants:
            raise ValueError(f"session references tenant {t} but no such "
                             "row is in use here; adopt_tenant first")

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
        # what one tenant's prototype rows cost: a row of the dense bank, or
        # one block (the allocation granule) of the paged pool, beside the
        # pool's occupancy
        if self.paged_bank:
            bp = self.bankpool
            extra = {"tenant_row_bytes":
                     bp.block_ways * (self.cfg.embed_dim + 1) * 4}
            extra.update({f"bank_pool_{k}": v for k, v in bp.stats().items()})
        else:
            extra = {"tenant_row_bytes": bank_row_bytes(self._local_bank())}
        extra.update(fused=self.fused, paged_bank=self.paged_bank,
                     enrolls=self.enrolls)
        if self.rehearsal is not None:
            extra["rehearsal_bytes"] = self.rehearsal.nbytes()
        return extra
