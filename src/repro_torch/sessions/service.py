"""Request-loop façades over the streaming slot grid.

The port of ``repro/sessions/service.py``, TCN half:

``SlotGridService`` is the service-agnostic core: a fixed slot grid,
admission control and LRU/cost eviction (sessions/scheduler), a host-side
parking lot of packed slot columns, and power-of-two chunk buckets.
Concrete services supply ``_pack``/``_unpack``/``_reset``.

``StreamSessionService`` is the TCN streaming façade:

    open_session / push_audio / enroll_shots / poll / park / resume / close

``push_audio`` takes ragged per-session chunks {sid: (t_i, C_in)}, pads
them onto the (S, T_chunk) grid and advances every pushed session per
tick; short chunks and absent sessions stay frozen.  ``fused=True`` (the
default, so a service on the card runs the kernels) bakes BN and the
log2 weight quantization once at construction
(models/tcn.bake_stream_params) and runs each tick's TCN body through one
``tcn_chunk`` kernel launch; ``fused=False`` runs the plain per-step
executor, the reference the fused path is tested against.  Enrollment
embeds shots through ``make_fused_forward`` on a fused service (the
``tcn_block`` strip kernel) and through the eval-mode forward otherwise.
A parked session resumes bit-exactly in any free slot.

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

Counters are plain integers (``dispatches``, ``evictions``, ``enrolls``).
Not ported yet: the ``SessionService`` protocol verbs (``push``,
``enroll``), cost-aware eviction options, spill/restore and the session
handoff verbs, meshes, in-dispatch device counters, metrics and trace.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.protonet import pn_logits_rows
from repro_torch.models.tcn import (
    bake_stream_params,
    make_fused_forward,
    tcn_empty_state,
)
from repro_torch.sessions.bankpool import PagedBankPool, paged_bank_fc
from repro_torch.sessions.rehearsal import RehearsalBuffer
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
    bank_pack_tenant,
    bank_row_bytes,
    bank_unpack_tenant,
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

    def _bind(self, sid: int, pinned: set[int] = frozenset()) -> int:
        slot, evicted = self.sched.bind(sid, pinned)
        if evicted is not None:
            self.parking[evicted] = self._pack(slot, evicted)
            self.evictions += 1
            self._on_evict(evicted, slot)
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
                 kernel_backend: str | None = None,
                 paged_bank: bool = False, bank_block_ways: int = 4,
                 bank_blocks: int | None = None, rehearsal_cap: int = 0):
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
                cfg, quantize=quantize, backend=kernel_backend, device=dev,
                inplace=True)
            fwd = make_fused_forward(cfg, quantize=quantize,
                                     backend=kernel_backend, device=dev)
            self._embed = lambda x: fwd(self._fused_params, x)[0]
        else:
            self._embed = lambda x: bundle.embed_fn(
                params, {"x": x}, state=bn_state, quantize=quantize)
        self._params = params
        self._bn = bn_state
        self.states = grid_init(cfg, n_slots, dev)
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
        else:
            self.bankpool = None
            self.bank = bank_init(max_tenants, max_ways, cfg.embed_dim, dev)
        self.tenant_of_slot = np.full(n_slots, NO_TENANT, np.int32)
        self._free_tenants = list(range(max_tenants))
        self._tenant_ways = np.zeros(max_tenants, np.int32)  # host mirror
        # label-keyed enrollment: repeated enroll(label=...) calls fold
        # into ONE way's running mean
        self._tenant_labels: dict[int, dict] = {}
        # bounded latent-replay memory (sessions/rehearsal.py)
        self.rehearsal = RehearsalBuffer(rehearsal_cap) \
            if rehearsal_cap > 0 else None

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

    def _ensure_bank_resident(self, tenant: int) -> None:
        if self.paged_bank and not self.bankpool.is_resident(tenant):
            self.bankpool.unpark(tenant)  # may raise PoolExhausted

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
        else:
            self.bank = bank_clear_tenant(self.bank, tenant)
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

    # -- the hot path -------------------------------------------------------
    def _slot_fc(self):
        """Each slot's tenant FC rows, gathered once per push: W (S, N, V),
        b (S, N), N = max_ways (dense) or the block-granular table width
        (paged).  Dense rows come from ``bank_fc`` indexed by each slot's
        tenant (slots without one clamp to row 0; their tenant logits are
        never returned); paged rows from ``paged_bank_fc`` through the slot
        tables, built on the host and copied to the device in one piece."""
        if self.paged_bank:
            tables, ways = self.bankpool.slot_tables(self.tenant_of_slot)
            tw = torch.from_numpy(
                np.concatenate([tables, ways[:, None]], axis=1)).to(self.device)
            return paged_bank_fc(self.bankpool.s_sums, self.bankpool.counts,
                                 tw[:, :-1], tw[:, -1])
        w, b = bank_fc(self.bank)
        ids = torch.from_numpy(
            np.clip(self.tenant_of_slot, 0, w.shape[0] - 1).astype(np.int64)
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
        A pushed session's parked tenant bank is made resident first."""
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
        w, b = self._slot_fc()
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
            # the paged table is block-granular (>= max_ways): keep the
            # result surface layout-independent
            tlogits = self._banked(emb, w, b)[..., :self.max_ways]
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
        refines on later ones.  The next push classifies against it.

        Paged: the tenant's rows grow a block at a time from the shared
        pool (``PoolExhausted`` is back-pressure), and a parked tenant is
        made resident for the update and parked again if none of its
        sessions is bound."""
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
            if self.paged_bank:
                self._ensure_bank_resident(tenant)
                way = self.bankpool.add_class(tenant, emb)
            else:
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
            if self.paged_bank:
                self._ensure_bank_resident(tenant)
                self.bankpool.update_class(tenant, way, emb)
            else:
                self.bank = bank_update_class(self.bank, tenant, way, emb)
        if self.rehearsal is not None:
            self.rehearsal.add(tenant, way, emb.cpu().numpy())
        self._maybe_park_tenant(tenant)
        self.enrolls += 1
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
            s_sums, counts = self.bank.s_sums.clone(), self.bank.counts.clone()
            s_sums[tenant, :n] = torch.from_numpy(
                np.stack([s for s, _ in rows])).to(self.device)
            counts[tenant, :n] = torch.tensor(
                [float(k) for _, k in rows], device=self.device)
            self.bank = self.bank._replace(s_sums=s_sums, counts=counts)
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
            row = bank_pack_tenant(self.bank, tenant)
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
            self.bank = bank_unpack_tenant(self.bank, tenant, {
                "s_sums": sp, "counts": cp, "n_ways": n})
        self._tenant_ways[tenant] = n
        if blob.get("labels"):
            self._tenant_labels[tenant] = dict(blob["labels"])
        if self.rehearsal is not None and blob.get("rehearsal"):
            self.rehearsal.adopt_tenant(tenant, blob["rehearsal"])
        return tenant

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
            extra = {"tenant_row_bytes": bank_row_bytes(self.bank)}
        extra.update(fused=self.fused, paged_bank=self.paged_bank,
                     enrolls=self.enrolls)
        if self.rehearsal is not None:
            extra["rehearsal_bytes"] = self.rehearsal.nbytes()
        return extra
