"""Admission control + LRU eviction over a fixed compiled slot grid.

The port of ``repro/sessions/scheduler.py``, unchanged in behaviour.

Pure host-side bookkeeping (no tensors): the slot-grid shape never changes,
so scaling to many more sessions than slots is purely a question of *which*
sessions occupy the grid.  The scheduler tracks a free list, a logical-clock
LRU order, and which sessions are parked (state swapped to host memory);
the service layer performs the actual pack/unpack.

Policies:
  * admission — at most ``max_sessions`` live (bound + parked) sessions;
    beyond that ``open_session`` is refused (AdmissionError), back-pressure
    instead of silent degradation;
  * placement — a free slot if any, else evict the least-recently-touched
    *idle* bound session (sessions being stepped this tick are pinned by
    the caller via ``touch``);
  * cost-aware eviction — an optional ``cost_fn(sid) -> bytes`` callback
    breaks staleness near-ties in favour of the cheapest-to-park session:
    among candidates whose last_used clock is within ``stale_window`` of
    the oldest (window 0 = exact LRU ties only), the minimum park cost
    wins.  Costs are genuinely non-uniform across the services built on
    this scheduler: fp32 TCN parkings are fixed O(receptive-field) bytes,
    the quantized service's nibble-packed parkings ~8x less, and LM KV
    parkings grow O(pos) with the session's decoded length
    (sessions/lm.LMSessionService wires that in as its default cost_fn) —
    one policy arbitrates all of them;
  * release — closing a session frees its slot for immediate reuse.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


class AdmissionError(RuntimeError):
    """Raised when the service is at its live-session capacity."""


class CapacityError(RuntimeError):
    """Raised when a placement needs a slot but every slot is pinned."""


@dataclass
class SlotScheduler:
    n_slots: int
    max_sessions: int | None = None  # None = unlimited live sessions
    cost_fn: Callable[[int], float] | None = None  # sid -> park cost (bytes)
    stale_window: int = 0  # staleness tolerance for cost-aware tie-breaks

    clock: int = 0
    slot_of: dict[int, int] = field(default_factory=dict)   # bound sid -> slot
    sid_of: dict[int, int] = field(default_factory=dict)    # slot -> sid
    last_used: dict[int, int] = field(default_factory=dict)  # sid -> clock
    parked: set[int] = field(default_factory=set)

    # -- queries ------------------------------------------------------------
    @property
    def live_sessions(self) -> int:
        return len(self.slot_of) + len(self.parked)

    @property
    def free_slots(self) -> list[int]:
        return [s for s in range(self.n_slots) if s not in self.sid_of]

    def is_bound(self, sid: int) -> bool:
        return sid in self.slot_of

    def is_parked(self, sid: int) -> bool:
        return sid in self.parked

    # -- lifecycle ----------------------------------------------------------
    def admit(self, sid: int) -> None:
        """Register a new live session (admission control gate)."""
        if self.max_sessions is not None and self.live_sessions >= self.max_sessions:
            raise AdmissionError(
                f"at capacity: {self.live_sessions}/{self.max_sessions} live sessions")
        self.parked.add(sid)  # born parked; bind() places it
        self.touch(sid)

    def touch(self, sid: int) -> None:
        """Mark a session as recently used (pins it against this tick's
        eviction sweep — eviction always picks the LRU minimum)."""
        self.clock += 1
        self.last_used[sid] = self.clock

    def bind(self, sid: int, pinned: set[int] = frozenset()) -> tuple[int, int | None]:
        """Place ``sid`` on a slot.  Returns (slot, evicted_sid|None); the
        caller must park the evicted session's state before overwriting the
        slot.  ``pinned`` sids are never evicted (they are being stepped in
        the same batched call)."""
        if sid in self.slot_of:
            return self.slot_of[sid], None
        free = self.free_slots
        evicted = None
        if free:
            slot = free[0]
        else:
            victims = [s for s in self.slot_of if s != sid and s not in pinned]
            if not victims:
                raise CapacityError("all slots pinned; cannot place session")
            lu = lambda s: self.last_used.get(s, 0)
            if self.cost_fn is None:
                evicted = min(victims, key=lu)
            else:
                oldest = min(lu(s) for s in victims)
                pool = [s for s in victims if lu(s) - oldest <= self.stale_window]
                evicted = min(pool, key=lambda s: (self.cost_fn(s), lu(s)))
            slot = self.slot_of.pop(evicted)
            del self.sid_of[slot]
            self.parked.add(evicted)
        self.parked.discard(sid)
        self.slot_of[sid] = slot
        self.sid_of[slot] = sid
        return slot, evicted

    def park(self, sid: int) -> int | None:
        """Explicitly unbind a session (caller packs its state to host).
        Returns the freed slot, or None if the session was not bound."""
        slot = self.slot_of.pop(sid, None)
        if slot is not None:
            del self.sid_of[slot]
            self.parked.add(sid)
        return slot

    def release(self, sid: int) -> int | None:
        """Close a session: frees its slot (if bound) for immediate reuse."""
        self.parked.discard(sid)
        self.last_used.pop(sid, None)
        slot = self.slot_of.pop(sid, None)
        if slot is not None:
            del self.sid_of[slot]
        return slot
