"""Sessions over a fixed slot grid (the port of ``repro/sessions``):
state.py, tenancy.py (dense banks), paging.py (the block allocator and the
LM prefix registry), bankpool.py (paged banks), rehearsal.py (the u4
replay buffer), scheduler.py, service.py (the TCN
``StreamSessionService``), lm.py (``LMSessionService``, KV-cache serving)
and spec.py (``SpeculativeDecoder``, ``ngram_drafter``: speculative
decoding of every LM family the port builds).

``StreamSessionService`` and ``LMSessionService`` conform to the
structural ``SessionService``
protocol defined here (open_session / push / enroll / park / resume /
close / poll / metrics / stats); the serving plane (serving/plane.py)
programs against the protocol only.  ``stats()`` always holds the
``STATS_SCHEMA`` keys and ``metrics()`` the ``METRICS_SCHEMA`` series;
both tuples equal the reference's (tests/test_torch_protocol.py).
"""

from typing import Any, Protocol, runtime_checkable

from repro_torch.sessions.bankpool import PagedBankPool, paged_bank_fc
from repro_torch.sessions.lm import (
    LMSessionService,
    make_decode_scan,
    make_decode_scan_paged,
    make_prefill_column,
    make_prefill_paged,
    pow2_chunks,
)
from repro_torch.sessions.paging import (
    NULL_BLOCK,
    BlockPool,
    PoolExhausted,
    PrefixCache,
    prefix_keys,
)
from repro_torch.sessions.rehearsal import RehearsalBuffer
from repro_torch.sessions.scheduler import AdmissionError, CapacityError, SlotScheduler
from repro_torch.sessions.service import (
    NO_TENANT,
    SessionRecord,
    SlotGridService,
    StreamSessionService,
)
from repro_torch.sessions.spec import (
    SpeculativeDecoder,
    make_verify_chunk,
    make_verify_chunk_paged,
    make_verify_scan,
    make_verify_scan_paged,
    ngram_drafter,
)
from repro_torch.sessions.state import (
    column_pspecs,
    decode_parked,
    gather_column,
    grid_init,
    grid_pspecs,
    grid_scan,
    grid_step,
    leaf_axes,
    lengths_to_valid,
    make_grid_fused,
    make_pools,
    pack_blocks,
    pack_column,
    pack_slot,
    parked_bytes,
    reset_slot,
    slot_park_bytes,
    slot_state_bytes,
    split_blocks,
    unpack_blocks,
    unpack_column,
    unpack_slot,
    zero_from_column,
)
from repro_torch.sessions.tenancy import (
    TenantBank,
    bank_add_class,
    bank_clear_tenant,
    bank_fc,
    bank_init,
    bank_pspecs,
    bank_pack_tenant,
    bank_row_bytes,
    bank_set_store,
    bank_store,
    bank_unpack_tenant,
    bank_update_class,
)

# Keys every SessionService.stats() dict carries (services add extras).
STATS_SCHEMA = (
    "service",            # "tcn" | "lm"
    "n_slots",            # grid width
    "t_chunk",            # chunk length of a full tick
    "bound",              # sessions currently on slots
    "parked",             # sessions parked to host
    "live_sessions",      # bound + parked
    "evictions",          # lifetime eviction count
    "dispatches",         # lifetime ticks
    "parked_blob_bytes",  # actual host bytes in the parking lot
    "slot_state_bytes",   # structural bytes of ONE full slot column
)

# Metric series every service registers at construction (label service=),
# so a fresh service's metrics() snapshot always carries them.
METRICS_SCHEMA = (
    "dispatches_total",
    "evictions_total",
    "sessions_bound",
    "sessions_parked",
    "parked_bytes",
)


@runtime_checkable
class SessionService(Protocol):
    """Structural protocol for slot-grid session services.

    ``push`` is the ragged hot path: a dict keyed by session id whose
    values are service-specific work (TCN: audio chunks; LM: a token
    budget); absent sessions
    stay frozen, so how pushes are grouped into calls never changes what
    any one session computes (the contract the serving plane's batching
    builds on)."""

    n_slots: int

    def open_session(self, *args: Any, **kwargs: Any) -> int: ...
    def push(self, work: dict[int, Any]) -> dict[int, Any]: ...
    def enroll(self, sid: int, shots: Any, **kwargs: Any) -> int: ...
    def park(self, sid: int) -> None: ...
    def resume(self, sid: int) -> None: ...
    def close(self, sid: int) -> None: ...
    def poll(self, sid: int) -> dict: ...
    def metrics(self) -> dict: ...
    def stats(self) -> dict: ...


__all__ = [
    "SessionService", "STATS_SCHEMA", "METRICS_SCHEMA",
    "PagedBankPool", "paged_bank_fc", "NULL_BLOCK", "BlockPool",
    "PoolExhausted", "PrefixCache", "prefix_keys", "LMSessionService",
    "make_decode_scan", "make_decode_scan_paged", "make_prefill_column",
    "make_prefill_paged", "pow2_chunks", "SpeculativeDecoder", "make_verify_chunk",
    "make_verify_chunk_paged", "make_verify_scan", "make_verify_scan_paged",
    "ngram_drafter", "RehearsalBuffer", "AdmissionError", "CapacityError",
    "SlotScheduler", "NO_TENANT", "SessionRecord", "SlotGridService",
    "StreamSessionService", "column_pspecs", "decode_parked",
    "gather_column", "grid_init", "grid_pspecs", "grid_scan", "grid_step", "leaf_axes", "lengths_to_valid",
    "make_grid_fused", "make_pools", "pack_blocks", "pack_column",
    "pack_slot", "parked_bytes", "reset_slot", "slot_park_bytes",
    "slot_state_bytes", "split_blocks", "unpack_blocks", "unpack_column",
    "unpack_slot", "zero_from_column", "TenantBank", "bank_add_class",
    "bank_clear_tenant", "bank_fc", "bank_init", "bank_pack_tenant",
    "bank_pspecs",
    "bank_row_bytes", "bank_set_store", "bank_store", "bank_unpack_tenant",
    "bank_update_class",
]
