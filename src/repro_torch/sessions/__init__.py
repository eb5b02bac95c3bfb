"""Streaming TCN sessions over a fixed slot grid (the port of
``repro/sessions``, TCN half): state.py, tenancy.py (dense banks),
paging.py (the block allocator), bankpool.py (paged banks), rehearsal.py
(the u4 replay buffer), scheduler.py, service.py."""

from repro_torch.sessions.bankpool import PagedBankPool, paged_bank_fc
from repro_torch.sessions.paging import NULL_BLOCK, BlockPool, PoolExhausted
from repro_torch.sessions.rehearsal import RehearsalBuffer
from repro_torch.sessions.scheduler import AdmissionError, CapacityError, SlotScheduler
from repro_torch.sessions.service import (
    NO_TENANT,
    SessionRecord,
    SlotGridService,
    StreamSessionService,
)
from repro_torch.sessions.state import (
    decode_parked,
    grid_init,
    grid_scan,
    grid_step,
    lengths_to_valid,
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
    bank_row_bytes,
    bank_unpack_tenant,
    bank_update_class,
)

__all__ = [
    "PagedBankPool", "paged_bank_fc", "NULL_BLOCK", "BlockPool",
    "PoolExhausted", "RehearsalBuffer", "AdmissionError", "CapacityError",
    "SlotScheduler", "NO_TENANT", "SessionRecord", "SlotGridService",
    "StreamSessionService", "decode_parked", "grid_init", "grid_scan",
    "grid_step", "lengths_to_valid", "make_grid_fused", "pack_slot",
    "parked_bytes", "reset_slot", "slot_park_bytes", "unpack_slot",
    "TenantBank", "bank_add_class", "bank_clear_tenant", "bank_fc",
    "bank_init", "bank_pack_tenant", "bank_row_bytes", "bank_unpack_tenant",
    "bank_update_class",
]
