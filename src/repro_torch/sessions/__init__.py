"""Streaming TCN sessions over a fixed slot grid (the port of
``repro/sessions``, TCN half): state.py, tenancy.py, scheduler.py,
service.py."""

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
from repro_torch.sessions.tenancy import TenantBank, bank_fc, bank_init

__all__ = [
    "AdmissionError", "CapacityError", "SlotScheduler", "NO_TENANT",
    "SessionRecord", "SlotGridService", "StreamSessionService",
    "decode_parked", "grid_init", "grid_scan", "grid_step",
    "lengths_to_valid", "make_grid_fused", "pack_slot", "parked_bytes",
    "reset_slot", "slot_park_bytes", "unpack_slot", "TenantBank", "bank_fc",
    "bank_init",
]
