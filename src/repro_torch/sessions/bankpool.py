"""Paged per-tenant prototype banks over the block-pool allocator.

The port of ``repro/sessions/bankpool.py``.  The dense ``TenantBank``
(tenancy.py) pre-allocates max_tenants x max_ways FC rows; the paper's CL
headline (§III-A / Fig. 15: 250 classes learned one at a time) wants the
rows paged instead: way rows live in a shared pool of ``(n_blocks + 1,
block_ways, V)`` on the device and each tenant reads it through a
host-side block table, so

  * a tenant's bank grows one block at a time as it enrolls past each
    ``block_ways`` boundary;
  * a parked tenant holds zero device rows: ``park`` copies its blocks to
    host and frees the ids, ``unpark`` re-allocates and writes the same
    fp32 bytes back;
  * exhaustion is ``PoolExhausted`` (an ``AdmissionError``).

Block id 0 is the reserved NULL block: slot tables are NULL-padded and
``paged_bank_fc`` masks every row at or past the tenant's way count to
bias -inf.  The FC math is ``store_fc``'s, op for op, so at equal way
counts the paged rows equal the dense ``bank_fc`` rows bit for bit.
Pool updates are in place; the block tables, way counts and parked blobs
are host state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.protonet import sum_last
from repro_torch.kernels.dispatch import require_device
from repro_torch.sessions.paging import NULL_BLOCK, BlockPool


class PagedBankPool:
    """Block-granular tenant prototype storage + host block tables.

    Device state: ``s_sums (extent, block_ways, V)`` and ``counts (extent,
    block_ways)``, both fp32 (extent = n_blocks + 1, row 0 is NULL).  Host
    state: per-tenant block-id tables, way counts and parked blobs."""

    def __init__(self, n_blocks: int, block_ways: int, dim: int,
                 max_tenant_blocks: int, device="cuda"):
        if block_ways < 1:
            raise ValueError(f"block_ways must be >= 1, got {block_ways}")
        if max_tenant_blocks < 1:
            raise ValueError(
                f"max_tenant_blocks must be >= 1, got {max_tenant_blocks}")
        self.device = require_device(device)
        self.block_ways = int(block_ways)
        self.dim = int(dim)
        self.max_tenant_blocks = int(max_tenant_blocks)
        self.pool = BlockPool(n_blocks)
        self.s_sums = torch.zeros((self.pool.extent, block_ways, dim),
                                  device=self.device)
        self.counts = torch.zeros((self.pool.extent, block_ways),
                                  device=self.device)
        self.tables: dict[int, list[int]] = {}   # tenant -> block ids
        self.n_ways: dict[int, int] = {}         # tenant -> enrolled ways
        self._parked: dict[int, dict] = {}       # tenant -> host blob

    @property
    def max_ways(self) -> int:
        """Per-tenant way cap (table width x block granularity)."""
        return self.max_tenant_blocks * self.block_ways

    def row_bytes(self, tenant: int) -> int:
        """Device bytes held by ``tenant`` (block-granular; zero parked)."""
        per_block = self.block_ways * (self.dim + 1) * 4
        return len(self.tables.get(tenant, ())) * per_block

    # -- tenant lifecycle ---------------------------------------------------
    def create(self, tenant: int) -> None:
        if tenant in self.n_ways:
            raise ValueError(f"tenant {tenant} already exists in bank pool")
        self.tables[tenant] = []
        self.n_ways[tenant] = 0

    def drop(self, tenant: int) -> None:
        """Free every block the tenant holds (resident or parked)."""
        for bid in self.tables.pop(tenant, ()):
            self.pool.free(bid)
        self.n_ways.pop(tenant, None)
        self._parked.pop(tenant, None)

    def is_resident(self, tenant: int) -> bool:
        return tenant in self.n_ways and tenant not in self._parked

    # -- enrollment ---------------------------------------------------------
    def _shots(self, shot_embeddings) -> tuple[torch.Tensor, float]:
        """(sum of the (k, V) shots in fp32 on the pool's device, k)."""
        x = torch.as_tensor(np.asarray(shot_embeddings, np.float32)) \
            if not isinstance(shot_embeddings, torch.Tensor) \
            else shot_embeddings
        x = x.to(self.device, torch.float32)
        return x.sum(dim=0), float(x.shape[0])

    def _row(self, tenant: int, way: int) -> tuple[int, int]:
        return (self.tables[tenant][way // self.block_ways],
                way % self.block_ways)

    def _check_resident(self, tenant: int) -> None:
        if tenant in self._parked:
            raise RuntimeError(f"tenant {tenant} is parked; unpark first")

    def _grow(self, tenant: int) -> None:
        """Append one zeroed block to the tenant's table.  Zeroing on alloc
        keeps the residue contract local: a block recycled from another
        tenant never leaks its old sums into fresh ways."""
        table = self.tables[tenant]
        if len(table) >= self.max_tenant_blocks:
            raise RuntimeError(f"tenant {tenant} at max_ways={self.max_ways}")
        bid = self.pool.alloc()  # may raise PoolExhausted (back-pressure)
        self.s_sums[bid] = 0.0
        self.counts[bid] = 0.0
        table.append(bid)

    def add_class(self, tenant: int, shot_embeddings) -> int:
        """Enroll the tenant's next way from (k, V) shot embeddings; returns
        the new way index.  Raises at the way cap."""
        self._check_resident(tenant)
        way = self.n_ways[tenant]
        if way >= self.max_ways:
            raise RuntimeError(f"tenant {tenant} at max_ways={self.max_ways}")
        s, k = self._shots(shot_embeddings)
        if way % self.block_ways == 0:
            self._grow(tenant)
        bid, r = self._row(tenant, way)
        # set on both leaves (the bank_add_class residue rule)
        self.s_sums[bid, r] = s
        self.counts[bid, r] = k
        self.n_ways[tenant] = way + 1
        return way

    def update_class(self, tenant: int, way: int, shot_embeddings) -> None:
        """Refine an enrolled way with more shots (running mean, Eq. 3/6)."""
        self._check_resident(tenant)
        if not 0 <= way < self.n_ways[tenant]:
            raise ValueError(f"way {way} not enrolled for tenant {tenant} "
                             f"({self.n_ways[tenant]} ways)")
        s, k = self._shots(shot_embeddings)
        bid, r = self._row(tenant, way)
        self.s_sums[bid, r] += s
        self.counts[bid, r] += k

    def set_way(self, tenant: int, way: int, s_sum, count) -> None:
        """Overwrite one way's running sums (the rehearsal-rebuild path)."""
        self._check_resident(tenant)
        if not 0 <= way < self.n_ways[tenant]:
            raise ValueError(f"way {way} not enrolled for tenant {tenant}")
        bid, r = self._row(tenant, way)
        self.s_sums[bid, r] = torch.as_tensor(
            np.asarray(s_sum, np.float32)).to(self.device)
        self.counts[bid, r] = float(np.float32(count))

    # -- park / unpark ------------------------------------------------------
    def _host_rows(self, bids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        if not bids:
            return (np.zeros((0, self.block_ways, self.dim), np.float32),
                    np.zeros((0, self.block_ways), np.float32))
        idx = torch.tensor(bids, dtype=torch.long, device=self.device)
        return self.s_sums[idx].cpu().numpy(), self.counts[idx].cpu().numpy()

    def park(self, tenant: int) -> None:
        """Copy the tenant's blocks to host and free the device rows.
        Idempotent; a zero-way tenant parks to an empty blob."""
        if tenant not in self.n_ways:
            raise KeyError(f"unknown tenant {tenant}")
        if tenant in self._parked:
            return
        bids = self.tables[tenant]
        s, c = self._host_rows(bids)
        self._parked[tenant] = {"s_sums": s, "counts": c}
        for bid in bids:
            self.pool.free(bid)
        self.tables[tenant] = []

    def unpark(self, tenant: int) -> None:
        """Re-allocate blocks and write the parked fp32 bytes back."""
        blob = self._parked.pop(tenant, None)
        if blob is None:
            return
        n = blob["s_sums"].shape[0]
        bids = []
        try:
            for _ in range(n):
                bids.append(self.pool.alloc())
        except Exception:
            for bid in bids:
                self.pool.free(bid)
            self._parked[tenant] = blob  # a failed unpark leaves it parked
            raise
        if bids:
            idx = torch.tensor(bids, dtype=torch.long, device=self.device)
            self.s_sums[idx] = torch.from_numpy(blob["s_sums"]).to(self.device)
            self.counts[idx] = torch.from_numpy(blob["counts"]).to(self.device)
        self.tables[tenant] = bids

    # -- persistence --------------------------------------------------------
    def pack(self, tenant: int) -> dict:
        """JSON-able host copy of the tenant's bank (resident or parked):
        rows flattened to (blocks * block_ways, V), so it restores into any
        pool with the same block_ways."""
        if tenant in self._parked:
            s, c = self._parked[tenant]["s_sums"], self._parked[tenant]["counts"]
        else:
            s, c = self._host_rows(self.tables[tenant])
        return {"s_sums": s.reshape(-1, self.dim).tolist(),
                "counts": c.reshape(-1).tolist(),
                "n_ways": int(self.n_ways[tenant])}

    def adopt(self, tenant: int, packed: dict) -> None:
        """Create ``tenant`` from a ``pack`` blob, parked (zero device
        rows): residency comes back on first use."""
        self.create(tenant)
        n_ways = int(packed["n_ways"])
        s = np.asarray(packed["s_sums"], np.float32).reshape(-1, self.dim)
        c = np.asarray(packed["counts"], np.float32).reshape(-1)
        n_blocks = -(-n_ways // self.block_ways)
        need = n_blocks * self.block_ways
        if s.shape[0] < need:
            pad = need - s.shape[0]
            s = np.concatenate([s, np.zeros((pad, self.dim), np.float32)])
            c = np.concatenate([c, np.zeros((pad,), np.float32)])
        self.n_ways[tenant] = n_ways
        self._parked[tenant] = {
            "s_sums": s[:need].reshape(n_blocks, self.block_ways, self.dim),
            "counts": c[:need].reshape(n_blocks, self.block_ways)}

    # -- the tick's view ----------------------------------------------------
    def slot_tables(self, tenant_of_slot) -> tuple[np.ndarray, np.ndarray]:
        """Per-slot gather view for ``paged_bank_fc``: a NULL-padded
        (S, max_tenant_blocks) int32 block table and the (S,) way counts.
        Slots whose tenant is absent or parked read all-NULL rows with a
        way count of 0 (every row masked to -inf)."""
        S = len(tenant_of_slot)
        tables = np.full((S, self.max_tenant_blocks), NULL_BLOCK, np.int32)
        ways = np.zeros(S, np.int32)
        for s, t in enumerate(tenant_of_slot):
            t = int(t)
            if t < 0 or t in self._parked or t not in self.n_ways:
                continue
            bids = self.tables[t]
            tables[s, :len(bids)] = bids
            ways[s] = self.n_ways[t]
        return tables, ways

    def stats(self) -> dict:
        return {"blocks_live": self.pool.n_live,
                "blocks_free": self.pool.n_free,
                "block_ways": self.block_ways,
                "resident_tenants": sum(1 for t in self.n_ways
                                        if t not in self._parked),
                "parked_tenants": len(self._parked)}


def paged_bank_fc(s_sums_pool: torch.Tensor, counts_pool: torch.Tensor,
                  tables: torch.Tensor, n_ways: torch.Tensor):
    """FC weights/bias per SLOT from the paged pool: ``store_fc`` over a
    block-table gather.  tables (S, MB) block ids (NULL-padded); n_ways
    (S,).  Returns W (S, MB*BW, V), b (S, MB*BW), every row >= n_ways[s]
    masked to bias -inf."""
    tables = tables.long()
    s = s_sums_pool[tables]                   # (S, MB, BW, V)
    c = counts_pool[tables]                   # (S, MB, BW)
    S, MB, BW, V = s.shape
    s = s.reshape(S, MB * BW, V)
    c = c.reshape(S, MB * BW)
    w = s / torch.clamp(c, min=1.0)[..., None]
    b = -sum_last(w * w) / 2.0
    live = torch.arange(MB * BW, device=w.device)[None, :] \
        < n_ways.long()[:, None]
    return w, torch.where(live, b, torch.full_like(b, -math.inf))
