"""Per-tenant prototype banks — the FSL/CL personalization layer (§III-A),
dense layout.

The port of ``repro/sessions/tenancy.py``: ``TenantBank`` stacks up to
``max_tenants`` PrototypeStores into one (T, max_ways, V) table so every
slot classifies against its own tenant's keyword set in one batched
contraction (core/protonet.pn_logits_banked; the service gathers each
slot's rows once a push and contracts with pn_logits_rows).  Updates return a new bank,
as in the reference; the index arithmetic stays on the device.
``bank_pspecs`` lays the tenant axis over a device mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.protonet import PrototypeStore, store_fc
from repro_torch.sharding.rules import DEFAULT_RULES, pspec_sized, resolve_rules


class TenantBank(NamedTuple):
    """Stacked PrototypeStores: one row per tenant."""
    s_sums: torch.Tensor   # (T, max_ways, V)
    counts: torch.Tensor   # (T, max_ways)
    n_ways: torch.Tensor   # (T,) int32


def bank_init(max_tenants: int, max_ways: int, dim: int,
              device="cuda") -> TenantBank:
    return TenantBank(
        s_sums=torch.zeros((max_tenants, max_ways, dim), device=device),
        counts=torch.zeros((max_tenants, max_ways), device=device),
        n_ways=torch.zeros((max_tenants,), dtype=torch.int32, device=device))


def bank_pspecs(bank: TenantBank, mesh, rules: dict | None = None) -> TenantBank:
    """Spec tree for a TenantBank: the leading tenant axis goes to the mesh
    axis the "tenants" logical rule names (``model`` by default); ways and
    embedding dims stay replicated.  Divisibility-gated, so a bank that
    does not divide the axis replicates instead of failing."""
    rules = resolve_rules(DEFAULT_RULES if rules is None else rules, mesh)

    def spec(leaf):
        axes = ("tenants",) + (None,) * (leaf.dim() - 1)
        return pspec_sized(axes, rules, tuple(leaf.shape), mesh)

    return TenantBank(*(spec(leaf) for leaf in bank))


def bank_store(bank: TenantBank, tenant: int) -> PrototypeStore:
    """View one tenant's row as a standalone PrototypeStore (views of the
    bank's tensors: no copy)."""
    return PrototypeStore(s_sums=bank.s_sums[tenant],
                          counts=bank.counts[tenant],
                          n_ways=bank.n_ways[tenant])


def bank_set_store(bank: TenantBank, tenant: int,
                   store: PrototypeStore) -> TenantBank:
    """A new bank with ``tenant``'s row replaced by ``store``; ``bank``
    is left as it was."""
    s_sums, counts, n_ways = (bank.s_sums.clone(), bank.counts.clone(),
                              bank.n_ways.clone())
    s_sums[tenant] = store.s_sums
    counts[tenant] = store.counts
    n_ways[tenant] = store.n_ways
    return TenantBank(s_sums, counts, n_ways)


def bank_add_class(bank: TenantBank, tenant: int,
                   shot_embeddings: torch.Tensor) -> TenantBank:
    """Enroll one new way for ``tenant`` from its (k, V) shot embeddings.
    At max_ways the update is a masked no-op (the store_add_class
    overflow contract); counts use set, not add."""
    max_ways = bank.s_sums.shape[1]
    n = bank.n_ways[tenant]
    ok = n < max_ways
    hit = (torch.arange(max_ways, device=n.device)
           == torch.clamp(n, max=max_ways - 1)) & ok
    s = shot_embeddings.to(torch.float32).sum(dim=0)
    s_sums, counts, n_ways = (bank.s_sums.clone(), bank.counts.clone(),
                              bank.n_ways.clone())
    s_sums[tenant] = torch.where(hit[:, None], s[None, :], s_sums[tenant])
    counts[tenant] = torch.where(
        hit, torch.full_like(counts[tenant], float(shot_embeddings.shape[0])),
        counts[tenant])
    n_ways[tenant] += ok.to(torch.int32)
    return TenantBank(s_sums, counts, n_ways)


def bank_update_class(bank: TenantBank, tenant: int, way: int,
                      shot_embeddings: torch.Tensor) -> TenantBank:
    """Refine an existing way with more shots (prototype refinement, Eq. 3)."""
    s_sums, counts = bank.s_sums.clone(), bank.counts.clone()
    s_sums[tenant, way] += shot_embeddings.to(torch.float32).sum(dim=0)
    counts[tenant, way] += shot_embeddings.shape[0]
    return TenantBank(s_sums, counts, bank.n_ways)


def bank_clear_tenant(bank: TenantBank, tenant: int) -> TenantBank:
    """Free a tenant row (tenant closed) for reuse."""
    s_sums, counts, n_ways = (bank.s_sums.clone(), bank.counts.clone(),
                              bank.n_ways.clone())
    s_sums[tenant] = 0.0
    counts[tenant] = 0.0
    n_ways[tenant] = 0
    return TenantBank(s_sums, counts, n_ways)


def bank_fc(bank: TenantBank):
    """Stacked FC tables: W (T, max_ways, V), b (T, max_ways) — store_fc
    over the tenant axis; unlearned ways get bias -inf per tenant."""
    return store_fc(PrototypeStore(bank.s_sums, bank.counts, bank.n_ways))


def bank_pack_tenant(bank: TenantBank, tenant: int) -> dict:
    """Host copy of one tenant's row (numpy, the reference's layout)."""
    return {"s_sums": bank.s_sums[tenant].to("cpu", copy=True).numpy(),
            "counts": bank.counts[tenant].to("cpu", copy=True).numpy(),
            "n_ways": bank.n_ways[tenant].to("cpu", copy=True).numpy()}


def bank_unpack_tenant(bank: TenantBank, tenant: int,
                       packed: dict) -> TenantBank:
    s_sums, counts, n_ways = (bank.s_sums.clone(), bank.counts.clone(),
                              bank.n_ways.clone())
    s_sums[tenant] = torch.tensor(np.asarray(packed["s_sums"]))
    counts[tenant] = torch.tensor(np.asarray(packed["counts"]))
    n_ways[tenant] = int(np.asarray(packed["n_ways"]))
    return TenantBank(s_sums, counts, n_ways)


def bank_row_bytes(bank: TenantBank) -> int:
    """Host bytes of one tenant row (the per-tenant spill cost)."""
    per = (bank.s_sums.numel() * 4 + bank.counts.numel() * 4) \
        // bank.s_sums.shape[0]
    return int(per + bank.n_ways.element_size())
