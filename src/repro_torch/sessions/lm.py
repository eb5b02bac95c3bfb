"""LM serving sessions: KV-cache park/resume, chunked multi-token decode,
chunked prefill, paged KV with copy-on-write prefix sharing.

The port of ``repro/sessions/lm.py`` (every LM family the port builds:
dense, MoE and vlm with GQA or MLA caches, the encoder-decoder, RWKV, the
zamba hybrid).  The slot-grid
virtualization of the TCN service applies — more sessions than slots,
LRU/cost eviction to a host parking lot, bit-identical resume in any
slot — but a slot's state is a cache column (every cache leaf sliced
along its session axis) and a tick is a token chunk: ``decode_scan``
runs up to ``t_chunk`` greedy decode steps of every lane per dispatch.

Per-lane positions.  The reference runs each lane as a ``jax.vmap`` body
of a B=1 decode at its own ``pos``.  Here one batched ``decode_fn`` call
advances all ``n_slots`` lanes with a (B,) position vector: each lane
writes its K/V row at ``pos[s]`` (an index write) and attends over its own
``kv_len = pos[s] + 1``.  A lane's bits depend only on its own inputs and
the fixed batch shape, so admitting, parking or interleaving other
sessions never perturbs it, and since every step runs the same shapes a
chunked decode equals ``t_chunk=1`` bit for bit.  The reference's masking
rule is kept exactly: a masked step still writes its (never read) K/V at
the lane's frozen position, so every bound lane must be passed its TRUE
position even when it is not decoded (position 0 would overwrite live
history).  A MoE FFN allocates expert capacity per sequence, so a lane's
routing is its own too.

Recurrent leaves (RWKV's token-shift rows and wkv state, Mamba's conv
ring and ssm state: no sequence axis) change at every step, so they are
masked by value: the bundle's cached call returns them as new tensors and
leaves the old ones intact, and the scan keeps ``torch.where(valid, new,
old)`` per lane.  The encoder-decoder's cross K/V (ENCDEC_ENC_LEN rows, no
sequence axis: no session entry point takes frames, so they stay zero, as
in the reference) count as such leaves too, but a step returns them
untouched, so they pass through the mask unread.  A service with such a
leaf is not ``parallel_safe``: the chunk forms of these recurrences are
reassociated, so it has no chunked prefill and no prefix sharing, and
``open_session`` feeds nothing: the first ``decode`` feeds the whole
prompt as forced tokens.  Its parked blob
holds every recurrent leaf whole beside the KV rows [0, pos)
(``kv_park_bytes`` = a fixed part + a part per position).

Chunked prefill.  ``open_session`` feeds all but the last prompt token
through the bundle's multi-token ``step_fn`` in largest-first power-of-two
chunks (``pow2_chunks``); the last token stays pending so the first
sampled token comes from the decode scan's S=1 program.  A chunk's GEMMs
run at another M than the decode's, so its K/V rows may round otherwise
in fp32, and the bf16 casts after each layer (the residual, the softmax
probabilities) carry that into later layers: the cache is not bit-equal
to token-at-a-time prefill (the reference's own bit-exact assert fails on
jax 0.9's CPU).  Held instead: layer 0's K/V within one bf16 ulp of the
layer's scale, every layer's K/V and the next-step logits within 5e-2 of
their scale; at full depth the greedy streams may part at near ties.

Paged KV (``paged=True``).  Every cache leaf with a sequence axis becomes
a shared block pool (sessions/state.make_pools) read through per-lane
int32 block tables; recurrent leaves stay dense per slot, and a bundle
with no sequence-axis leaf (RWKV) stays dense altogether.  A parked
session owns no device block.  A decode dispatch gathers every
lane's table row into the exact dense column once (state.gather_column),
runs the dense scan on it, and writes back each lane's rows [pos,
pos + T) through its table (unowned blocks map to the NULL block 0, which
absorbs them), so paged == dense bit for bit.  Full prompt blocks are
registered in a ``PrefixCache``: a later session whose prompt starts with
the same blocks adopts them by reference and skips their prefill; a block
is cloned before a lane may write it (copy-on-write).

Params are baked once at construction (models/transformer.bake_lm_params:
every leaf in the activation dtype, the reference's per-use cast).
Positions are int32 host mirrors; a session reaching ``seq_cap`` is
retired (slot freed, outputs kept).  A parked blob is the column truncated
to [0, pos) (dense) or the session's blocks (paged), so parked bytes are
O(pos); the default eviction cost is that size.  bf16 leaves are parked
as their bits (utils/host.py) and spill in the reference's file format.

Passing ``mesh=`` (a ``DeviceMesh`` of launch/mesh.py, one process per
rank) shards every cache leaf's session axis over the mesh's ``data``
axis (sessions/state.column_pspecs): ``cache`` holds DTensors, and it
stays sharded across dispatches.  Dense caches only: ``paged=True`` with
a mesh raises.  Every rank makes the same calls with the same arguments;
each decodes its own lanes with the whole (replicated) params, prefills
only the columns it holds, and the tokens of a dispatch are gathered, so
every rank returns the same streams.  A slot's owner packs its column
and sends the blob to every rank.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.runtime import RuntimeConfig
from repro_torch.models.transformer import bake_lm_params
from repro_torch.obs.device import occupancy_stats
from repro_torch.sessions.paging import (
    BlockPool,
    PoolExhausted,
    PrefixCache,
    prefix_keys,
)
from repro_torch.sessions.service import SessionRecord, SlotGridService
from repro_torch.sessions.state import (
    PAGED_MARKER,
    column_pspecs,
    copy_block,
    gather_column,
    leaf_axes,
    make_pools,
    map_tree,
    pack_blocks,
    pack_column,
    paged_flags,
    scatter_rows,
    unpack_blocks,
    unpack_column,
)
from repro_torch.sharding import spmd
from repro_torch.utils.host import to_host
from repro_torch.utils.trees import tree_leaves


def lane_select(valid, new, old, bax: int):
    """``torch.where(valid, new, old)`` per lane of a leaf whose session
    axis is ``bax``: the value mask of a recurrent leaf."""
    shape = (1,) * bax + (-1,) + (1,) * (new.dim() - bax - 1)
    return torch.where(valid.reshape(shape), new, old)


def recurrent_flags(seq_axes):
    """Per-leaf bool tree: True where the leaf has no sequence axis (it is
    carried by value); None when no leaf is recurrent."""
    flags = map_tree(lambda sax: sax < 0, seq_axes)
    return flags if any(tree_leaves(flags)) else None


def mask_recurrent(valid, new, old, batch_axes, rec):
    """The per-leaf masking of one step: KV leaves as the step left them
    (masked by position), recurrent leaves ``lane_select``-ed.  A leaf
    without a sequence axis that the step returned untouched (the very
    tensor it was given: the encoder-decoder's cross K/V) passes through,
    which is ``where(v, x, x)`` bit for bit without reading it."""
    if rec is None:
        return new
    return map_tree(lambda n, o, bax, r: lane_select(valid, n, o, bax)
                    if r and n is not o else n, new, old, batch_axes, rec)


def make_decode_scan(decode_fn, batch_axes, seq_axes):
    """A chunked greedy decoder from a bundle's batched single-step
    decode.  Returns ``scan(params, cache, tok, pos, inp, n_inp, n_steps)``:

      cache               the batched cache (KV leaves written in place,
                          recurrent leaves replaced)
      tok     (S,) i32    pending feedback token per lane
      pos     (S,) i32    per-lane position (every bound lane's TRUE one)
      inp     (S, T) i32  forced (prompt) tokens, consumed left to right
      n_inp   (S,) i32    forced-token count per lane
      n_steps (S,) i32    valid steps per lane (<= T); the rest are masked

    Step j of lane s feeds ``inp[s, j]`` while ``j < n_inp[s]``, else the
    previous argmax, at position ``pos[s]`` (advanced by valid steps
    only).  KV leaves are masked by position (a masked step writes its row
    at the lane's frozen position, never read); leaves without a sequence
    axis (``seq_axes`` -1) are masked by value (``lane_select`` of the
    step's new tensors against the old, which the step left intact).
    Returns ``(cache, tok, pos, y (S, T) i32)``, ``y[s, j]`` the argmax
    after step j (callers mask by their emission rule)."""
    rec = recurrent_flags(seq_axes)

    def scan(params, cache, tok, pos, inp, n_inp, n_steps):
        ys = []
        for j in range(inp.shape[1]):
            t = torch.where(j < n_inp, inp[:, j], tok)
            logits, new = decode_fn(params, cache,
                                    {"tokens": t[:, None], "pos": pos})
            y = torch.argmax(logits, dim=-1).to(torch.int32)
            v = j < n_steps
            cache = mask_recurrent(v, new, cache, batch_axes, rec)
            tok = torch.where(v, y, tok)
            pos = torch.where(v, pos + 1, pos)
            ys.append(y)
        return cache, tok, pos, torch.stack(ys, dim=1)

    return scan


def gather_columns(cache, tables, batch_axes, seq_axes):
    """Every lane's dense column of each pool leaf of a paged cache (its
    table row gathered); recurrent leaves, dense already, as they are."""
    return map_tree(lambda a, bax, sax: gather_column(a, tables, bax)
                    if sax >= 0 else a, cache, batch_axes, seq_axes)


def scatter_columns(cache, cols, tables, pos0, n: int, batch_axes,
                    seq_axes):
    """Write rows [pos0, pos0 + n) of every lane (clipped to the column)
    of each pool leaf back through the lanes' tables, in place; a
    recurrent leaf becomes the columns' (value-masked) one.  Returns the
    cache tree."""
    def put(a, c, bax, sax):
        if sax < 0:
            return c
        rows = torch.clamp(pos0[:, None].long() + torch.arange(
            n, device=a.device), max=c.shape[sax] - 1)
        scatter_rows(a, c, tables, rows, bax)
        return a

    return map_tree(put, cache, cols, batch_axes, seq_axes)


def make_decode_scan_paged(decode_fn, batch_axes, seq_axes):
    """Paged twin of ``make_decode_scan``: ``scan(params, cache, tables,
    tok, pos, inp, n_inp, n_steps)`` with ``tables`` (S, max_blocks) int32
    and every sequence-axis leaf of ``cache`` a shared pool (recurrent
    leaves stay dense per slot).  Each lane's table row is gathered into
    its exact dense column once, the dense scan runs on the columns, and
    each lane's rows [pos, pos + T) (clipped to the column) go back
    through its table: its own blocks get their bytes (new rows and
    untouched ones alike), unowned entries the NULL block.  Shared prefix
    blocks lie below every lane's position, so no write reaches them."""
    dense = make_decode_scan(decode_fn, batch_axes, seq_axes)

    def scan(params, cache, tables, tok, pos, inp, n_inp, n_steps):
        cols = gather_columns(cache, tables, batch_axes, seq_axes)
        cols, tok2, pos2, ys = dense(params, cols, tok, pos, inp, n_inp,
                                     n_steps)
        cache = scatter_columns(cache, cols, tables, pos, inp.shape[1],
                                batch_axes, seq_axes)
        return cache, tok2, pos2, ys

    return scan


def make_prefill_column(step_fn, batch_axes):
    """The chunked-prefill step on a dense grid: ``prefill(params, cache,
    slot, tokens (1, S), pos)`` runs the bundle's multi-token ``step_fn``
    on the slot's column (views of the grid, written in place)."""

    def prefill(params, cache, slot, tokens, pos):
        col = map_tree(lambda a, ax: a.narrow(ax, slot, 1), cache, batch_axes)
        step_fn(params, col, {"tokens": tokens, "pos": pos})
        return cache

    return prefill


def make_prefill_paged(step_fn, batch_axes):
    """Paged twin of ``make_prefill_column``: ``prefill(params, cache, row
    (max_blocks,) i32, tokens (1, S), pos)`` gathers the lane's column
    through its table row, runs the same ``step_fn`` on it and writes its
    rows [pos, pos + S) back through the row."""

    def prefill(params, cache, row, tokens, pos):
        rows = row[None]
        cols = map_tree(lambda a, bax: gather_column(a, rows, bax),
                        cache, batch_axes)
        step_fn(params, cols, {"tokens": tokens, "pos": pos})
        n = tokens.shape[1]
        where = torch.arange(pos, pos + n, device=row.device)[None]
        map_tree(lambda a, c, bax: scatter_rows(a, c, rows, where, bax),
                 cache, cols, batch_axes)
        return cache

    return prefill


def pow2_chunks(n: int, cap: int) -> list[int]:
    """Largest-first power-of-two decomposition of ``n`` with chunks <= cap:
    the prefill chunk schedule (an exact partition: every fed token writes
    cache rows, so chunks cannot pad; log2(cap)+1 chunk shapes at most)."""
    if cap < 1:
        raise ValueError(f"chunk cap must be >= 1, got {cap}")
    cap = 1 << (cap.bit_length() - 1)  # round down to a power of two
    out = []
    while n > 0:
        c = min(cap, 1 << (n.bit_length() - 1))
        out.append(c)
        n -= c
    return out


@dataclass
class _LMSession(SessionRecord):
    prompt: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    tok: int = 0        # pending greedy feedback token
    done: bool = False  # retired at seq_cap (outputs kept, slot freed)


class LMSessionService(SlotGridService):
    """Slot-grid LM serving with KV park/resume and chunked decode, on the
    bundle's device.

    ``open_session(prompt)`` admits a request (evicting an idle session if
    the grid is full) and chunk-prefills its prompt; ``decode({sid: n})``
    greedily generates n tokens per session in dispatches of up to
    ``t_chunk`` steps.  Device state is only the cache grid; positions,
    pending prompts and feedback tokens are int32 host mirrors.
    ``outputs[sid]`` survives close and retirement."""

    _session_cls = _LMSession
    _service_name = "lm"

    def __init__(self, bundle, params, *, n_slots: int = 8,
                 seq_cap: int = 512, t_chunk: int = 16,
                 max_sessions: int | None = None, prefill_chunk: int = 64,
                 cost_fn=None, stale_window: int = 0, metrics=None,
                 tracer=None, device_counters: bool | None = None,
                 paged: bool | None = None, block_len: int = 16,
                 n_blocks: int | None = None, prefix_cache: bool = True,
                 runtime: RuntimeConfig | None = None, mesh=None):
        if cost_fn is None:
            cost_fn = self._park_cost  # O(pos) bytes: cost-aware by default
        super().__init__(n_slots, t_chunk=t_chunk, max_sessions=max_sessions,
                         cost_fn=cost_fn, stale_window=stale_window,
                         metrics=metrics, tracer=tracer,
                         device_counters=device_counters, runtime=runtime)
        self.bundle = bundle
        self.device = bundle.device
        self.seq_cap = int(seq_cap)
        self._params = bake_lm_params(params, bundle.cfg)
        specs = bundle.cache_specs(n_slots, self.seq_cap)
        # per-leaf session/sequence axes by diffing shape trees on meta,
        # never by matching extents that might coincide with n_slots
        self._batch_axes = leaf_axes(
            lambda: specs, lambda: bundle.cache_specs(n_slots + 1,
                                                      self.seq_cap))
        self._seq_axes = leaf_axes(
            lambda: specs, lambda: bundle.cache_specs(n_slots,
                                                      self.seq_cap + 1))
        if any(ax < 0 for ax in tree_leaves(self._batch_axes)):
            raise ValueError("cache has a leaf without a per-session axis; "
                             "cannot virtualize slots")
        # chunked prefill and prefix sharing only where every leaf is
        # position-indexed: a recurrent leaf (RWKV, Mamba) advances by
        # value through a chunk form that is not bit for bit the steps
        self.parallel_safe = all(sax >= 0
                                 for sax in tree_leaves(self._seq_axes))
        # a bundle with no sequence-axis leaf (RWKV) has nothing to page
        # and silently stays dense
        self.paged = bool(self.runtime.pick("paged", paged)) and any(
            sax >= 0 for sax in tree_leaves(self._seq_axes))
        self._paged_flags = paged_flags(self._batch_axes, self._seq_axes)
        self.block_len = int(block_len)
        if self.paged and mesh is not None:
            raise ValueError("paged=True does not compose with mesh= "
                             "sharding yet; use the dense layout on meshes")
        self.mesh = mesh
        if self.paged and self.seq_cap % self.block_len:
            raise ValueError(f"seq_cap={self.seq_cap} must be a multiple "
                             f"of block_len={self.block_len}")
        if self.paged:
            self.max_blocks = self.seq_cap // self.block_len
            # default pool = the dense layout's bytes (n_slots full columns)
            self.pool = BlockPool(int(n_blocks) if n_blocks is not None
                                  else n_slots * self.max_blocks)
            self.cache = make_pools(specs, self._batch_axes, self._seq_axes,
                                    self.pool.extent, self.block_len,
                                    self.device)
            self._table = np.zeros((n_slots, self.max_blocks), np.int32)
            self._blocks: dict[int, list[int]] = {}
            # a recurrent leaf cannot skip prompt steps by adopting rows
            self._prefix = (PrefixCache(self.pool)
                            if prefix_cache and self.parallel_safe else None)
            reg = self.metrics_registry
            reg.gauge("pool_blocks_total", service=self._service_name).set(
                self.pool.n_blocks)
            self._g_pool_free = reg.gauge(
                "pool_blocks_free", service=self._service_name)
            self._g_pool_live = reg.gauge(
                "pool_blocks_live", service=self._service_name)
            self._g_pool_shared = reg.gauge(
                "pool_blocks_cow_shared", service=self._service_name)
            self._update_pool_gauges()
        elif mesh is None:
            self.cache = bundle.empty_cache(n_slots, self.seq_cap)
        else:  # sessions over data: each rank allocates its own lanes only
            self._cache_specs = column_pspecs(specs, self._batch_axes, mesh)
            entries = []  # every leaf's session-axis entry: all alike
            map_tree(lambda sp, bax: entries.append(
                sp[bax] if len(sp) > bax else None),
                     self._cache_specs, self._batch_axes)
            self._set_slot_entry(entries[0])
            self._set_cache(bundle.empty_cache(
                self._slot_hi - self._slot_lo, self.seq_cap))
        # closed-form parked footprint of one column: sequence-axis leaves
        # per position, recurrent leaves whole
        self._park_fixed = self._park_per_pos = 0
        for leaf, bax, sax in zip(tree_leaves(specs),
                                  tree_leaves(self._batch_axes),
                                  tree_leaves(self._seq_axes)):
            per = leaf.numel() // leaf.shape[bax] * leaf.element_size()
            if sax >= 0:
                self._park_per_pos += per // self.seq_cap
            else:
                self._park_fixed += per
        self.outputs: dict[int, list[int]] = {}
        if self.paged:
            self._decode_scan = make_decode_scan_paged(
                bundle.decode_fn, self._batch_axes, self._seq_axes)
        else:
            self._decode_scan = make_decode_scan(
                bundle.decode_fn, self._batch_axes, self._seq_axes)
        self.prefill_chunk = int(prefill_chunk) \
            if prefill_chunk and self.parallel_safe else 0
        if self.prefill_chunk:
            self._prefill_col = (
                make_prefill_paged(bundle.step_fn, self._batch_axes)
                if self.paged
                else make_prefill_column(bundle.step_fn, self._batch_axes))

    # -- block-pool management (paged only) ---------------------------------
    def _update_pool_gauges(self) -> None:
        self._g_pool_free.set(self.pool.n_free)
        self._g_pool_live.set(self.pool.n_live)
        self._g_pool_shared.set(self.pool.n_shared)

    def _device_table(self) -> torch.Tensor:
        """The per-lane block tables on the device, copied from the int32
        host mirror (n_slots x max_blocks)."""
        return torch.from_numpy(self._table).to(self.device)

    def _alloc_blocks(self, n: int) -> list[int]:
        """O(1) a block; a dry pool first releases LRU prefix-registry
        pins.  All or nothing: on exhaustion the partial allocation is
        rolled back and ``PoolExhausted`` (an AdmissionError) propagates."""
        out: list[int] = []
        try:
            for _ in range(n):
                while (self.pool.n_free == 0 and self._prefix is not None
                       and self._prefix.release_lru()):
                    pass
                out.append(self.pool.alloc())
        except PoolExhausted:
            for b in reversed(out):
                self.pool.free(b)
            raise PoolExhausted(
                f"block pool exhausted ({self.pool.n_live}/"
                f"{self.pool.n_blocks} blocks live, "
                f"{len(self.sched.slot_of)} bound sessions); close or park "
                f"sessions, or grow n_blocks") from None
        return out

    def _ensure_blocks(self, sid: int, start: int, end: int) -> None:
        """Grow ``sid``'s table to cover rows [0, end) and make the write
        range [start, end) exclusively owned (copy-on-write: a shared
        block is cloned into a fresh one before the lane may write it)."""
        if not self.paged or end <= 0:
            return
        bl = self.block_len
        need = min(-(-end // bl), self.max_blocks)
        bids = self._blocks.setdefault(sid, [])
        slot = self.sched.slot_of[sid]
        while len(bids) < need:
            bid = self._alloc_blocks(1)[0]
            self._table[slot, len(bids)] = bid
            bids.append(bid)
        for i in range(max(start // bl, 0), need):
            nb, src = self.pool.writable(bids[i])
            if src is not None:  # shared: clone device bytes src -> nb
                map_tree(lambda a, bax, pg:
                         copy_block(a, src, nb, bax) if pg else a,
                         self.cache, self._batch_axes, self._paged_flags)
                bids[i] = nb
                self._table[slot, i] = nb
        self._update_pool_gauges()

    def _trim_blocks(self, sid: int) -> None:
        """Free the blocks wholly past the session's position: the paged
        form of a speculative rollback (the rejected suffix's blocks go
        back to the pool; its rows in the kept block are dead by
        position)."""
        if not self.paged:
            return
        bids = self._blocks.get(sid)
        if not bids:
            return
        keep = min(len(bids), -(-self.sessions[sid].steps // self.block_len))
        if keep == len(bids):
            return
        for b in bids[keep:]:
            self.pool.free(b)
        del bids[keep:]
        slot = self.sched.slot_of.get(sid)
        if slot is not None:
            self._table[slot, keep:] = 0
        self._update_pool_gauges()

    def _free_session_blocks(self, sid: int) -> None:
        for b in self._blocks.pop(sid, []):
            self.pool.free(b)

    def _cache(self):
        """The cache this rank computes on: ``cache`` itself, or on a mesh
        its local shards (they share storage with the DTensors)."""
        return self.cache if self.mesh is None else self._cache_local

    def _set_cache(self, local) -> None:
        if self.mesh is None:
            self.cache = local
        else:
            self._cache_local = local
            self.cache = map_tree(
                lambda a, sp: spmd.wrap(a, self.mesh, sp), local,
                self._cache_specs)

    def _upload(self, *arrays) -> list[torch.Tensor]:
        """Host int32 arrays to the device in one copy, split there."""
        flat = np.concatenate([np.asarray(a, np.int32).ravel()
                               for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, off = [], 0
        for a in arrays:
            n = int(np.size(a))
            out.append(dev[off:off + n].reshape(np.shape(a)))
            off += n
        return out

    # -- slot-column state hooks --------------------------------------------
    def _pack(self, slot: int, sid: int) -> dict:
        sess = self.sessions[sid]
        if not self.paged:
            return {"kv": self._from_slot(slot, lambda s: pack_column(
                self._cache(), self._batch_axes, s,
                trunc_axes=self._seq_axes, trunc_len=sess.steps))}
        # paged park: the blocks covering [0, steps) only (recurrent
        # leaves: the slot's column whole), then the session's device
        # blocks are freed (resume allocates fresh ones); the [block_len,
        # n_keep] marker makes another layout refuse it
        bids = self._blocks.get(sid, [])
        n_keep = min(len(bids), -(-sess.steps // self.block_len))
        keep = bids[:n_keep]
        blob = map_tree(lambda a, bax, pg: pack_blocks(a, keep, bax) if pg
                        else to_host(a.select(bax, slot)),
                        self.cache, self._batch_axes, self._paged_flags)
        self._free_session_blocks(sid)
        self._update_pool_gauges()
        return {"kv": blob,
                PAGED_MARKER: np.asarray([self.block_len, n_keep], np.int32)}

    def _unpack(self, slot: int, blob: dict) -> None:
        if not self.paged:
            if self._holds_slot(slot):
                unpack_column(self._cache(), self._batch_axes,
                              slot - self._slot_lo, blob["kv"])
            return
        sid = self.sched.sid_of[slot]
        n_keep = int(np.asarray(blob[PAGED_MARKER]).reshape(-1)[1])
        bids = self._alloc_blocks(n_keep)
        self._blocks[sid] = bids
        self._table[slot, :] = 0
        self._table[slot, :n_keep] = bids
        map_tree(lambda a, bax, pg, p: unpack_blocks(a, bids, p, bax) if pg
                 else unpack_column({"x": a}, {"x": bax}, slot, {"x": p}),
                 self.cache, self._batch_axes, self._paged_flags, blob["kv"])
        self._update_pool_gauges()

    def _reset(self, slot: int) -> None:
        if not self.paged:
            if self._holds_slot(slot):
                map_tree(lambda a, ax: a.select(
                    ax, slot - self._slot_lo).zero_(),
                         self._cache(), self._batch_axes)
            return
        # O(1) admission: clearing the host table row makes every stale
        # pool byte unreachable (reads past a lane's kv_len are masked and
        # the NULL block absorbs masked writes), so no pool is scrubbed;
        # recurrent leaves are carried by value, so the slot's are zeroed
        self._blocks[self.sched.sid_of[slot]] = []
        self._table[slot, :] = 0
        map_tree(lambda a, bax, pg: a if pg else a.select(bax, slot).zero_(),
                 self.cache, self._batch_axes, self._paged_flags)

    def _on_unbind(self, slot: int) -> None:
        # an unbound slot's table row must be all NULL: a masked lane's
        # writes follow its row, and only NULL may absorb them
        if self.paged:
            self._table[slot, :] = 0

    def _on_close(self, sid: int, sess) -> None:
        if self.paged:
            self._free_session_blocks(sid)
            self._update_pool_gauges()

    # -- cost model ---------------------------------------------------------
    def _park_cost(self, sid: int) -> float:
        """Host bytes this session would occupy parked: O(pos), rounded up
        to whole blocks when paged."""
        steps = self.sessions[sid].steps
        if self.paged:
            steps = -(-steps // self.block_len) * self.block_len
        return float(self.kv_park_bytes(steps))

    def kv_park_bytes(self, pos: int) -> int:
        """Structural parked footprint of a session at position ``pos``
        (content-independent): sequence-axis leaves scale with pos,
        recurrent leaves count whole."""
        return self._park_fixed + self._park_per_pos * min(pos, self.seq_cap)

    # -- session lifecycle --------------------------------------------------
    def open_session(self, prompt) -> int:
        """Admit a request and chunk-prefill all but its last prompt token
        (``pow2_chunks`` of at most ``prefill_chunk``; 0, and every service
        that is not ``parallel_safe``, feeds the whole prompt through the
        first decode's forced-token steps instead).
        A paged service first adopts the prompt's registered prefix
        blocks.  ``PoolExhausted`` undoes the admission before it
        propagates."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size >= self.seq_cap:
            raise ValueError(f"prompt of {prompt.size} tokens >= "
                             f"seq_cap={self.seq_cap}")
        sid = self._alloc_sid()
        self.sched.admit(sid)  # may raise AdmissionError (back-pressure)
        self.sessions[sid] = _LMSession(prompt=prompt)
        self.outputs[sid] = []
        try:
            self._bind(sid)
            if self.prefill_chunk and prompt.size > 1:
                self._prefill_prompt(sid, prompt)
        except PoolExhausted:
            self._abort_open(sid)
            raise
        return sid

    def _abort_open(self, sid: int) -> None:
        if self.paged:
            self._free_session_blocks(sid)
            self._update_pool_gauges()
        slot = self.sched.release(sid)
        if slot is not None:
            self._on_unbind(slot)
        self.sessions.pop(sid, None)
        self.outputs.pop(sid, None)

    @torch.no_grad()
    def _prefill_prompt(self, sid: int, prompt: np.ndarray) -> None:
        slot = self.sched.slot_of[sid]
        off = 0
        if self.paged and self._prefix is not None:
            off = self._adopt_prefix(sid, slot, prompt)
            self.sessions[sid].steps = off
        toks_all = None
        for n in pow2_chunks(prompt.size - 1 - off, self.prefill_chunk):
            t0 = time.perf_counter()
            with self.tracer.span("prefill", cat="lm", sid=sid,
                                  shape=f"P{n}", pos=off):
                if toks_all is None:  # the whole body in one upload
                    toks_all, = self._upload(prompt)
                toks = toks_all[off:off + n][None]
                if self.paged:
                    self._ensure_blocks(sid, off, off + n)
                    row, = self._upload(self._table[slot])
                    self._prefill_col(self._params, self.cache, row, toks,
                                      off)
                elif self._holds_slot(slot):
                    self._prefill_col(self._params, self._cache(),
                                      slot - self._slot_lo, toks, off)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self._record_dispatch(time.perf_counter() - t0, f"P{n}")
            off += n
        self.sessions[sid].steps = off
        if self.paged and self._prefix is not None:
            self._register_prefix(sid, prompt)

    def _adopt_prefix(self, sid: int, slot: int, prompt) -> int:
        """Longest-prefix match of the prompt body's full blocks against
        the registry; hits are adopted by reference (no prefill, no new
        bytes).  Returns the adopted position offset."""
        keys = prefix_keys(prompt[:-1], self.block_len)
        hits = self._prefix.match(keys) if keys else []
        if not hits:
            return 0
        self._blocks.setdefault(sid, []).extend(hits)
        self._table[slot, :len(hits)] = hits
        self.metrics_registry.counter(
            "prefix_block_hits_total", service=self._service_name).inc(
                len(hits))
        self._update_pool_gauges()
        return len(hits) * self.block_len

    def _register_prefix(self, sid: int, prompt) -> None:
        """Register the session's full prompt-body blocks (each entry pins
        its block, surviving the donor's park)."""
        keys = prefix_keys(prompt[:-1], self.block_len)
        for key, bid in zip(keys, self._blocks.get(sid, [])):
            self._prefix.insert(key, bid)
        self._update_pool_gauges()

    def _retire(self, sid: int) -> None:
        """Take a session that hit seq_cap out of rotation: slot freed,
        outputs kept, record marked done (a further decode raises)."""
        if self.paged:
            slot = self.sched.slot_of.get(sid)
            if slot is not None:
                self._table[slot, :] = 0
            self._free_session_blocks(sid)
            self._update_pool_gauges()
        self.sched.release(sid)
        self.sessions[sid].done = True
        self.metrics_registry.counter("retired_total", service="lm").inc()
        self.tracer.instant("retire", cat="lm", sid=sid,
                            pos=self.sessions[sid].steps)

    # -- the hot path -------------------------------------------------------
    def _validate_want(self, want: dict[int, int]) -> None:
        if len(want) > self.n_slots:
            raise ValueError(
                f"{len(want)} sessions pushed but only {self.n_slots} slots; "
                "split the decode or grow the grid")
        for sid, n in want.items():
            if sid not in self.sessions:
                raise KeyError(f"unknown session {sid}")
            if self.sessions[sid].done:
                raise RuntimeError(f"session {sid} retired at "
                                   f"seq_cap={self.seq_cap}")
            if n < 0:
                raise ValueError(f"session {sid}: want {n} < 0")

    @torch.no_grad()
    def decode(self, want: dict[int, int]) -> dict[int, list[int]]:
        """Greedily generate ``want[sid]`` tokens per session (feeding any
        pending prompt first), in dispatches over the (S, T) grid with
        power-of-two padding buckets; absent sessions stay frozen.  Parked
        sessions are resumed first.  A session that would pass
        ``seq_cap`` is cut at the cap and retired.  Returns {sid: new
        tokens}."""
        self._validate_want(want)
        self._touch_and_bind(want)
        # emission rule: with Q = max(len(prompt), 1), step f emits a
        # token iff f >= Q - 1, so generated = max(0, fed - Q + 1)
        remaining = {}
        for sid, n in want.items():
            sess = self.sessions[sid]
            q = max(len(sess.prompt), 1)
            gen = max(0, sess.steps - q + 1)
            steps = gen + n + q - 1 - sess.steps
            steps = min(steps, self.seq_cap - sess.steps)  # overflow guard
            remaining[sid] = max(steps, 0)

        out = {sid: [] for sid in want}
        while any(remaining.values()):
            t_pad = self._tick_len(max(remaining.values()))
            inp = np.zeros((self.n_slots, t_pad), np.int32)
            n_inp = np.zeros(self.n_slots, np.int32)
            n_steps = np.zeros(self.n_slots, np.int32)
            tok = np.zeros(self.n_slots, np.int32)
            pos = np.zeros(self.n_slots, np.int32)
            # every BOUND lane carries its true position even when it is
            # not decoded: a masked step still writes (discarded) K/V at
            # row pos, harmless only at the lane's own frozen position
            for slot, bsid in self.sched.sid_of.items():
                pos[slot] = min(self.sessions[bsid].steps, self.seq_cap - 1)
            lanes = {}
            for sid, rem in remaining.items():
                if rem == 0:
                    continue
                sess = self.sessions[sid]
                s = self.sched.slot_of[sid]
                lanes[sid] = s
                n = min(rem, t_pad)
                if self.paged:  # CoW-safe blocks for this tick's writes
                    self._ensure_blocks(sid, sess.steps, sess.steps + n)
                feed = sess.prompt[sess.steps:sess.steps + n]
                inp[s, :feed.size] = feed
                n_inp[s] = feed.size
                n_steps[s] = n
                tok[s] = sess.tok
                pos[s] = sess.steps
            shape = f"T{t_pad}"
            t0 = time.perf_counter()
            with self.tracer.span("dispatch", cat="lm", shape=shape,
                                  lanes=len(lanes)):
                lo, hi = self._slot_lo, self._slot_hi  # this rank's lanes
                host = tuple(a[lo:hi] for a in (tok, pos, inp, n_inp,
                                                 n_steps))
                if self.paged:
                    host += (self._table,)
                args = self._upload(*host)
                if self.paged:
                    args = [args[5]] + args[:5]
                cache, tok_d, _, ys_d = self._decode_scan(
                    self._params, self._cache(), *args)
                self._set_cache(cache)
                steps_d = args[-1]
                if self._slot_entry is not None:  # every rank's lanes
                    both = self._gather_slots(
                        torch.cat([tok_d[:, None], ys_d], dim=1))
                    tok_d, ys_d = both[:, 0], both[:, 1:]
                    if self.device_counters:
                        steps_d, = self._upload(n_steps)
                occ = occupancy_stats(steps_d, t_pad).to(
                    "cpu", non_blocking=True) if self.device_counters \
                    else None
                tok2 = tok_d.cpu().numpy()
                ys = ys_d.cpu().numpy()
            self._record_dispatch(time.perf_counter() - t0, shape)
            if occ is not None:
                self._ingest_occupancy(occ.numpy())
            for sid, s in lanes.items():
                sess = self.sessions[sid]
                q = max(len(sess.prompt), 1)
                n = int(n_steps[s])
                emitted = [int(ys[s, j]) for j in range(n)
                           if sess.steps + j >= q - 1]
                self.outputs[sid].extend(emitted)
                out[sid].extend(emitted)
                sess.steps += n
                sess.tok = int(tok2[s])
                remaining[sid] -= n
                sess.last = {"tokens": emitted, "step": sess.steps}
        for sid in want:
            if self.sessions[sid].steps >= self.seq_cap:
                self._retire(sid)
        return out

    # protocol verb (sessions.SessionService): the LM payload is a token
    # budget per session
    push = decode

    # -- persistence hooks ---------------------------------------------------
    def _session_spill_meta(self, sid: int) -> dict:
        s = self.sessions[sid]
        return {"steps": int(s.steps), "tok": int(s.tok),
                "prompt": np.asarray(s.prompt).tolist(),
                "outputs": self.outputs.get(sid, [])}

    def _restore_session(self, info: dict):
        return _LMSession(steps=int(info.get("steps", 0)),
                          tok=int(info.get("tok", 0)),
                          prompt=np.asarray(info.get("prompt", []), np.int32))

    def _spill_extra(self) -> dict:
        if not self.paged:
            return {}
        return {"paged": {"block_len": self.block_len,
                          "n_blocks": self.pool.n_blocks}}

    def _restore_validate(self, parking: dict, meta: dict) -> None:
        """All-or-nothing gate: a spill from an incompatible service
        (longer seq_cap, other cache or paging geometry) is refused before
        any change, not half-admitted (a paged one would leak blocks)."""
        pm = (meta or {}).get("paged")
        if not self.paged and pm is not None:
            raise ValueError(
                f"incompatible LM spill: paged-layout spill (block_len="
                f"{pm.get('block_len')}, n_blocks={pm.get('n_blocks')}) "
                f"offered to a dense-layout service")
        if self.paged and pm is not None and (
                int(pm.get("block_len", -1)) != self.block_len
                or int(pm.get("n_blocks", 0)) > self.pool.n_blocks):
            raise ValueError(
                f"incompatible LM spill: pool geometry (block_len="
                f"{pm.get('block_len')}, n_blocks={pm.get('n_blocks')}) "
                f"does not fit this service's (block_len={self.block_len}, "
                f"n_blocks={self.pool.n_blocks})")
        for sid, blob in parking.items():
            info = meta.get("sessions", {}).get(str(sid), {})
            self._validate_blob(sid, blob, info)

    def _validate_blob(self, sid, blob: dict, info: dict) -> None:
        """One parked blob's geometry checks (bulk restore and the
        single-session ``adopt_session`` the plane's handoff rides)."""
        if int(info.get("steps", 0)) > self.seq_cap:
            raise ValueError(
                f"session {sid} parked at position {info.get('steps')} "
                f"> this service's seq_cap={self.seq_cap}")
        pv = blob.get(PAGED_MARKER) if isinstance(blob, dict) else None
        if self.paged != (pv is not None):
            raise ValueError(
                f"incompatible LM spill: session {sid} blob is "
                f"{'paged' if pv is not None else 'dense'}-layout but "
                f"this service is "
                f"{'paged' if self.paged else 'dense'}-layout")
        if self.paged:
            bl, n_keep = (int(x) for x in np.asarray(pv).reshape(-1)[:2])
            if bl != self.block_len:
                raise ValueError(
                    f"incompatible LM spill: session {sid} parked with "
                    f"block_len={bl} != this service's {self.block_len}")
            if n_keep > self.max_blocks:
                raise ValueError(
                    f"incompatible LM spill: session {sid} owns {n_keep} "
                    f"blocks > this service's per-session max "
                    f"{self.max_blocks}")

        def check(a, bax, sax, p):
            got = tuple(np.shape(p))
            if self.paged and sax >= 0:
                want = a.shape[:bax] + (n_keep,) + a.shape[bax + 1:]
                ok = got == tuple(want)
            else:
                want = a.shape[:bax] + a.shape[bax + 1:]
                t = sax - (sax > bax)
                ok = len(got) == len(want) and all(
                    (g <= w if i == t else g == w)
                    for i, (g, w) in enumerate(zip(got, want)))
            if not ok:
                raise ValueError(
                    f"session {sid}: parked cache leaf {got} does not fit "
                    f"this service's "
                    f"{'pool blocks' if self.paged else 'column'} "
                    f"{tuple(want)}")

        try:
            map_tree(check, self.cache, self._batch_axes, self._seq_axes,
                     blob["kv"])
        except (KeyError, ValueError, TypeError) as e:
            raise ValueError(f"incompatible LM spill: {e}") from e

    def _adopt_validate(self, blob: dict, meta: dict) -> None:
        self._validate_blob("<adopting>", blob, meta)

    def _on_adopt(self, sid: int, meta: dict) -> None:
        self.outputs[sid] = [int(t) for t in meta.get("outputs", [])]

    def _on_detach(self, sid: int) -> None:
        # the peer rebuilds outputs from the handoff meta
        self.outputs.pop(sid, None)

    def _post_restore(self, restored: list[int], meta: dict) -> None:
        for sid in restored:
            info = meta.get("sessions", {}).get(str(sid), {})
            self.outputs[sid] = [int(t) for t in info.get("outputs", [])]

    # -- introspection ------------------------------------------------------
    @property
    def slot_pos(self) -> np.ndarray:
        """Per-slot int32 positions (0 for free slots)."""
        pos = np.zeros(self.n_slots, np.int32)
        for slot, sid in self.sched.sid_of.items():
            pos[slot] = self.sessions[sid].steps
        return pos

    def live_column(self, sid: int) -> dict:
        """Host copy of a bound session's cache rows [0, steps), dense or
        paged alike (what a dense park would hold): for comparing the KV
        of two services."""
        sess, slot = self.sessions[sid], self.sched.slot_of[sid]
        if not self.paged:
            return self._from_slot(slot, lambda s: pack_column(
                self._cache(), self._batch_axes, s,
                trunc_axes=self._seq_axes, trunc_len=sess.steps))
        row = self._device_table()[slot][None]
        return map_tree(
            lambda a, bax, sax: pack_column(
                {"x": gather_column(a, row, bax) if sax >= 0 else a},
                {"x": bax}, 0 if sax >= 0 else slot,
                trunc_axes={"x": sax}, trunc_len=sess.steps)["x"],
            self.cache, self._batch_axes, self._seq_axes)

    def poll(self, sid: int) -> dict:
        sess = self.sessions[sid]
        state = ("done" if sess.done else
                 "active" if self.sched.is_bound(sid) else "parked")
        return {"state": state, "slot": self.sched.slot_of.get(sid),
                "steps": sess.steps,
                "prompt_left": max(0, len(sess.prompt) - sess.steps),
                "generated": len(self.outputs.get(sid, [])),
                "last": sess.last}

    def _slot_state_bytes(self) -> int:
        # structural footprint of one full slot column (pos = seq_cap)
        return self.kv_park_bytes(self.seq_cap)

    def _extra_stats(self) -> dict:
        out = {"seq_cap": self.seq_cap,
               "parked_cost_by_sid": {sid: self._park_cost(sid)
                                      for sid in self.parking}}
        if self.paged:
            out["paged"] = {
                "block_len": self.block_len,
                "n_blocks": self.pool.n_blocks,
                "blocks_free": self.pool.n_free,
                "blocks_live": self.pool.n_live,
                "blocks_cow_shared": self.pool.n_shared,
                "prefix_entries":
                    len(self._prefix) if self._prefix is not None else 0,
            }
        return out
