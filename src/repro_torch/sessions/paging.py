"""Block-pool allocator for paged slot memory, and the LM prefix registry.

The port of ``repro/sessions/paging.py``.  Host-side bookkeeping only: a
free list and per-block refcounts over usable block ids ``1..n_blocks``
(the paged tenant banks and the paged LM KV cache), and ``PrefixCache``,
the exact-prefix registry that lets LM sessions with a common prompt
prefix share its full KV blocks copy-on-write.

  * Block id 0 is the reserved NULL block.  It is never allocated and never
    read at a live position; masked lanes and unbound slots point at it, so
    ``BlockPool(n)`` manages a device pool of physical extent ``n + 1``.
  * ``free`` drops one reference and returns the block to the (LIFO) free
    list at zero; ``writable`` is the copy-on-write gate: an exclusive
    block comes back as-is, a shared one gets a fresh id (the caller copies
    the device bytes ``src -> new``).

Exhaustion raises :class:`PoolExhausted`, a subclass of the scheduler's
``AdmissionError``: paged capacity pressure is the same back-pressure as
live-session admission control.
"""

from __future__ import annotations

from collections import OrderedDict

from repro_torch.sessions.scheduler import AdmissionError

NULL_BLOCK = 0


class PoolExhausted(AdmissionError):
    """Raised when the block pool has no free block (park or close
    sessions, or construct the service with a larger ``n_blocks``)."""


class BlockPool:
    """Free-list allocator over ``n_blocks`` usable blocks with per-block
    refcounts (ids ``1..n_blocks``; id 0 is the reserved NULL block)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.extent = self.n_blocks + 1  # device pool axis: usable + NULL
        self._refs = [0] * self.extent
        # LIFO: recently freed blocks are re-used first
        self._free = list(range(self.n_blocks, 0, -1))
        self._n_shared = 0  # blocks with refcount >= 2

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def n_shared(self) -> int:
        return self._n_shared

    def refcount(self, bid: int) -> int:
        return self._refs[bid]

    def alloc(self) -> int:
        """O(1): pop a free block with refcount 1."""
        if not self._free:
            raise PoolExhausted(
                f"block pool exhausted ({self.n_blocks} blocks, 0 free)")
        bid = self._free.pop()
        self._refs[bid] = 1
        return bid

    def ref(self, bid: int) -> int:
        """Take an extra reference."""
        if bid == NULL_BLOCK or self._refs[bid] <= 0:
            raise ValueError(f"ref of unallocated block {bid}")
        self._refs[bid] += 1
        if self._refs[bid] == 2:
            self._n_shared += 1
        return bid

    def free(self, bid: int) -> None:
        """Drop one reference; the block returns to the free list at 0."""
        if bid == NULL_BLOCK:
            raise ValueError("free of the reserved NULL block")
        if self._refs[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self._refs[bid] -= 1
        if self._refs[bid] == 1:
            self._n_shared -= 1
        elif self._refs[bid] == 0:
            self._free.append(bid)

    def writable(self, bid: int) -> tuple[int, int | None]:
        """Copy-on-write gate before a writer touches ``bid``: ``(bid,
        None)`` when exclusively owned, else ``(new_bid, bid)`` with the
        caller's reference moved to a fresh block (the caller copies the
        device bytes ``bid -> new_bid``)."""
        if bid == NULL_BLOCK or self._refs[bid] <= 0:
            raise ValueError(f"writable() on unallocated block {bid}")
        if self._refs[bid] == 1:
            return bid, None
        new = self.alloc()
        self.free(bid)
        return new, bid

    def check(self) -> None:
        """Invariant audit (tests): free list and refcounts reconcile."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list contains duplicates")
        if NULL_BLOCK in free or self._refs[NULL_BLOCK] != 0:
            raise AssertionError("NULL block leaked into circulation")
        for bid in range(1, self.extent):
            r = self._refs[bid]
            if r < 0:
                raise AssertionError(f"negative refcount on block {bid}")
            if (r == 0) != (bid in free):
                raise AssertionError(
                    f"block {bid}: refcount {r} disagrees with free list")
        shared = sum(1 for r in self._refs if r >= 2)
        if shared != self._n_shared:
            raise AssertionError(
                f"shared counter {self._n_shared} != recount {shared}")


def prefix_keys(tokens, block_len: int) -> list[tuple[int, ...]]:
    """Chain keys for every FULL block of ``tokens``: key ``i`` is the
    exact tuple of all tokens up to and including block ``i`` (prefix
    chains are content-addressed without hash-collision risk)."""
    toks = [int(t) for t in tokens]
    n_full = len(toks) // block_len
    return [tuple(toks[: (i + 1) * block_len]) for i in range(n_full)]


class PrefixCache:
    """Exact-prefix registry: full prompt blocks -> physical block ids.

    Each entry pins its block with one registry reference, so a donor
    session can park or close and later sessions still share the bytes.
    ``match`` returns the longest chain of hits (one reference taken per
    hit, for the caller); ``release_lru`` drops the least recently matched
    entry so an exhausted pool can reclaim registry-only blocks."""

    def __init__(self, pool: BlockPool, max_entries: int | None = None):
        self.pool = pool
        self.max_entries = max_entries
        self._map: OrderedDict[tuple[int, ...], int] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._map)

    def match(self, keys: list[tuple[int, ...]]) -> list[int]:
        """Longest-prefix match; the returned block ids carry one new
        reference each, owned by the caller."""
        out: list[int] = []
        for key in keys:
            bid = self._map.get(key)
            if bid is None:
                self.misses += 1
                break
            self._map.move_to_end(key)
            out.append(self.pool.ref(bid))
            self.hits += 1
        return out

    def insert(self, key: tuple[int, ...], bid: int) -> None:
        """Register a full block (no-op if the chain key is known)."""
        if key in self._map:
            self._map.move_to_end(key)
            return
        self.pool.ref(bid)
        self._map[key] = bid
        if self.max_entries is not None and len(self._map) > self.max_entries:
            self.release_lru()

    def release_lru(self) -> bool:
        """Evict the least recently matched entry, dropping its registry
        reference (the block is freed iff no session still shares it).
        Returns False when the registry is empty."""
        if not self._map:
            return False
        _, bid = self._map.popitem(last=False)
        self.pool.free(bid)
        return True

    def clear(self) -> None:
        while self.release_lru():
            pass
