"""Paged KV-cache pool: block allocator + hash-keyed prefix cache.

A near-verbatim copy of ``repro.serve.kvpool`` (pure host bookkeeping, no
framework); the port keeps its own.

A contiguous engine stores one contiguous ``(slots, max_len)`` KV slab per
attention layer and re-prefills every prompt from scratch.  This module
owns the *bookkeeping* half of the paged replacement:

  * **blocks** — KV storage is cut into fixed-size blocks of
    ``block_size`` tokens (a multiple of the flash kernel's KV tile
    granularity, so a block never straddles a kernel tile).  The device
    arrays live in the engine's cache pytree with a leading
    ``num_blocks`` dim; this class hands out *block ids* into that dim.
  * **free-list allocator** — O(1) allocate/free with per-block
    refcounts.  Block id 0 is reserved as the *scratch* block: freed
    slots' table rows point at it so a retired slot's in-flight decode
    write can never corrupt a live block, and it is never handed out.
  * **hash-keyed prefix cache** — prompt token chunks are chain-hashed
    per block (``h_i = H(h_{i-1}, tokens[i*bs:(i+1)*bs])``), and FULL
    prompt blocks are published under their chain hash when a prefill
    completes.  A later request with the same prefix splices the cached
    blocks into its block table copy-free and starts prefill after them.
    Only full blocks are ever shared, and shared blocks are never
    written again (decode writes land at ``pos >= cached_len``, always
    in blocks the request owns exclusively), so no copy-on-write is
    needed.
  * **eviction** — a cached block whose refcount drops to zero becomes
    *evictable* (it stays in the hash map so it can still be reused for
    free).  When the free list runs dry, the least-recently-used
    evictable block is unpublished and recycled.

The pool is pure host-side state — it never touches device memory — so
every method is cheap enough for the scheduler's admit path.

On a mesh's ``"data"`` axis the serving engine keeps one
:class:`KVBlockPool` per data rank, each with its own scratch block and
local ids (:func:`merged_stats` sums their counters): a slot's blocks come
from its owner's share, which holds the device blocks. Every rank keeps the
bookkeeping of every share, so the schedulers of all ranks see the same
state. A prefix hit counts only within one share (the reference's one pool
can hit across them): the streams cannot change, the hit counts can.
"""

from __future__ import annotations

import collections

__all__ = ["KVBlockPool", "KVPoolExhausted", "hash_token_blocks",
           "merged_stats"]

SCRATCH_BLOCK = 0  # reserved: write-dump for retired slots, never allocated


class KVPoolExhausted(RuntimeError):
    """Raised when an allocation finds no free and no evictable block."""


def hash_token_blocks(tokens, block_size: int) -> list:
    """Chain hashes of the FULL ``block_size`` chunks of a token list.

    ``out[i]`` identifies tokens ``[0 : (i+1) * block_size)`` — each hash
    folds in the previous one, so a match at chunk i implies the whole
    prefix up to i matches.  Deterministic within a process (the cache is
    in-process state); the trailing partial chunk is never hashed because
    only full blocks are shareable.
    """
    out, h = [], 0x9E3779B9
    for i in range(len(tokens) // block_size):
        chunk = tuple(tokens[i * block_size:(i + 1) * block_size])
        h = hash((h, chunk))
        out.append(h)
    return out


class KVBlockPool:
    """Free-list block allocator with refcounts and a prefix cache.

    ``num_blocks`` counts the scratch block; ``num_blocks - 1`` ids are
    allocatable.  ``prefix_cache=False`` degrades to a plain allocator
    (every ``match_prefix`` misses, nothing is published).
    """

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is scratch), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self._free: collections.deque = collections.deque(
            range(1, num_blocks))
        self._ref = [0] * num_blocks
        self._hash_to_block: dict = {}          # chain hash -> block id
        self._block_hash: dict = {}             # block id -> chain hash
        # cached blocks with refcount 0, in LRU order (oldest first)
        self._evictable: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0          # prefix-cache block hits
        self.misses = 0        # prompt blocks that had to prefill
        self.allocs = 0
        self.evictions = 0
        self.truncations = 0   # tail blocks released by truncate()
        self._live = 0         # blocks with refcount > 0
        self.peak_in_use = 0

    # -- allocation -------------------------------------------------------

    def alloc(self) -> int:
        """Take a block (refcount 1); evicts the LRU cached block if the
        free list is empty.  Raises :class:`KVPoolExhausted` otherwise."""
        if self._free:
            bid = self._free.popleft()
        elif self._evictable:
            bid, _ = self._evictable.popitem(last=False)
            self._unpublish(bid)
            self.evictions += 1
        else:
            raise KVPoolExhausted(
                f"KV pool exhausted: all {self.num_blocks - 1} blocks "
                f"referenced (no evictable prefix-cache blocks); grow the "
                f"pool (kv_blocks=) or reduce slots x max_len"
            )
        self._ref[bid] = 1
        self.allocs += 1
        self._live += 1
        self.peak_in_use = max(self.peak_in_use, self._live)
        return bid

    def retain(self, bid: int) -> None:
        if bid == SCRATCH_BLOCK:
            raise ValueError("cannot retain the scratch block")
        if self._ref[bid] == 0:
            # reviving a cached, evictable block (prefix hit)
            self._evictable.pop(bid, None)
            self._live += 1
            self.peak_in_use = max(self.peak_in_use, self._live)
        self._ref[bid] += 1

    def release(self, bid: int) -> None:
        if self._ref[bid] <= 0:
            raise ValueError(f"release of unreferenced block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._live -= 1
            if bid in self._block_hash:
                # keep the KV around for future prefix hits; reclaimable
                self._evictable[bid] = True
                self._evictable.move_to_end(bid)
            else:
                self._free.append(bid)

    def truncate(self, block_ids: list, new_len: int) -> list:
        """Shrink a request's block chain to cover ``new_len`` tokens.

        Releases every WHOLE tail block past ``ceil(new_len / block_size)``
        (speculative decode rolls back rejected draft positions this way —
        partially-filled tail rows need no release, the next write simply
        overwrites them before any query can attend them).  ``block_ids``
        is truncated in place; the released ids are returned so the caller
        can reset its device block-table rows.

        Consistency guard: a cached (published) prefix block can never be
        a truncation victim — shared prefix KV is immutable by
        construction, and speculative tails always start at or after the
        prompt end.  Hitting one means the caller's accounting is wrong,
        so it raises instead of corrupting the prefix cache.
        """
        if new_len < 0:
            raise ValueError(f"new_len must be >= 0, got {new_len}")
        keep = -(-new_len // self.block_size)  # ceil
        tail = block_ids[keep:]
        for bid in tail:
            if bid in self._block_hash:
                raise ValueError(
                    f"truncate would release cached prefix block {bid}; "
                    f"published blocks are immutable (new_len={new_len})")
            self.release(bid)
        self.truncations += len(tail)
        del block_ids[keep:]
        return tail

    # -- prefix cache -----------------------------------------------------

    def match_prefix(self, tokens, max_tokens: int | None = None) -> list:
        """Longest cached block chain for ``tokens``; retains every hit.

        Returns the block ids covering ``len(result) * block_size`` prompt
        tokens.  ``max_tokens`` caps the usable prefix (the engine passes
        ``len(prompt) - 1`` so at least one real token is always left to
        prefill — the first-token logits must come from somewhere).
        Counts hits/misses over the prompt's full blocks.
        """
        limit = len(tokens) if max_tokens is None else min(
            len(tokens), max_tokens)
        n_full = len(tokens) // self.block_size
        out = []
        if self.prefix_cache:
            for h in hash_token_blocks(tokens, self.block_size):
                if len(out) + 1 > limit // self.block_size:
                    break
                bid = self._hash_to_block.get(h)
                if bid is None:
                    break
                self.retain(bid)
                out.append(bid)
        self.hits += len(out)
        self.misses += n_full - len(out)
        return out

    def publish_prefix(self, tokens, block_ids) -> None:
        """Publish a prompt's FULL blocks under their chain hashes.

        ``block_ids[i]`` must hold the KV of tokens
        ``[i*bs : (i+1)*bs]``.  Idempotent for already-published hashes
        (the existing entry wins — both blocks hold identical KV, and the
        older one is the one other requests may already reference).
        """
        if not self.prefix_cache:
            return
        for h, bid in zip(hash_token_blocks(tokens, self.block_size),
                          block_ids):
            if h in self._hash_to_block:
                continue
            if bid in self._block_hash:  # block already published (cached hit)
                continue
            self._hash_to_block[h] = bid
            self._block_hash[bid] = h

    def _unpublish(self, bid: int) -> None:
        h = self._block_hash.pop(bid, None)
        if h is not None:
            self._hash_to_block.pop(h, None)

    # -- observability ----------------------------------------------------

    def blocks_in_use(self) -> int:
        """Blocks with a live reference (excludes evictable cached ones)."""
        return sum(1 for r in self._ref[1:] if r > 0)

    def blocks_cached(self) -> int:
        """Published blocks kept only for future prefix hits (refcount 0)."""
        return len(self._evictable)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return (self.hits / total) if total else 0.0

    def reset_stats(self) -> None:
        self.hits = self.misses = self.allocs = self.evictions = 0
        self.truncations = 0
        self.peak_in_use = self._live

    def stats(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "prefix_cache": self.prefix_cache,
            "blocks_in_use": self.blocks_in_use(),
            "blocks_in_use_peak": self.peak_in_use,
            "blocks_cached": self.blocks_cached(),
            "blocks_free": len(self._free),
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_rate": self.hit_rate(),
            "allocs": self.allocs,
            "evictions": self.evictions,
            "truncations": self.truncations,
        }

    def check_consistent(self) -> None:
        """Invariant check for tests: every allocatable block is in exactly
        one of {free, referenced, evictable}, and the hash maps mirror."""
        free = set(self._free)
        ref = {b for b in range(1, self.num_blocks) if self._ref[b] > 0}
        evict = set(self._evictable)
        assert not (free & ref), (free, ref)
        assert not (free & evict), (free, evict)
        assert not (ref & evict), (ref, evict)
        assert free | ref | evict == set(range(1, self.num_blocks)), (
            free, ref, evict)
        assert self._ref[SCRATCH_BLOCK] == 0
        assert self._live == len(ref), (self._live, ref)
        for h, bid in self._hash_to_block.items():
            assert self._block_hash.get(bid) == h, (h, bid)
        for bid, h in self._block_hash.items():
            assert self._hash_to_block.get(h) == bid, (h, bid)
        for bid in self._evictable:
            assert bid in self._block_hash, bid


_SUMMED = ("num_blocks", "blocks_in_use", "blocks_in_use_peak",
           "blocks_cached", "blocks_free", "prefix_hits", "prefix_misses",
           "allocs", "evictions", "truncations")


def merged_stats(pools: list) -> dict:
    """One pool's :meth:`KVBlockPool.stats`, or several shares' counters
    summed (with the hit rate of the sums and their number, ``shares``)."""
    if len(pools) == 1:
        return pools[0].stats()
    per = [p.stats() for p in pools]
    out = dict(per[0])
    out.update({k: sum(s[k] for s in per) for k in _SUMMED})
    looked = out["prefix_hits"] + out["prefix_misses"]
    out.update(prefix_hit_rate=out["prefix_hits"] / looked if looked else 0.0,
               shares=len(pools))
    return out
