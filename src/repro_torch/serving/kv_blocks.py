"""Paged KV-cache block manager — the port's own copy of the parts of
``repro.serving.kv_blocks`` the one-card serving path uses (pure host-side
bookkeeping; the port imports nothing of the JAX package).

The physical cache is a fixed pool of fixed-size *blocks* (``[L,
num_blocks, block_size, KVH, hd]`` on the device, see
``models/model.py:init_paged_cache``) and every sequence owns a *block
table* — an ordered list of pool indices:

* **admission by occupancy** — a request needs blocks for its *current*
  tokens, not a ``max_len`` reservation;
* **copy-on-write prefix sharing** — sequences with a common prompt prefix
  reference the same physical blocks (refcounted); a write into a shared
  block first copies it (the engine performs the physical copy, this module
  does the bookkeeping);
* **recompute preemption** — when the pool runs dry the caller evicts the
  lowest-priority sequence (``victim``/``preempt``) and recomputes it on
  resume.

Live migration across partitions belongs to the multi-card slice and is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``num_tokens`` tokens."""
    return max(1, -(-num_tokens // block_size))


@dataclasses.dataclass
class SeqBlocks:
    """One sequence's view of the pool."""
    seq: int
    partition: int
    priority: int
    blocks: List[int]
    num_tokens: int                    # tokens currently stored
    num_shared: int = 0                # leading blocks adopted via prefix match


@dataclasses.dataclass
class AppendResult:
    """What the caller must do before writing the next token.

    ``block``    — pool index the token will be written into,
    ``cow_src``  — if set, the caller must first copy the physical contents
                   of ``cow_src`` into ``block`` (copy-on-write),
    ``grew``     — True when ``block`` was freshly allocated this call.
    """
    block: int
    cow_src: Optional[int] = None
    grew: bool = False


class KVBlockManager:
    """Fixed per-partition block pools + per-sequence block tables.

    Mirrors ``ExpertPageTable``: allocation is a free-list pop, remapping is
    table surgery, and the device arrays never move.  One partition per DP
    replica; prefix sharing is partition-local (a replica's pool lives on
    that replica's devices — cross-partition sharing would break locality).
    """

    def __init__(self, num_partitions: int, blocks_per_partition: int,
                 block_size: int):
        assert blocks_per_partition > 0 and block_size > 0
        self.blocks_per_partition = blocks_per_partition
        self.block_size = block_size
        self._free: List[List[int]] = []
        self._refcount: Dict[int, int] = {}
        self._seqs: Dict[int, SeqBlocks] = {}
        # prefix index: chain_hash -> [(block, content_key)] of *immutable*
        # blocks of live sequences; content_key is the token tuple so a
        # partial tail matches any request whose tail is a prefix of it.
        self._prefix: Dict[Tuple[int, int], List[Tuple[int, Tuple[int, ...]]]] = {}
        self._block_prefix_key: Dict[int, Tuple[int, int]] = {}
        self.preemptions = 0
        self.cow_copies = 0
        self.shared_block_hits = 0
        for _ in range(num_partitions):
            self._add_partition()

    # ---------------------------------------------------------- partitions
    @property
    def num_partitions(self) -> int:
        return len(self._free)

    @property
    def num_blocks(self) -> int:
        return self.num_partitions * self.blocks_per_partition

    def _add_partition(self):
        base = self.num_blocks
        self._free.append(list(range(base, base + self.blocks_per_partition)))

    # ------------------------------------------------------------- queries
    def free_blocks(self, partition: Optional[int] = None) -> int:
        if partition is None:
            return sum(len(f) for f in self._free)
        return len(self._free[partition])

    def used_blocks(self) -> int:
        return self.num_blocks - self.free_blocks()

    def utilization(self) -> float:
        return self.used_blocks() / max(self.num_blocks, 1)

    def seq(self, seq: int) -> SeqBlocks:
        return self._seqs[seq]

    def live_seqs(self) -> List[int]:
        return list(self._seqs)

    def block_table(self, seq: int) -> List[int]:
        return list(self._seqs[seq].blocks)

    def blocks_needed(self, num_tokens: int) -> int:
        return blocks_for(num_tokens, self.block_size)

    # ------------------------------------------------------- prefix hashing
    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        return [tuple(tokens[i:i + bs]) for i in range(0, len(tokens), bs)]

    def _match_prefix(self, partition: int, tokens: Sequence[int]
                      ) -> List[int]:
        """Longest chain of live blocks whose contents cover the leading
        chunks of ``tokens`` (a partial last chunk matches a block whose
        contents *start with* it — the CoW-on-append case)."""
        matched: List[int] = []
        h = partition                     # chain seed: partition-local index
        for chunk in self._chunks(tokens):
            cands = self._prefix.get((partition, h), [])
            hit = None
            for block, content in cands:
                if content[:len(chunk)] == chunk:
                    hit = block
                    break
            if hit is None:
                break
            matched.append(hit)
            if len(chunk) < self.block_size:
                break                     # partial tail ends the chain
            h = hash((h, chunk))
        return matched

    def _register_prefix(self, partition: int, tokens: Sequence[int],
                         blocks: Sequence[int]) -> None:
        h = partition
        for chunk, block in zip(self._chunks(tokens), blocks):
            key = (partition, h)
            if block not in [b for b, _ in self._prefix.get(key, [])]:
                self._prefix.setdefault(key, []).append((block, chunk))
                self._block_prefix_key[block] = key
            if len(chunk) < self.block_size:
                break
            h = hash((h, chunk))

    def prefix_match_blocks(self, partition: int,
                            tokens: Sequence[int]) -> List[int]:
        """Public read-only prefix probe (no state change): the chain of
        live registered blocks covering the leading chunks of ``tokens``.
        Prefix-cache-aware admission ranks candidate partitions by this
        length before binding a request to a slot (engine.preferred_slots)."""
        return self._match_prefix(partition, tokens)

    def register_written(self, seq: int, tokens: Sequence[int],
                         upto: int) -> None:
        """Register prefix chains for the first ``upto`` tokens of ``seq``'s
        prompt — the chunked-prefill path, where a block only becomes
        matchable once its KV is actually resident (registering at allocate
        time, as the monolithic path does, would let a matching arrival bind
        to blocks whose contents are still pending).  Only fully-written
        blocks register until ``upto`` reaches the whole prompt, then the
        partial tail registers too (the CoW-on-append case).  Idempotent."""
        sb = self._seqs[seq]
        upto = min(upto, len(tokens))
        if upto >= len(tokens):
            self._register_prefix(sb.partition, tokens, sb.blocks)
        else:
            nb = upto // self.block_size
            self._register_prefix(sb.partition, tokens[:nb * self.block_size],
                                  sb.blocks[:nb])

    def _unregister_block(self, block: int) -> None:
        key = self._block_prefix_key.pop(block, None)
        if key is None:
            return
        entries = [e for e in self._prefix.get(key, []) if e[0] != block]
        if entries:
            self._prefix[key] = entries
        else:
            self._prefix.pop(key, None)

    # ---------------------------------------------------------- allocation
    def can_allocate(self, num_tokens: int, partition: int,
                     tokens: Optional[Sequence[int]] = None) -> bool:
        """True if ``allocate`` would succeed (prefix credit included)."""
        need = self.blocks_needed(num_tokens)
        if tokens is not None:
            need -= len(self._match_prefix(partition, tokens))
        return len(self._free[partition]) >= max(need, 0)

    def allocate(self, seq: int, num_tokens: int, *, partition: int = 0,
                 priority: int = 0,
                 tokens: Optional[Sequence[int]] = None,
                 register: bool = True) -> SeqBlocks:
        """Blocks for a prompt of ``num_tokens`` tokens.  With ``tokens``
        (the prompt ids), leading blocks already resident for another live
        sequence in the same partition are *shared* (refcount bump, no
        allocation, no write) — copy-on-write happens lazily at ``append``.
        ``register=False`` defers prefix registration (chunked prefill
        registers progressively via ``register_written`` as chunks land —
        an unwritten block must never be matchable).  Raises MemoryError
        when the partition's pool is dry (caller preempts and retries)."""
        assert seq not in self._seqs, f"seq {seq} already allocated"
        need = self.blocks_needed(num_tokens)
        shared: List[int] = []
        if tokens is not None:
            assert len(tokens) == num_tokens
            shared = self._match_prefix(partition, tokens)[:need]
        fresh_n = need - len(shared)
        if len(self._free[partition]) < fresh_n:
            raise MemoryError(
                f"kv pool dry on partition {partition}: need {fresh_n}, "
                f"free {len(self._free[partition])}")
        for b in shared:
            self._refcount[b] += 1
        self.shared_block_hits += len(shared)
        fresh = [self._free[partition].pop() for _ in range(fresh_n)]
        for b in fresh:
            self._refcount[b] = 1
        sb = SeqBlocks(seq=seq, partition=partition, priority=priority,
                       blocks=shared + fresh, num_tokens=num_tokens,
                       num_shared=len(shared))
        self._seqs[seq] = sb
        if tokens is not None and register:
            self._register_prefix(partition, tokens, sb.blocks)
        return sb

    def append(self, seq: int) -> Optional[AppendResult]:
        """Reserve a slot for the sequence's next token (written at position
        ``num_tokens``).  Returns None when the current tail block has room
        and is uniquely owned; an AppendResult when the caller must use a
        (possibly CoW-copied) block.  Raises MemoryError when a new block is
        needed and the partition is dry."""
        sb = self._seqs[seq]
        pos = sb.num_tokens
        j = pos // self.block_size
        if j == len(sb.blocks):                       # crosses into new block
            if not self._free[sb.partition]:
                raise MemoryError(
                    f"kv pool dry on partition {sb.partition} (append)")
            b = self._free[sb.partition].pop()
            self._refcount[b] = 1
            sb.blocks.append(b)
            sb.num_tokens += 1
            return AppendResult(block=b, grew=True)
        old = sb.blocks[j]
        if self._refcount[old] > 1:                   # copy-on-write
            if not self._free[sb.partition]:
                raise MemoryError(
                    f"kv pool dry on partition {sb.partition} (CoW)")
            b = self._free[sb.partition].pop()
            self._refcount[b] = 1
            self._refcount[old] -= 1
            sb.blocks[j] = b
            sb.num_shared = min(sb.num_shared, j)
            sb.num_tokens += 1
            self.cow_copies += 1
            return AppendResult(block=b, cow_src=old, grew=True)
        # uniquely owned: writing in place mutates it -> stale prefix entry
        self._unregister_block(old)
        sb.num_tokens += 1
        return None

    def free(self, seq: int) -> List[int]:
        """Release a sequence.  Returns the blocks actually returned to the
        pool (shared blocks survive until their last holder frees them)."""
        sb = self._seqs.pop(seq)
        released = []
        for b in sb.blocks:
            self._refcount[b] -= 1
            if self._refcount[b] == 0:
                del self._refcount[b]
                self._unregister_block(b)
                self._free[sb.partition].append(b)
                released.append(b)
        return released

    # ---------------------------------------------------------- preemption
    def victim(self, candidates: Optional[Sequence[int]] = None,
               exclude: Sequence[int] = ()) -> Optional[int]:
        """Sequence to evict under pressure: lowest priority, youngest
        (highest seq id) on ties — vLLM's recompute-preemption order."""
        pool = [s for s in (candidates if candidates is not None
                            else self._seqs) if s not in exclude
                and s in self._seqs]
        if not pool:
            return None
        return min(pool, key=lambda s: (self._seqs[s].priority, -s))

    def preempt(self, seq: int) -> List[int]:
        """Evict ``seq`` (recompute-on-resume: all state dropped)."""
        self.preemptions += 1
        return self.free(seq)

    # ------------------------------------------------------------- checking
    def check_invariants(self) -> None:
        """No block leaked, double-owned, or double-free."""
        bpp = self.blocks_per_partition
        holders: Dict[int, int] = {}
        for sb in self._seqs.values():
            assert len(set(sb.blocks)) == len(sb.blocks), \
                f"seq {sb.seq} holds a block twice"
            for b in sb.blocks:
                assert b // bpp == sb.partition, \
                    f"seq {sb.seq} holds foreign block {b}"
                holders[b] = holders.get(b, 0) + 1
        assert holders == self._refcount, (holders, self._refcount)
        seen = set(holders)
        for p, free in enumerate(self._free):
            assert len(set(free)) == len(free), f"double-free in partition {p}"
            for b in free:
                assert b // bpp == p and b not in holders, b
                seen.add(b)
        assert seen == set(range(self.num_blocks)), "blocks leaked"
        for block, key in self._block_prefix_key.items():
            assert block in self._refcount, \
                f"prefix index references freed block {block}"
            assert any(b == block for b, _ in self._prefix.get(key, []))

    def stats(self) -> Dict[str, float]:
        return {
            "num_blocks": self.num_blocks,
            "used_blocks": self.used_blocks(),
            "utilization": self.utilization(),
            "preemptions": self.preemptions,
            "cow_copies": self.cow_copies,
            "shared_block_hits": self.shared_block_hits,
            "live_seqs": len(self._seqs),
        }
