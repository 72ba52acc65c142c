"""Paged KV-cache block manager — the port's own copy of
``repro.serving.kv_blocks`` (pure host-side bookkeeping; the port imports
nothing of the JAX package).

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

A scale event grows or shrinks the pool by whole partitions
(``grow_partitions`` / ``shrink_partitions``).

**Live migration (scale-down without a drain).**  ``begin_migration``
*reserves* blocks on a survivor partition for a whole sharing component of
live sequences (two-phase: the sequences keep reading their source blocks
while the engine copies the rows in the background), and
``commit_migration`` rewrites the block tables, moves the CoW refcounts
block for block, re-keys the prefix-registry chains to the destination
partition's hash seed and frees the source blocks.  ``abort_migration``
returns the reservation untouched.  Migration is component-granular so
that refcounted sharing survives the move.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


def blocks_for(num_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``num_tokens`` tokens."""
    return max(1, -(-num_tokens // block_size))


def block_bytes(mcfg, block_size: int, kv_dtype: Optional[str] = None) -> int:
    """Device bytes of ONE KV block across all layers — the unit of
    admission, migration and CoW accounting.  ``kv_dtype="int8"`` stores
    1-byte entries plus the per-token f32 (k, v) scale rows that travel
    with the block.  Equals ``InferenceEngine.block_nbytes()`` (one copy
    of the live pool)."""
    from repro_torch.device import torch_dtype
    kv_bpe = torch_dtype(kv_dtype or mcfg.dtype).itemsize
    scale = 2 * 4 if kv_dtype is not None else 0
    return mcfg.num_layers * block_size * (
        2 * mcfg.num_kv_heads * mcfg.resolved_head_dim * kv_bpe + scale)


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
class MigrationTicket:
    """An in-flight cross-partition move of one sharing component.

    ``pairs`` is the device copy list: the caller copies every ``src``
    block's rows into its ``dst`` block (in any order; the blocks are
    frozen: migrating sequences may not append) before
    ``commit_migration``.  Until the commit every sequence still reads its
    source blocks — the ticket only holds a reservation on the destination
    partition, so ``abort_migration`` is a pure unwind."""
    tid: int
    seqs: List[int]
    src_partition: int
    dst_partition: int
    pairs: List[Tuple[int, int]]           # (src_block, dst_block)
    mapping: Dict[int, int]                # src_block -> dst_block

    @property
    def num_blocks(self) -> int:
        return len(self.pairs)


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
        # live migrations (scale-down): tid -> MigrationTicket
        self._migrations: Dict[int, MigrationTicket] = {}
        self._next_tid = 0
        self.migrated_blocks = 0
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

    def grow_partitions(self, num_partitions: int) -> None:
        """Scale-up: append fresh partitions.  Existing block ids — and
        therefore every live block table — stay valid verbatim."""
        if num_partitions < self.num_partitions:
            raise ValueError(f"grow_partitions({num_partitions}) below the "
                             f"current {self.num_partitions}")
        while self.num_partitions < num_partitions:
            self._add_partition()

    def shrink_partitions(self, num_partitions: int) -> None:
        """Scale-down: drop trailing partitions.  They must be fully free:
        live sequences leave them first — migrated onto survivors, or
        drained (sharing is partition-local, so no survivor can hold a
        doomed block)."""
        if not 0 < num_partitions <= self.num_partitions:
            raise ValueError(f"shrink_partitions({num_partitions}) outside "
                             f"1..{self.num_partitions}")
        if self._migrations:
            raise RuntimeError("cannot shrink with migrations in flight "
                               "(commit or abort them first)")
        for p in range(num_partitions, self.num_partitions):
            if len(self._free[p]) != self.blocks_per_partition:
                raise RuntimeError(f"partition {p} still has allocated "
                                   f"blocks")
        self._free = self._free[:num_partitions]

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
        if self.migrating(seq):
            raise RuntimeError(f"seq {seq} is mid-migration (blocks frozen)")
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
        if self.migrating(seq):
            raise RuntimeError(f"seq {seq} is mid-migration "
                               f"(abort_migration first)")
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
                and s in self._seqs and not self.migrating(s)]
        if not pool:
            return None
        return min(pool, key=lambda s: (self._seqs[s].priority, -s))

    def preempt(self, seq: int) -> List[int]:
        """Evict ``seq`` (recompute-on-resume: all state dropped)."""
        self.preemptions += 1
        return self.free(seq)

    # ----------------------------------------------------------- migration
    def migrating(self, seq: int) -> bool:
        return any(seq in t.seqs for t in self._migrations.values())

    @property
    def migrations_pending(self) -> int:
        return len(self._migrations)

    def share_components(self, partition: int) -> List[List[int]]:
        """Live sequences of ``partition`` grouped into connected components
        of the block-sharing graph (CoW'd prefixes): the migration unit,
        since moving a component whole keeps every refcount intact.
        Deterministic: components and members sorted by sequence id."""
        holders: Dict[int, List[int]] = {}
        for s, sb in self._seqs.items():
            if sb.partition != partition:
                continue
            for b in sb.blocks:
                holders.setdefault(b, []).append(s)
        parent: Dict[int, int] = {}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for seqs in holders.values():
            for s in seqs:
                parent.setdefault(s, s)
            for s in seqs[1:]:
                parent[find(seqs[0])] = find(s)
        comps: Dict[int, List[int]] = {}
        for s in parent:
            comps.setdefault(find(s), []).append(s)
        return sorted((sorted(c) for c in comps.values()), key=lambda c: c[0])

    def migration_need(self, seqs: Sequence[int]) -> int:
        """Blocks a ``begin_migration`` of ``seqs`` would reserve (the
        component's unique blocks: a shared block counts once)."""
        return len({b for s in seqs for b in self._seqs[s].blocks})

    def begin_migration(self, seqs: Sequence[int],
                        dst_partition: int) -> MigrationTicket:
        """Reserve destination blocks for a whole sharing component: one
        per unique source block.  The component must be closed (every
        co-owner of each of its blocks in ``seqs``: otherwise the move
        would strand a survivor's table).  No sequence state changes: the
        caller copies ``ticket.pairs`` and then commits.  Raises
        MemoryError when the destination partition lacks free blocks."""
        if not seqs:
            raise ValueError("empty migration")
        parts = {self._seqs[s].partition for s in seqs}
        if len(parts) != 1:
            raise ValueError(f"component spans partitions {parts}")
        src_partition = parts.pop()
        if dst_partition == src_partition \
                or not 0 <= dst_partition < self.num_partitions:
            raise ValueError(f"bad destination partition {dst_partition}")
        for s in seqs:
            if self.migrating(s):
                raise RuntimeError(f"seq {s} already migrating")
        order: List[int] = []
        seen = set()
        for s in seqs:
            for b in self._seqs[s].blocks:
                if b not in seen:
                    seen.add(b)
                    order.append(b)
        for s, sb in self._seqs.items():
            if s not in seqs and seen & set(sb.blocks):
                raise ValueError(f"seq {s} shares blocks with the migrating "
                                 f"component")
        if len(self._free[dst_partition]) < len(order):
            raise MemoryError(
                f"survivor partition {dst_partition} lacks free blocks for "
                f"migration: need {len(order)}, "
                f"free {len(self._free[dst_partition])}")
        dst = [self._free[dst_partition].pop() for _ in order]
        ticket = MigrationTicket(
            tid=self._next_tid, seqs=sorted(seqs),
            src_partition=src_partition, dst_partition=dst_partition,
            pairs=list(zip(order, dst)), mapping=dict(zip(order, dst)))
        self._next_tid += 1
        self._migrations[ticket.tid] = ticket
        return ticket

    def commit_migration(self, ticket: MigrationTicket) -> List[int]:
        """Cut-over after the caller copied every pair: rewrite the
        component's block tables to the destination blocks, move refcounts
        block for block, re-key the prefix-registry chains onto the
        destination partition's hash seed, and free the source blocks.
        Returns them."""
        t = self._migrations.pop(ticket.tid)
        # 1. the registered prefix chains, read against the pristine
        #    registry (chain hash = fold of chunk contents from the
        #    partition seed)
        moves: Dict[int, Tuple[Tuple[int, int], Tuple[int, ...]]] = {}
        for s in t.seqs:
            h_old, h_new = t.src_partition, t.dst_partition
            for b in self._seqs[s].blocks:
                if self._block_prefix_key.get(b) != (t.src_partition, h_old):
                    break            # unregistered tail / diverged chain
                chunk = next((c for bb, c
                              in self._prefix.get((t.src_partition, h_old),
                                                  []) if bb == b), None)
                if chunk is None:
                    break
                moves.setdefault(b, ((t.dst_partition, h_new), chunk))
                if len(chunk) < self.block_size:
                    break
                h_old = hash((h_old, chunk))
                h_new = hash((h_new, chunk))
        # 2. re-key the matched chains; 3. drop any stragglers (no stale
        #    entry may reference a block returning to the free list)
        for b_src, (new_key, chunk) in moves.items():
            self._unregister_block(b_src)
            b_dst = t.mapping[b_src]
            self._prefix.setdefault(new_key, []).append((b_dst, chunk))
            self._block_prefix_key[b_dst] = new_key
        for b_src in t.mapping:
            if b_src in self._block_prefix_key:
                self._unregister_block(b_src)
        # 4. refcounts and tables
        for b_src, b_dst in t.mapping.items():
            self._refcount[b_dst] = self._refcount.pop(b_src)
        for s in t.seqs:
            sb = self._seqs[s]
            sb.blocks = [t.mapping[b] for b in sb.blocks]
            sb.partition = t.dst_partition
        released = sorted(t.mapping)
        self._free[t.src_partition].extend(released)
        self.migrated_blocks += len(t.pairs)
        return released

    def abort_migration(self, ticket: MigrationTicket) -> None:
        """Drop the reservation; no sequence state changed, so this is a
        pure free-list unwind (idempotent for a resolved ticket)."""
        t = self._migrations.pop(ticket.tid, None)
        if t is None:
            return
        self._free[t.dst_partition].extend(d for _, d in t.pairs)

    # ------------------------------------------------------------- checking
    def check_invariants(self) -> None:
        """No block leaked, double-owned or double-free; a migration's
        reserved destination blocks are neither held nor free."""
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
        reserved = set()
        for t in self._migrations.values():
            srcs = set()
            for s in t.seqs:
                assert s in self._seqs, f"migrating seq {s} vanished"
                srcs |= set(self._seqs[s].blocks)
            assert srcs == set(t.mapping), (srcs, t.mapping)
            for _, d in t.pairs:
                assert d // bpp == t.dst_partition, (d, t.dst_partition)
                assert d not in holders and d not in reserved, \
                    f"migration-reserved block {d} double-owned"
                reserved.add(d)
        seen |= reserved
        for p, free in enumerate(self._free):
            assert len(set(free)) == len(free), f"double-free in partition {p}"
            for b in free:
                assert b // bpp == p and b not in holders \
                    and b not in reserved, b
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
            "migrated_blocks": self.migrated_blocks,
            "migrations_pending": self.migrations_pending,
        }
