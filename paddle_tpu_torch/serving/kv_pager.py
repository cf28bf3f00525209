"""Paged KV cache with prefix sharing — the serving engine's block-table
memory manager.

≙ paddle_tpu/serving/kv_pager.py. The slot engine (serving/engine.py)
reserves one full [max_len] KV row per slot. This module replaces the
per-slot rows with PAGES:

- `BlockPool` — host-side free-list + refcount accounting over ONE
  device-resident pool per layer per k/v ([n_blocks, nh, block_size,
  dh] persistable vars). Physical block 0 is the reserved NULL block:
  idle tick slots are steered to write there, and no live block table
  ever maps it.
- `BlockTable` — a request's logical→physical mapping: logical block j
  (token positions [j*block_size, (j+1)*block_size)) lives in physical
  block `blocks[j]`. A request holds ceil((prompt+max_new)/block_size)
  blocks instead of max_len tokens.
- `RadixPrefixIndex` — block-granular prefix sharing: full
  `block_size`-token prompt blocks are registered (keyed by their token
  content) the moment their last row is written; a later request whose
  prompt starts with the same tokens maps its LEADING table entries to
  the SAME physical blocks (refcounted, zero prefill ticks for the
  shared span). Sharing is capped block-aligned at len(prompt)-1 so a
  write never lands in a shared block and at least one prompt token
  remains to feed the tick. Cached blocks persist after their request
  completes (the index holds its own ref) and are evicted LRU
  LEAF-FIRST under pool pressure.
- Copy-on-write at the divergence block: `KVPager.fork` (beam search's
  hypothesis split) shares all fully-written blocks by refcount and
  EAGERLY copies the one partially-written block.
- `PagedKVEngine` — the ContinuousBatchingEngine subclass that decodes
  through all of the above: the same scheduler and tick loop, admission
  acquires a block table (head-of-line wait under pool pressure, with LRU
  eviction of cached prefixes), prefill SKIPS shared positions (the
  shared blocks hold byte-identical K/V, which is why decode is
  token-identical to the slot engine), and the tick is
  `transformer_lm_paged_decode_tick` (a gather by block table; the fused
  decode-attention kernel reads the gathered view, the slot tick's bytes).
- `paged_beam_search` — beam decode over the paged engine: hypotheses
  share their common prefix physically, forks CoW the divergence block,
  and the per-tick top-k log-probs drive host-side hypothesis selection.

Accounting is exact by construction: used + free == n_blocks - 1 (the
null block is neither) at every instant (`BlockPool.check`).

Not ported yet (ROADMAP.md §1 item 2): two-tier paging (`host_tier=`,
the JAX package's framework/offload.py), the shadow-state sanitizer
(`PTPU_KV_SANITIZE=1`, serving/sanitizer.py over framework/ownership.py),
and the pager's gauges and KV watermarks. The first two raise
NotImplementedError when asked for.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import flags
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.executor import as_numpy
from .engine import ContinuousBatchingEngine, GenRequest, _ENGINE_SEQ

_UNPORTED = ("is not ported yet: it is the rest of ROADMAP.md §1 item 2 "
             "(paged, quantized and speculative serving, and the server)")


def _refuse_unported(host_tier):
    """Raise for the pager features the port does not have yet, instead
    of running without them."""
    if host_tier is not None:
        raise NotImplementedError(
            "two-tier KV paging (host_tier=, the JAX package's "
            "framework/offload.py) " + _UNPORTED)
    if flags.get_flag("kv_sanitize"):
        raise NotImplementedError(
            "the shadow-state KV sanitizer (PTPU_KV_SANITIZE=1, the JAX "
            "package's serving/sanitizer.py) " + _UNPORTED)


class BlockPool:
    """Free-list + refcount accounting over the device block pool.

    Host-side only — the device arrays are the engine's persistable
    pool vars; this class decides WHICH physical block holds what.
    Block 0 is reserved as the null block (idle-slot write target): it
    is never on the free list and never allocated. Invariant, checked
    on demand via `check()`: n_used + n_free == n_blocks - 1, and a
    block is on the free list iff its refcount is 0."""

    def __init__(self, n_blocks: int, block_size: int):
        enforce(n_blocks >= 2,
                "pool needs at least 2 blocks (block 0 is the reserved "
                "null block)", exc=InvalidArgumentError)
        enforce(block_size >= 1, "block_size must be >= 1",
                exc=InvalidArgumentError)
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free = list(range(n_blocks - 1, 0, -1))   # LIFO: reuse hot
        self._ref = [0] * n_blocks                      # ref[0] stays 0

    def alloc(self) -> Optional[int]:
        """Take a free block (refcount 1); None when the pool is dry —
        the caller decides whether to evict or wait."""
        if not self._free:
            return None
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def share(self, block: int):
        """One more holder of an allocated block (prefix share, beam
        fork, or the radix index's own retention ref)."""
        enforce(0 < block < self.n_blocks and self._ref[block] > 0,
                f"share of unallocated block {block}",
                exc=InvalidArgumentError)
        self._ref[block] += 1

    def release(self, block: int) -> bool:
        """Drop one ref; True when that freed the block (refcount hit
        0 and it returned to the free list)."""
        enforce(0 < block < self.n_blocks and self._ref[block] > 0,
                f"release of unallocated block {block}",
                exc=InvalidArgumentError)
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            return True
        return False

    def refcount(self, block: int) -> int:
        return self._ref[block]

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    def check(self):
        """Assert the accounting identity (tests + CI reconciliation):
        used + free == n_blocks - 1, free iff refcount 0."""
        enforce(self.n_used + self.n_free == self.n_blocks - 1,
                f"pool accounting broken: used({self.n_used}) + "
                f"free({self.n_free}) != {self.n_blocks - 1}",
                exc=InvalidArgumentError)
        free = set(self._free)
        enforce(len(free) == len(self._free),
                "pool free list holds duplicates",
                exc=InvalidArgumentError)
        for b in range(1, self.n_blocks):
            enforce((self._ref[b] == 0) == (b in free),
                    f"block {b}: refcount {self._ref[b]} vs free-list "
                    f"membership {b in free}", exc=InvalidArgumentError)
        enforce(self._ref[0] == 0 and 0 not in free,
                "null block 0 must stay unallocated and off the free "
                "list", exc=InvalidArgumentError)


class BlockTable:
    """One request's logical→physical block mapping. `blocks[j]` is the
    physical home of token positions [j*block_size, (j+1)*block_size);
    the leading `n_shared` entries came from the prefix index (read-only
    to this request — writes start at `shared_len`)."""

    __slots__ = ("blocks", "n_shared", "shared_len")

    def __init__(self, blocks: List[int], n_shared: int = 0,
                 shared_len: int = 0):
        self.blocks = list(blocks)
        self.n_shared = int(n_shared)
        self.shared_len = int(shared_len)

    def __len__(self):
        return len(self.blocks)

    def __repr__(self):
        return (f"BlockTable(blocks={self.blocks}, "
                f"n_shared={self.n_shared})")


class _RadixNode:
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key, block, parent):
        self.key = key              # tuple of block_size token ids
        self.block = block          # physical block holding their K/V
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixIndex:
    """Block-granular prompt-prefix index: a radix tree whose edges are
    FULL blocks of `block_size` tokens (a partial block is never
    sharable — its tail would be another request's garbage). Each node
    pins its physical block with one index-owned refcount, so cached
    prefixes survive their originating request until evicted. Matching
    walks children by exact token-tuple key; eviction is LRU over LEAF
    nodes only (a mid-chain eviction would break descendants' match
    paths while they still pin device blocks)."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self.root = _RadixNode((), None, None)
        self._clock = 0
        self.n_cached = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, prompt: Sequence[int], n: int) -> List[tuple]:
        bs = self.block_size
        return [tuple(prompt[j * bs:(j + 1) * bs]) for j in range(n)]

    def match(self, prompt: Sequence[int]) -> List[_RadixNode]:
        """Longest chain of cached FULL blocks prefixing `prompt`
        (match order = logical block order). Bumps LRU clocks."""
        node, out = self.root, []
        for key in self._keys(prompt, len(prompt) // self.block_size):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick()
            out.append(child)
            node = child
        return out

    def register(self, prompt: Sequence[int], logical_block: int,
                 phys: int, pool: BlockPool) -> bool:
        """Offer block `logical_block` of `prompt` (physically `phys`,
        just fully written) to the cache. No-ops when the content chain
        already exists (a concurrent request filled the same prefix
        first — the existing copy stays canonical) or when an ancestor
        chain node is missing (evicted mid-flight — registering would
        orphan the new node's match path). On success the index takes
        its OWN ref on `phys`, so the block outlives its request."""
        node = self.root
        keys = self._keys(prompt, logical_block + 1)
        for j, key in enumerate(keys):
            child = node.children.get(key)
            if child is None:
                if j < logical_block:
                    return False            # broken ancestor chain
                child = _RadixNode(key, phys, node)
                node.children[key] = child
                pool.share(phys)            # the index's retention ref
                self.n_cached += 1
                child.last_used = self._tick()
                return True
            child.last_used = self._tick()
            node = child
        return False                        # full chain already cached

    def evict_one(self, pool: BlockPool) -> bool:
        """Evict the least-recently-used LEAF node (zero children),
        dropping the index's ref on its block — the block frees iff no
        live table still holds it. False when the index is empty."""
        victim = None
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif victim is None or n.last_used < victim.last_used:
                victim = n
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        pool.release(victim.block)
        self.n_cached -= 1
        return True

    def evict_all(self, pool: BlockPool) -> int:
        n = 0
        while self.evict_one(pool):
            n += 1
        return n


class KVPager:
    """The paged-KV policy engine: owns the BlockPool and the
    RadixPrefixIndex, makes the admission / share / CoW / release /
    eviction / rollback decisions, and keeps the counters `stats()`
    reports. Device bytes are the engine's; this is the brain.

    Not ported yet (ROADMAP.md §1 item 2): the host tier (`host_tier=`,
    the JAX package's framework/offload.py) and the shadow-state
    sanitizer (PTPU_KV_SANITIZE=1, serving/sanitizer.py over
    framework/ownership.py). Asking for either raises NotImplementedError
    instead of running without it."""

    def __init__(self, n_blocks: int, block_size: int,
                 prefix_sharing: bool = True, host_tier=None):
        _refuse_unported(host_tier)
        self.block_size = int(block_size)
        self.prefix_sharing = bool(prefix_sharing)
        self.pool = BlockPool(n_blocks, block_size)
        self.index = RadixPrefixIndex(block_size)
        # -- counters (stats()) --
        self.n_admitted = 0
        self.prefix_hits = 0            # admissions with shared_len > 0
        self.shared_blocks_total = 0    # table entries served by the index
        self.blocks_allocated_total = 0
        self.evictions = 0
        self.cow_copies = 0
        self.rolled_back_blocks = 0     # speculative-decode rejected spans

    # -- admission --------------------------------------------------------
    def blocks_needed(self, length: int) -> int:
        return -(-int(length) // self.block_size)

    def try_admit(self, prompt: Sequence[int],
                  need_len: int) -> Optional[BlockTable]:
        """Acquire a block table spanning `need_len` token positions for
        `prompt`, serving the leading blocks from the prefix cache when
        possible. None when the pool (after LRU eviction of cached
        prefixes) cannot cover the private remainder — the scheduler
        leaves the request at the head of the queue (no starvation).

        The shared span is capped at block-aligned len(prompt)-1: a
        request always keeps >= 1 prompt position to feed through the
        tick, and its first write lands in its first PRIVATE block —
        writes can never target shared blocks."""
        n_logical = self.blocks_needed(need_len)
        shared_nodes: List[_RadixNode] = []
        if self.prefix_sharing:
            shared_nodes = self.index.match(prompt)
        max_shared = (len(prompt) - 1) // self.block_size
        shared_nodes = shared_nodes[:min(max_shared, n_logical)]
        # pin the matched blocks FIRST: eviction under pressure below
        # may drop their index nodes, but a pinned block cannot free
        blocks = []
        for node in shared_nodes:
            self.pool.share(node.block)
            blocks.append(node.block)
        need_new = n_logical - len(shared_nodes)
        for _ in range(need_new):
            b = self._alloc_or_evict()
            if b is None:                    # rollback, stay pending
                for held in blocks:
                    self.pool.release(held)
                return None
            blocks.append(b)
        n_shared = len(shared_nodes)
        self.n_admitted += 1
        self.blocks_allocated_total += need_new
        if n_shared:
            self.prefix_hits += 1
            self.shared_blocks_total += n_shared
        return BlockTable(blocks, n_shared, n_shared * self.block_size)

    def _alloc_or_evict(self) -> Optional[int]:
        while True:
            b = self.pool.alloc()
            if b is not None:
                return b
            if not self.index.evict_one(self.pool):
                return None
            self.evictions += 1

    # -- lifecycle --------------------------------------------------------
    def note_block_filled(self, table: BlockTable, logical_block: int,
                          prompt: Sequence[int]):
        """Block `logical_block` of the request just received its last
        row. If it is a FULL prompt block (generated tokens are not
        shareable prefix — they differ per request even for equal
        prompts under different max_new/eos) and not itself served from
        the index, offer it to the prefix cache NOW: a request arriving
        mid-prefill of its twin already shares the finished span."""
        if not self.prefix_sharing or logical_block < table.n_shared:
            return
        if (logical_block + 1) * self.block_size > len(prompt):
            return
        self.index.register(prompt, logical_block,
                            table.blocks[logical_block], self.pool)

    def fork(self, table: BlockTable, written_len: int,
             copy_block: Callable[[int, int], None]) -> BlockTable:
        """Split a hypothesis (beam search): the fork shares every FULLY
        written block by refcount, COPY-ON-WRITES the one partially
        written block (the divergence block — `copy_block(src, dst)`
        moves its device bytes), and takes fresh private blocks for the
        not-yet-written remainder. Raises when the pool cannot cover
        the fork even after eviction."""
        n_full, rem = divmod(int(written_len), self.block_size)
        blocks: List[int] = []
        try:
            for j, b in enumerate(table.blocks):
                if j < n_full:
                    self.pool.share(b)
                    blocks.append(b)
                    continue
                nb = self._alloc_or_evict()
                if nb is None:
                    raise InvalidArgumentError(
                        f"block pool exhausted forking at block {j} "
                        f"({self.pool.n_free} free of "
                        f"{self.pool.n_blocks - 1})")
                if j == n_full and rem:
                    copy_block(b, nb)        # CoW at the divergence block
                    self.cow_copies += 1
                blocks.append(nb)
                self.blocks_allocated_total += 1
        except Exception:
            for held in blocks:
                self.pool.release(held)
            raise
        return BlockTable(blocks, table.n_shared, table.shared_len)

    def release(self, table: BlockTable):
        """Drop the table's ref on every mapping (completion or fork
        retirement). Blocks the prefix index also holds stay resident
        (cached) until evicted; everything else frees."""
        for b in table.blocks:
            self.pool.release(b)
        table.blocks = []

    def rollback(self, table: BlockTable, keep_len: int,
                 written_len: int) -> int:
        """Roll back the table entries whose EVERY position lies in a
        speculative round's rejected span [keep_len, written_len):
        release the dirty block and remap the entry to a fresh one. The
        boundary block holding position keep_len-1 stays — its rejected
        tail is dead under the position mask and the next round's writes
        land on it before it is ever exposed.

        Written blocks are always PRIVATE (writes never target shared
        blocks — try_admit caps the shared span below the first write),
        so each release frees its block; allocating right after can
        therefore never come up dry (release-first guarantees the pool
        holds at least the block just freed). Both halves are enforced:
        a refcounted rollback block or a failed realloc is an invariant
        breach, not a condition to handle."""
        bs = self.block_size
        first = -(-int(keep_len) // bs)          # first fully-rejected block
        last = (int(written_len) - 1) // bs      # last written block
        n = 0
        for j in range(first, min(last + 1, len(table.blocks))):
            freed = self.pool.release(table.blocks[j])
            enforce(freed,
                    f"speculative rollback hit shared block "
                    f"{table.blocks[j]} (logical {j}) — writes must "
                    f"never land in shared blocks",
                    exc=InvalidArgumentError)
            nb = self.pool.alloc()
            enforce(nb is not None, "alloc after release came up dry",
                    exc=InvalidArgumentError)
            table.blocks[j] = nb
            n += 1
        self.rolled_back_blocks += n
        return n

    # -- introspection ----------------------------------------------------
    def stats(self) -> Dict:
        return {
            "n_blocks": self.pool.n_blocks,
            "block_size": self.block_size,
            "blocks_used": self.pool.n_used,
            "blocks_free": self.pool.n_free,
            "blocks_cached": self.index.n_cached,
            "prefix_sharing": self.prefix_sharing,
            "admitted": self.n_admitted,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.n_admitted
                                if self.n_admitted else 0.0),
            "shared_blocks_total": self.shared_blocks_total,
            "blocks_allocated_total": self.blocks_allocated_total,
            "blocks_per_request": (self.blocks_allocated_total
                                   / self.n_admitted
                                   if self.n_admitted else 0.0),
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "rolled_back_blocks": self.rolled_back_blocks,
            "host_tier": None,
        }


class PagedKVEngine(ContinuousBatchingEngine):
    """Continuous batching over the paged KV cache: the slot engine's
    scheduler and tick loop, with the per-slot [max_len] KV rows
    replaced by block tables over one shared pool.

    What changes against the parent (every override is one of the
    parent's named hooks — the scheduler itself is shared, which is what
    makes the decode-identity guarantee auditable):

    - the tick is `transformer_lm_paged_decode_tick` (gather by block
      table + `paged_cache_write`; the same attention chain, fused into
      the same decode-attention kernel over the gathered view, which holds
      the slot tick's bytes);
    - admission acquires a BlockTable from the `KVPager` (head-of-line
      wait under pool pressure — `_admit_request` returning False);
      prefix hits start the request at `fed = shared_len`, skipping the
      shared span's prefill ticks;
    - completion releases the table; full prompt blocks were offered to
      the prefix index the moment they filled (`_note_position_written`);
    - `max_len` means the block-table SPAN (blocks_per_req × block_size —
      the per-request logical ceiling), not a per-slot reservation:
      n_blocks may be far smaller than n_slots × blocks_per_req, which is
      the capacity play.

    `topk_k` > 0 also fetches each tick's top-k log-probs —
    `paged_beam_search`'s scoring surface. `kv_quant=True` stores the
    pools as int8 with a float32 scale per (block, head, row); at the
    default pool budget the freed bytes buy more blocks
    (`kv_quant_freed_bytes`). `host_tier=` (the JAX package's two-tier
    paging) is not ported yet and raises NotImplementedError.
    """

    def __init__(self, n_slots: int = 4, vocab: int = 32000,
                 max_len: int = 64, d_model: int = 512,
                 d_inner: int = 2048, num_heads: int = 8,
                 num_layers: int = 6, dropout: float = 0.0,
                 packed: bool = False, eos_id: Optional[int] = None,
                 scope=None, policy: str = "continuous",
                 cache_prefix: Optional[str] = None, block_size: int = 8,
                 n_blocks: Optional[int] = None,
                 prefix_sharing: bool = True, topk_k: int = 0,
                 quant: Optional[str] = None, kv_quant: bool = False,
                 speculative=None, host_tier=None, place=None):
        _refuse_unported(host_tier)
        self.block_size = int(block_size)
        self.blocks_per_req = -(-int(max_len) // self.block_size)
        self.prefix_sharing = bool(prefix_sharing)
        self.topk_k = int(topk_k)
        self.kv_quant = bool(kv_quant)
        # int8 KV block pools: the payload is int8 with one f32 scale per
        # (block, head, row), so a block costs nh*bs*(dh+4) bytes instead
        # of nh*bs*dh*4 per k/v per layer. At the SAME byte budget the
        # freed bytes buy extra blocks: the capacity-neutral default
        # n_blocks is scaled up by bytes_f32/bytes_int8 (an explicit
        # n_blocks is honored as-is — the caller owns the budget then).
        dh = d_model // num_heads
        per_blk_f32 = 2 * num_layers * num_heads * self.block_size * dh * 4
        per_blk_i8 = 2 * num_layers * num_heads * self.block_size * (dh + 4)
        self.kv_quant_freed_bytes = 0
        if n_blocks is None:
            # capacity-neutral default: every slot can hold a full-span
            # request (+ the null block)
            n_blocks = n_slots * self.blocks_per_req + 1
            if self.kv_quant:
                budget = (n_blocks - 1) * per_blk_f32
                n_blocks = 1 + budget // per_blk_i8
        if self.kv_quant:
            self.kv_quant_freed_bytes = \
                (int(n_blocks) - 1) * (per_blk_f32 - per_blk_i8)
        self.n_blocks = int(n_blocks)
        enforce(self.n_blocks >= self.blocks_per_req + 1,
                f"pool of {self.n_blocks} blocks cannot hold one "
                f"full-span request ({self.blocks_per_req} blocks + the "
                f"null block)", exc=InvalidArgumentError)
        self.pager = KVPager(self.n_blocks, self.block_size,
                             prefix_sharing)
        if cache_prefix is None:
            cache_prefix = f"pgd{next(_ENGINE_SEQ)}"
        super().__init__(
            n_slots=n_slots, vocab=vocab,
            max_len=self.blocks_per_req * self.block_size,
            d_model=d_model, d_inner=d_inner, num_heads=num_heads,
            num_layers=num_layers, dropout=dropout, packed=packed,
            eos_id=eos_id, scope=scope, policy=policy,
            cache_prefix=cache_prefix, quant=quant,
            speculative=speculative, place=place)

    # -- tick program -----------------------------------------------------
    def _build_tick_program(self, n_slots, vocab, max_len, d_model,
                            d_inner, num_heads, num_layers, dropout,
                            packed, cache_prefix):
        from ..models import transformer
        outs = transformer.transformer_lm_paged_decode_tick(
            n_slots=n_slots, n_blocks=self.n_blocks,
            block_size=self.block_size,
            blocks_per_req=self.blocks_per_req, vocab=vocab,
            d_model=d_model, d_inner=d_inner, num_heads=num_heads,
            num_layers=num_layers, dropout=dropout, packed=packed,
            cache_prefix=cache_prefix, topk_k=self.topk_k,
            kv_quant=self.kv_quant)
        if self.topk_k:
            (self._next_ids, self.cache_names,
             self._topk_logp, self._topk_ids) = outs
        else:
            self._next_ids, self.cache_names = outs

    def _init_tick_feeds(self) -> Dict[str, np.ndarray]:
        f = super()._init_tick_feeds()
        f["tick_btab"] = np.zeros((self.n_slots, self.blocks_per_req),
                                  np.int64)
        f["tick_wblock"] = np.zeros((self.n_slots,), np.int64)
        f["tick_woff"] = np.zeros((self.n_slots,), np.int64)
        return f

    def _tick_fetches(self):
        if self.topk_k:
            return [self._next_ids, self._topk_logp, self._topk_ids]
        return [self._next_ids]

    def _fill_tick_feeds(self, active: Dict[int, GenRequest]):
        super()._fill_tick_feeds(active)        # tok/pos rows
        btab = self._feeds["tick_btab"]
        wblock = self._feeds["tick_wblock"]
        woff = self._feeds["tick_woff"]
        btab[:] = 0                              # idle slots → null block
        wblock[:] = 0
        woff[:] = 0
        bs = self.block_size
        for slot, req in active.items():
            blocks = req.table.blocks
            btab[slot, :len(blocks)] = blocks
            lb, off = divmod(req.fed, bs)
            wblock[slot] = blocks[lb]
            woff[slot] = off

    # -- scheduler hooks --------------------------------------------------
    def _admit_request(self, req: GenRequest) -> bool:
        need_len = min(len(req.prompt) + req.max_new, self.max_len)
        table = self.pager.try_admit(req.prompt, need_len)
        if table is None:
            return False                         # head-of-line wait
        req.table = table
        req.shared_len = table.shared_len
        if table.shared_len:
            # the shared span's K/V is already resident and byte-exact
            # (deterministic compute) — skip its prefill ticks
            req.fed = table.shared_len
            req.next_tok = req.prompt[table.shared_len]
        return True

    def _release_request(self, req: GenRequest):
        if req.table is not None:
            self.pager.release(req.table)
            req.table = None

    def _note_position_written(self, req: GenRequest, pos: int):
        if (pos + 1) % self.block_size == 0:
            self.pager.note_block_filled(req.table,
                                         pos // self.block_size,
                                         req.prompt)

    # -- speculative-decoding hooks (serving/speculative.py) --------------
    def _build_verify_tick(self, gamma):
        from ..models import transformer
        d = self._builder_dims
        return transformer.transformer_lm_paged_spec_verify_tick(
            self.n_slots, gamma, n_blocks=self.n_blocks,
            block_size=self.block_size,
            blocks_per_req=self.blocks_per_req, vocab=d["vocab"],
            d_model=d["d_model"], d_inner=d["d_inner"],
            num_heads=d["num_heads"], num_layers=d["num_layers"],
            dropout=d["dropout"], packed=d["packed"],
            cache_prefix=self._cache_prefix, kv_quant=self.kv_quant)

    def _init_verify_feeds(self, g):
        f = super()._init_verify_feeds(g)
        f["spec_btab"] = np.zeros((self.n_slots, self.blocks_per_req),
                                  np.int64)
        f["spec_wblock"] = np.zeros((self.n_slots, g), np.int64)
        f["spec_woff"] = np.zeros((self.n_slots, g), np.int64)
        return f

    def _fill_verify_row(self, feeds, slot, req, g):
        super()._fill_verify_row(feeds, slot, req, g)
        blocks = req.table.blocks
        feeds["spec_btab"][slot, :len(blocks)] = blocks
        bs = self.block_size
        for j in range(g):
            lb, off = divmod(req.fed + j, bs)
            feeds["spec_wblock"][slot, j] = blocks[lb]
            feeds["spec_woff"][slot, j] = off

    def _spec_capable(self, req, g) -> bool:
        # the round's G writes must stay inside the request's block-table
        # span (the host-side block lookup would index past the table)
        return (req.fed + g <= self.max_len
                and req.fed + g <= len(req.table.blocks) * self.block_size)

    def _spec_rollback(self, req, keep_len, written_len) -> int:
        return self.pager.rollback(req.table, keep_len, written_len)

    # -- limits -----------------------------------------------------------
    def _enforce_request_fits(self, prompt, max_new):
        enforce(len(prompt) + int(max_new) <= self.max_len,
                f"prompt({len(prompt)}) + max_new({max_new}) exceeds the "
                f"paged engine's per-request block-table span "
                f"blocks_per_req({self.blocks_per_req}) x block_size"
                f"({self.block_size}) = {self.max_len} tokens; pool "
                f"capacity ({self.n_blocks - 1} blocks) governs "
                f"ADMISSION (requests queue for blocks), not submission",
                exc=InvalidArgumentError)

    # -- device block ops -------------------------------------------------
    def _copy_block(self, src: int, dst: int):
        """Copy physical block src → dst across every layer's k/v pool
        (and scale pool): the CoW move, between ticks, in place on the
        pool tensors. The tick itself never writes a shared block, so this
        is the only writer that can touch one, and it only reads it."""
        for name in self.cache_names:
            arr = self.scope.get(name)
            arr[dst] = arr[src]

    def stats(self) -> Dict:
        s = super().stats()
        s["pager"] = self.pager.stats()
        s["kv_quant"] = {"enabled": self.kv_quant,
                         "freed_bytes": self.kv_quant_freed_bytes}
        return s


def paged_beam_search(engine: PagedKVEngine, prompt: Sequence[int],
                      max_new: int, beam_size: int,
                      eos_id: Optional[int] = None
                      ) -> List[Tuple[List[int], float]]:
    """Beam search through a PagedKVEngine's compiled tick, with the
    beams' common prefix held ONCE in the block pool.

    The prompt prefills a single hypothesis; the fork into `beam_size`
    beams shares every fully-written block by refcount and copy-on-
    writes the partial divergence block (`KVPager.fork`). Each decode
    tick runs all live beams as independent tick slots; the tick's
    top-k log-probs (engine built with `topk_k >= beam_size`) score the
    beam_size × k candidate extensions on the host, and every parent
    that survives in more than one child is forked again — CoW at the
    new divergence block. Beams that emit `eos_id` retire with their
    score frozen.

    Prefix sharing composes transparently: a cached prefix (from an
    earlier request, or a previous beam call with the same prompt)
    short-circuits the prefill exactly as in greedy serving, and the
    result is token-identical either way — shared blocks hold byte-
    identical K/V because compute is deterministic (held by
    tests/test_torch_kv_pager.py).

    Returns [(tokens, cumulative log-prob)] sorted best-first,
    `beam_size` entries. The engine must be idle — beam decode owns
    every tick slot while it runs. The log-probs come from the tick's
    top-k in the logits' dtype (bfloat16 under the bf16 matmul policy),
    summed on the host in float64, as in the JAX package."""
    enforce(isinstance(engine, PagedKVEngine),
            "paged_beam_search needs a PagedKVEngine",
            exc=InvalidArgumentError)
    enforce(engine.topk_k >= beam_size,
            f"engine was built with topk_k={engine.topk_k}; beam_size="
            f"{beam_size} needs topk_k >= beam_size",
            exc=InvalidArgumentError)
    enforce(beam_size >= 1 and beam_size <= engine.n_slots,
            f"beam_size {beam_size} must fit the engine's "
            f"{engine.n_slots} tick slots", exc=InvalidArgumentError)
    enforce(engine.n_active == 0 and engine.n_pending == 0,
            "paged_beam_search needs an idle engine (it owns every "
            "tick slot)", exc=InvalidArgumentError)
    prompt = [int(t) for t in prompt]
    max_new = int(max_new)
    enforce(len(prompt) >= 1 and max_new >= 1,
            "need a non-empty prompt and max_new >= 1",
            exc=InvalidArgumentError)
    engine._enforce_request_fits(prompt, max_new)
    pager, bs, P = engine.pager, engine.block_size, len(prompt)
    need_len = min(P + max_new, engine.max_len)

    root = pager.try_admit(prompt, need_len)
    enforce(root is not None,
            "block pool exhausted (even after eviction) — cannot admit "
            "the beam root", exc=InvalidArgumentError)

    feeds = engine._feeds

    def _zero():
        for a in feeds.values():
            a[:] = 0

    def _tick(slots):
        """slots: {slot: (tok, pos, table)} — run one tick, return
        (topk_logp [S,1,k], topk_ids [S,1,k]) as numpy."""
        _zero()
        for slot, (tok, pos, table) in slots.items():
            feeds["tick_tok"][slot, 0] = tok
            feeds["tick_pos"][slot, 0, 0] = float(pos)
            feeds["tick_btab"][slot, :len(table.blocks)] = table.blocks
            lb, off = divmod(pos, bs)
            feeds["tick_wblock"][slot] = table.blocks[lb]
            feeds["tick_woff"][slot] = off
        out = engine._step.run(feeds)
        # run() re-pointed the main step's bound state at the live cache
        # tensors — a co-resident speculative verify step refreshes
        # before it next runs
        engine._target_state_owner = "main"
        engine.n_ticks += 1
        engine.target_forwards += 1
        engine.last_tick_at = time.time()
        return as_numpy(out[1]), as_numpy(out[2])

    # -- prefill the root hypothesis through slot 0 (shared span skipped)
    logp = ids = None
    for pos in range(root.shared_len, P):
        logp, ids = _tick({0: (prompt[pos], pos, root)})
        if (pos + 1) % bs == 0:
            pager.note_block_filled(root, pos // bs, prompt)

    # -- fork the root into beam_size hypotheses (CoW at the partial
    #    block; with P % bs == 0 the fork is pure sharing, zero copies)
    beams = []
    for b in range(beam_size):
        table = pager.fork(root, P, engine._copy_block)
        tok = int(ids[0, 0, b])
        beams.append({"table": table, "tokens": [tok], "next_tok": tok,
                      "score": float(logp[0, 0, b]), "alive": True})
    pager.release(root)
    finished: List[Dict] = []
    for beam in beams:
        if eos_id is not None and beam["next_tok"] == eos_id:
            beam["alive"] = False
            finished.append(beam)
    beams = [b_ for b_ in beams if b_["alive"]]

    # -- decode: all live beams per tick, host-side candidate selection
    for g in range(1, max_new):
        if not beams:
            break
        slots = {i: (beam["next_tok"], P - 1 + g, beam["table"])
                 for i, beam in enumerate(beams)}
        logp, ids = _tick(slots)
        cands = []
        for i, beam in enumerate(beams):
            for j in range(beam_size):
                cands.append((beam["score"] + float(logp[i, 0, j]),
                              i, int(ids[i, 0, j])))
        cands.sort(key=lambda c: c[0], reverse=True)
        cands = cands[:len(beams)]
        # fork parents that survive in >1 child; retire the childless.
        # Forks run BEFORE any child's next write, so the parent's
        # blocks still hold exactly the shared history (written_len =
        # P + g positions).
        n_children = {}
        for _, i, _t in cands:
            n_children[i] = n_children.get(i, 0) + 1
        new_beams = []
        taken = {}
        for score, i, tok in cands:
            parent = beams[i]
            taken[i] = taken.get(i, 0) + 1
            if taken[i] < n_children[i]:
                table = pager.fork(parent["table"], P + g,
                                   engine._copy_block)
            else:
                table = parent["table"]      # last child inherits
            nb = {"table": table, "tokens": parent["tokens"] + [tok],
                  "next_tok": tok, "score": score, "alive": True}
            new_beams.append(nb)
        for i, beam in enumerate(beams):
            if i not in n_children:
                pager.release(beam["table"])
        beams = []
        for nb in new_beams:
            if eos_id is not None and nb["next_tok"] == eos_id:
                nb["alive"] = False
                finished.append(nb)
            else:
                beams.append(nb)

    finished.extend(beams)
    for beam in finished:
        if beam["table"].blocks:
            pager.release(beam["table"])
    _zero()
    finished.sort(key=lambda b_: b_["score"], reverse=True)
    return [(beam["tokens"], beam["score"])
            for beam in finished[:beam_size]]
