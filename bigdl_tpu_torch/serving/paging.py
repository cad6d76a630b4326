"""Host-side paged KV-cache allocation: block tables, refcounted prefix
sharing, copy-on-write and typed exhaustion.

The port's own copy of ``bigdl_tpu/serving/paging.py`` (pure host code,
kept identical in behaviour): the device holds one pool of
``num_blocks`` blocks of ``block_size`` positions per layer
(``TransformerLM.init_paged_cache``), and every sequence owns a
host-side block table mapping its logical blocks to physical ids.
Tables pad to ``max_blocks_per_seq`` with the TRASH id, which padding
rows and inactive decode rows write into and nobody reads.

- prefix caching: a full block's chained content hash is registered
  after prefill fills it; a later prompt with the same leading tokens
  maps the shared block (refcount++) and skips its prefill;
- copy-on-write: a write into a shared block first detaches onto a
  private copy;
- typed exhaustion: a request the pool cannot hold is refused at
  admission with ``BlockPoolExhausted``.
"""

import collections
import hashlib
import threading


class BlockPoolExhausted(RuntimeError):
    """The block pool cannot hold this sequence: admission is REFUSED
    (typed, so a fleet/engine can shed or retry elsewhere) instead of
    evicting or corrupting a live neighbour's cache."""


def chain_hash(parent, tokens):
    """Content hash of one full block given its prefix's hash: equal
    hashes mean equal (prefix + block) token histories, which is what
    makes a hash hit safe to map into another sequence's table."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent.encode() if parent else b"\x00")
    h.update(bytes(str(list(int(t) for t in tokens)), "utf-8"))
    return h.hexdigest()


class _Seq:
    __slots__ = ("table", "pending")

    def __init__(self):
        self.table = []          # logical block index -> physical id
        self.pending = {}        # logical block index -> hash to
        #                          register once prefill fills it


class BlockAllocator:
    """Physical block ids are ``[0, num_blocks)``; ``trash`` is the
    extra id ``num_blocks`` the device pool allocates on top -- padding
    rows and inactive decode rows scatter there, it is never owned.

    Thread-safe (one internal lock): the scheduler's dispatcher thread
    allocates/frees while an engine thread may ``flush_cached()`` on a
    weight swap (cached K/V computed under the OLD weights must not
    serve new prompts)."""

    def __init__(self, num_blocks: int, block_size: int,
                 kv_dtype: str = "fp32", bytes_per_block=None):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}/{block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        #: what the device pool stores per position ("fp32"); pure
        #: metadata here: it namespaces the prefix-cache
        #: hashes so quantized and full-precision block contents can
        #: NEVER satisfy each other's matches, and it travels through
        #: stats() so observability cites the real storage format.
        self.kv_dtype = str(kv_dtype)
        #: device bytes behind ONE addressable block across every pool
        #: leaf (int8 payloads AND their scale tensors), measured by the
        #: scheduler from the pool it allocated.  None until a pool owner sets it.
        self.bytes_per_block = None if bytes_per_block is None \
            else int(bytes_per_block)
        self.trash = self.num_blocks
        self._lock = threading.Lock()
        self._free = collections.deque(range(self.num_blocks))
        self._ref = {}                       # physical id -> refcount
        self._hash_of = {}                   # physical id -> content hash
        self._by_hash = {}                   # content hash -> physical id
        #: ref-0 registered blocks, LRU order: reusable as prefix hits
        #: until the pool needs the frames back
        self._cached = collections.OrderedDict()   # hash -> physical id
        self._seqs = {}                      # seq id -> _Seq
        # lifetime counters (telemetry deltas are the caller's job)
        self.prefix_hits = 0                 # blocks served from cache
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.sheds = 0

    # ----- pool accounting --------------------------------------------------- #
    def stats(self):
        with self._lock:
            used = len(self._ref)
            cached = len(self._cached)
            pb = self.bytes_per_block
            return {"blocks_total": self.num_blocks,
                    "blocks_used": used,
                    "blocks_cached": cached,
                    "blocks_free": self.num_blocks - used - cached,
                    "sequences": len(self._seqs),
                    "kv_dtype": self.kv_dtype,
                    # allocator-reported bytes (ROADMAP item 3's rule:
                    # obs_report and the bench cite these, never
                    # hand-computed dtype math); None until the pool
                    # owner measured the device tree
                    "bytes_per_block": pb,
                    "pool_bytes": None if pb is None
                    else pb * self.num_blocks,
                    "prefix_hits": self.prefix_hits,
                    "prefix_hit_tokens": self.prefix_hit_tokens,
                    "cow_copies": self.cow_copies,
                    "sheds": self.sheds}

    def _alloc_block(self):
        """One free physical block, evicting the LRU cached (ref-0)
        block if the free list is dry.  Caller holds the lock."""
        if self._free:
            b = self._free.popleft()
        elif self._cached:
            _h, b = self._cached.popitem(last=False)      # LRU out
            self._hash_of.pop(b, None)
            self._by_hash.pop(_h, None)
        else:
            raise BlockPoolExhausted(
                f"KV block pool exhausted ({self.num_blocks} blocks of "
                f"{self.block_size} positions, all referenced by live "
                f"sequences); raise kv_blocks or shed load")
        self._ref[b] = 1
        return b

    @property
    def _hash_root(self):
        """Root parent for every sequence's hash chain.  fp32 pools
        keep the original ``""`` root; any narrower storage namespaces
        its chains, so an int8 pool's registered blocks can never
        answer an fp32 pool's match even if registries were merged or
        serialized across processes."""
        return "" if self.kv_dtype == "fp32" else f"kv:{self.kv_dtype}"

    # ----- sequence lifecycle ------------------------------------------------ #
    def begin_sequence(self, seq_id, prompt, max_positions: int,
                       kv_dtype=None) -> int:
        """Admit one sequence: match its prompt's full blocks against
        the prefix cache, then RESERVE enough fresh blocks to cover
        ``max_positions`` (prompt + the whole token budget) so decode
        can never hit exhaustion mid-flight.  Returns ``cached_len`` --
        how many leading prompt positions need NO prefill compute.

        Matching is capped below the prompt's LAST token: the final
        position must always be computed (its logits produce the first
        generated token), so a fully-cached prompt still runs a 1+
        token prefill -- which also guarantees prefill writes only ever
        target this sequence's private blocks.

        On ``BlockPoolExhausted`` nothing is retained (the typed shed
        leaves every neighbour's table untouched).

        ``kv_dtype`` (optional) declares the storage format the caller
        expects its prefix hits to hold; a mismatch with this pool's
        format is refused legibly -- an fp32 request must never read
        int8 blocks as if they were full-precision K/V (and vice
        versa)."""
        if kv_dtype is not None and str(kv_dtype) != self.kv_dtype:
            raise ValueError(
                f"KV-dtype mismatch: this block pool stores "
                f"{self.kv_dtype} blocks but sequence {seq_id!r} "
                f"expects {kv_dtype}; prefix-cache contents do not "
                f"convert across storage formats -- serve the request "
                f"from a pool built with kv_cache_dtype={kv_dtype!r}")
        bs = self.block_size
        prompt = [int(t) for t in prompt]
        matchable = max(0, (len(prompt) - 1) // bs)   # full blocks only,
        #                                               last token excluded
        with self._lock:
            if seq_id in self._seqs:
                raise ValueError(f"sequence {seq_id!r} already admitted")
            seq = _Seq()
            parent, matched = self._hash_root, 0
            try:
                for i in range(matchable):
                    h = chain_hash(parent, prompt[i * bs:(i + 1) * bs])
                    b = self._by_hash.get(h)
                    if b is None:
                        # first miss ends the match; remember the hash so
                        # commit_full_blocks can register it post-prefill
                        seq.pending[i] = h
                        parent = h
                        continue
                    if i != matched:
                        break                 # only a LEADING run shares
                    if b in self._cached.values():
                        self._cached.pop(self._hash_of[b], None)
                        self._ref[b] = 1
                    else:
                        self._ref[b] += 1
                    seq.table.append(b)
                    matched += 1
                    parent = h
                # chain hashes for the unmatched full blocks (including
                # any skipped above) -- recompute cleanly from the last
                # MATCHED parent so pending hashes stay a pure chain
                seq.pending = {}
                parent = self._hash_of.get(seq.table[-1], "") \
                    if seq.table else self._hash_root
                for i in range(matched, matchable):
                    h = chain_hash(parent, prompt[i * bs:(i + 1) * bs])
                    seq.pending[i] = h
                    parent = h
                need = -(-int(max_positions) // bs)
                while len(seq.table) < need:
                    seq.table.append(self._alloc_block())
            except BlockPoolExhausted:
                self.sheds += 1
                for b in seq.table:
                    self._release_block(b)
                raise
            self._seqs[seq_id] = seq
            self.prefix_hits += matched
            self.prefix_hit_tokens += matched * bs
            return matched * bs

    def _release_block(self, b):
        """Drop one reference; a ref-0 block returns to the free list,
        unless it is hash-registered -- then it parks in the LRU cache,
        still answering prefix matches until evicted.  Lock held."""
        self._ref[b] -= 1
        if self._ref[b] > 0:
            return
        del self._ref[b]
        h = self._hash_of.get(b)
        if h is not None and self._by_hash.get(h) == b:
            self._cached[h] = b
            self._cached.move_to_end(h)
        else:
            self._hash_of.pop(b, None)
            self._free.append(b)

    def free_sequence(self, seq_id):
        """Release every block the sequence maps (refcount--); shared
        prefix blocks survive for their other readers / the LRU."""
        with self._lock:
            seq = self._seqs.pop(seq_id, None)
            if seq is None:
                return
            for b in seq.table:
                self._release_block(b)

    def commit_full_blocks(self, seq_id, filled_positions: int):
        """Register the content hashes of this sequence's now-FULL
        prefill blocks (``filled_positions`` prompt positions hold real
        K/V) so later admissions can share them.  A hash already
        registered by a concurrent twin keeps ITS block (ours stays
        private -- registration is first-writer-wins, never a content
        swap: two executables' bit-identical-in-theory outputs are not
        worth betting a shared cache on)."""
        bs = self.block_size
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                return
            for i in sorted(list(seq.pending)):
                if (i + 1) * bs > int(filled_positions):
                    break
                h = seq.pending.pop(i)
                b = seq.table[i]
                if h not in self._by_hash and b not in self._hash_of:
                    self._by_hash[h] = b
                    self._hash_of[b] = h

    def ensure_writable(self, seq_id, position: int):
        """Copy-on-write guard before a K/V write at ``position``:

        - the target block is SHARED (refcount > 1): detach -- allocate
          a private block, remap the table, return ``(src, dst)`` so
          the caller issues the device-side block copy;
        - the target block is this sequence's own but hash-REGISTERED
          (a future request could still map it): unregister instead of
          copying (cheaper, same safety), return ``None``;
        - plain private block: return ``None``.
        """
        bs = self.block_size
        with self._lock:
            seq = self._seqs.get(seq_id)
            if seq is None:
                raise KeyError(f"unknown sequence {seq_id!r}")
            idx = int(position) // bs
            if idx >= len(seq.table):
                raise IndexError(
                    f"position {position} beyond the reserved table "
                    f"({len(seq.table)} blocks) for sequence {seq_id!r}")
            b = seq.table[idx]
            if self._ref[b] > 1:
                dst = self._alloc_block()
                seq.table[idx] = dst
                self._ref[b] -= 1
                self.cow_copies += 1
                return b, dst
            h = self._hash_of.pop(b, None)
            if h is not None and self._by_hash.get(h) == b:
                del self._by_hash[h]
            return None

    def flush_cached(self):
        """Drop the prefix cache: LRU blocks return to the free list
        and every hash registration is forgotten.  Called on a weight
        swap -- cached K/V computed under the old weights must not
        serve new prompts (live sequences keep their mapped blocks and
        finish on mixed weights, the same documented trade as PR 15's
        mid-flight refresh)."""
        with self._lock:
            for h, b in list(self._cached.items()):
                self._hash_of.pop(b, None)
                self._free.append(b)
            self._cached.clear()
            self._by_hash.clear()
            # live sequences' pending registrations would now chain off
            # stale parents; drop them too
            for seq in self._seqs.values():
                seq.pending.clear()

    def table_row(self, seq_id, max_blocks: int):
        """The sequence's block table padded to ``max_blocks`` with the
        trash id -- the fixed-shape row the compiled steps consume."""
        with self._lock:
            seq = self._seqs.get(seq_id)
            table = list(seq.table) if seq is not None else []
        if len(table) > max_blocks:
            raise ValueError(
                f"sequence {seq_id!r} maps {len(table)} blocks but the "
                f"compiled step holds {max_blocks}")
        return table + [self.trash] * (max_blocks - len(table))
