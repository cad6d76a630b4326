"""Autoregressive generation serving: KV-cache decode steps and a
slot-based continuous-batching scheduler (counterpart of
``bigdl_tpu/serving/generation.py``).

- ``generate_steps(model)`` -- the (prefill, decode) pair over a
  contiguous ``slots x max_len`` cache (greedy).
- ``GenerateScheduler`` -- continuous batching over a fixed pool of
  decode slots plus one TRASH row that prefill padding rows write into.
  A dispatcher thread alternates prefill ticks (admit waiting prompts,
  batch and length bucketed) with decode ticks (every occupied slot
  advances one token).
- ``paged_generate_steps(model)`` / ``PagedGenerateScheduler`` -- the same
  contract over a paged block pool (``serving/paging.py``): prefix
  sharing, chunked prefill interleaved with decode, and sampling
  (``serving/sampling.py``).
- ``GenerateFuture`` -- the streaming per-request handle.

The JAX steps are jitted and donate the cache; these run eagerly under
``torch.no_grad()`` and write the cache in place.  The attention inside
them goes through the CUDA kernels on the card (``ops/flash_attention``).
"""

import collections
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future, TimeoutError as FutureTimeoutError
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.serving.buckets import BucketLadder
from bigdl_tpu_torch.serving.paging import BlockAllocator, BlockPoolExhausted
from bigdl_tpu_torch.serving.sampling import sample_tokens

log = logging.getLogger("bigdl_tpu_torch.serving")


def _tensor(x, device, dtype=torch.int32):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _last_valid_row(logits, lengths):
    """Each row's logits at its last real position ``lengths - 1``."""
    n, t = logits.shape[:2]
    idx = (lengths.long() - 1).clamp(0, t - 1)
    return logits[torch.arange(n, device=logits.device), idx]


def generate_steps(model):
    """The ``(prefill, decode)`` pair over a contiguous slot cache.

    - ``prefill(slot_cache, tokens (B, T), lengths (B,), slot_ids (B,))
      -> first_tokens (B,)``: runs the cached forward over the padded
      prompt batch, copies its K/V into the slot rows ``slot_ids``
      (padding rows name the trash row) and reads each row's first
      token at its true ``length - 1``.
    - ``decode(slot_cache, tokens (S,), pos (S,)) -> next_tokens (S,)``:
      one step over the whole pool.

    Inputs are host int arrays, results numpy; the cache is written in
    place.
    """
    dev = model.device

    @torch.no_grad()
    def prefill(slot_cache, tokens, lengths, slot_ids):
        tok = _tensor(tokens, dev)
        n, t = tok.shape
        local = model.init_cache(n, t)
        logits, frag = model(tok, cache=local)
        row = _last_valid_row(logits, _tensor(lengths, dev))
        first = torch.argmax(row, dim=-1)
        sid = _tensor(slot_ids, dev, torch.int64)
        for name, layer in slot_cache.items():
            for kv in ("k", "v"):
                layer[kv][sid, :t] = frag[name][kv]
        return first.cpu().numpy().astype(np.int32)

    @torch.no_grad()
    def decode(slot_cache, tokens, pos):
        tok = _tensor(tokens, dev)
        logits, _ = model(tok[:, None], cache=slot_cache,
                          pos=_tensor(pos, dev))
        return torch.argmax(logits[:, 0], dim=-1).cpu().numpy().astype(
            np.int32)

    return prefill, decode


class GenerateFuture(Future):
    """Per-request generation handle.  ``result(timeout)`` returns the
    full generated token list (EOS included when hit); ``stream()``
    yields tokens as ticks complete.  Once finished, ``finish_reason``
    ("eos" / "length" / "abandoned"), ``latency_s`` and its split
    ``queue_wait_s`` / ``decode_s`` are set; ``first_token_s`` is the
    time from submission to the first generated token."""

    def __init__(self, prompt_len: int, max_new_tokens: int,
                 eos_id: Optional[int]):
        super().__init__()
        self.prompt_len = int(prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.finish_reason: Optional[str] = None
        self.latency_s: Optional[float] = None
        self.queue_wait_s: Optional[float] = None
        self.decode_s: Optional[float] = None
        self.first_token_s: Optional[float] = None
        self._t_submit = time.perf_counter()
        self._t_admit: Optional[float] = None
        #: SamplingParams for this request (None = greedy argmax)
        self.sampling = None
        #: prompt positions served from the prefix cache (paged only)
        self.prefix_hit_tokens = 0
        self._stream: "queue.Queue" = queue.Queue()
        #: set by GenerateScheduler._abandon on a CLAIMED request: the
        #: dispatcher evicts the sequence at the next tick boundary
        self._abandoned = False

    def stream(self, timeout: Optional[float] = None):
        """Yield generated token ids as they are produced.  ``timeout``
        bounds the WHOLE stream; a tick that errors re-raises here."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        while True:
            remaining = None if deadline is None \
                else deadline - time.perf_counter()
            if remaining is not None and remaining <= 0:
                raise FutureTimeoutError(
                    f"token stream timed out after {timeout}s")
            try:
                item = self._stream.get(timeout=remaining)
            except queue.Empty:
                raise FutureTimeoutError(
                    f"token stream timed out after {timeout}s") from None
            if item is None:                      # completion sentinel
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class _Slot:
    """One occupied decode slot: ``pos`` is where the NEXT token's K/V is
    written, ``last`` the token the next decode step feeds in."""

    __slots__ = ("fut", "tokens", "last", "pos")

    def __init__(self, fut, first_token, pos):
        self.fut = fut
        self.tokens = [first_token]
        self.last = first_token
        self.pos = pos


class GenerateScheduler:
    """Slot-based continuous batching over one model's contiguous KV
    cache: ``slots`` decode slots plus one trash row share one
    ``model.init_cache(slots + 1, max_len)``.  Finished sequences free
    their slot at once; the next prefill reuses it.  Greedy only."""

    #: the paged scheduler samples; this one refuses non-greedy requests
    supports_sampling = False

    def __init__(self, model, slots: int = 8, max_len: Optional[int] = None,
                 prompt_ladder: Optional[BucketLadder] = None,
                 queue_capacity: int = 1024, admission_check=None):
        if not hasattr(model, "init_cache"):
            raise TypeError(
                f"{type(model).__name__} has no init_cache(): generation "
                f"needs a KV-cache decode mode (TransformerLM has one)")
        if slots < 1:
            raise ValueError(f"need at least 1 decode slot, got {slots}")
        self.model = model
        self.slots = int(slots)
        model_max = getattr(model, "max_len", None)
        self.max_len = int(model_max if max_len is None
                           else min(max_len, model_max or max_len))
        self.queue_capacity = int(queue_capacity)
        #: callable run under this scheduler's lock right before a request
        #: enqueues (raising refuses it): the engine's drain/close check
        self._admission_check = admission_check
        self.prompt_ladder = prompt_ladder.copy() \
            if prompt_ladder is not None \
            else BucketLadder(self.max_len, min_size=min(8, self.max_len))
        if self.prompt_ladder.max > self.max_len:
            raise ValueError(
                f"prompt ladder's largest rung {self.prompt_ladder.max} "
                f"exceeds the cache max_len {self.max_len}")
        self.batch_ladder = BucketLadder(self.slots)
        self._trash = self.slots
        self._setup_steps()
        self._slots = [None] * self.slots
        self._free = collections.deque(range(self.slots))
        self._pending = collections.deque()
        # popped off the queue but not yet slotted (or failed), so drain()
        # waits for true quiescence
        self._in_flight = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._running = True
        self._dispatcher = threading.Thread(
            target=self._loop, name="bigdl-torch-serving-generate",
            daemon=True)
        self._dispatcher.start()

    def _setup_steps(self):
        self._prefill_fn, self._decode_fn = generate_steps(self.model)
        self._reset_pool()

    def _reset_pool(self):
        self._cache = self.model.init_cache(self.slots + 1, self.max_len)

    def cache_bytes(self) -> int:
        """Device bytes the KV cache holds."""
        return int(sum(t.numel() * t.element_size()
                       for layer in self._cache.values()
                       for t in layer.values()))

    # ----- request surface -------------------------------------------------- #
    def submit(self, prompt, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               timeout: Optional[float] = None,
               sampling=None) -> GenerateFuture:
        """Enqueue one prompt (1-D int token ids); returns the streaming
        future.  Blocks while ``queue_capacity`` requests are pending
        (``timeout`` bounds the wait)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the cache max_len "
                f"{self.max_len}; raise decode_max_len or trim the "
                f"request")
        if sampling is not None and not sampling.greedy \
                and not self.supports_sampling:
            raise ValueError(
                "temperature/top-k/top-p sampling needs the paged "
                "scheduler (ServingEngine kv_cache='paged'); the "
                "contiguous pool decodes greedy only")
        fut = GenerateFuture(prompt.size, max_new_tokens, eos_id)
        fut.sampling = sampling
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            if not self._running:
                raise RuntimeError("generation scheduler is closed")
            while self._running and \
                    len(self._pending) >= self.queue_capacity:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise FutureTimeoutError(
                        f"generate submit timed out after {timeout}s: "
                        f"queue full ({self.queue_capacity} pending)")
                self._not_full.wait(timeout=remaining)
            if not self._running:
                raise RuntimeError("generation scheduler is closed")
            if self._admission_check is not None:
                self._admission_check()
            self._pending.append((prompt, fut))
            self._work.notify()
        return fut

    def _active(self):
        return [(i, s) for i, s in enumerate(self._slots) if s is not None]

    # ----- warmup ----------------------------------------------------------- #
    def _dummy_cache(self):
        return {name: {kv: torch.zeros_like(t) for kv, t in layer.items()}
                for name, layer in self._cache.items()}

    def precompile(self) -> int:
        """Warm-up before traffic: builds the kernels (first launch) and
        runs the decode step and every (admission rung x prompt rung)
        prefill once, on a zero copy of the cache so live slots are never
        touched.  Returns the number of steps run."""
        dummy = self._dummy_cache()
        s = self.slots + 1
        self._decode_fn(dummy, np.zeros((s,), np.int32),
                        np.zeros((s,), np.int32))
        runs = 1
        for b in self.batch_ladder:
            for t in self.prompt_ladder:
                self._prefill_fn(dummy, np.zeros((b, t), np.int32),
                                 np.ones((b,), np.int32),
                                 np.full((b,), self._trash, np.int32))
                runs += 1
        return runs

    # ----- dispatcher ------------------------------------------------------- #
    def _loop(self):
        while True:
            with self._lock:
                while self._running and not self._pending \
                        and not self._active():
                    self._idle.notify_all()
                    self._work.wait()
                if not self._running and not self._pending \
                        and not self._active():
                    self._idle.notify_all()
                    return
                admit = []
                if self._pending and self._free:
                    take = min(len(self._free), len(self._pending))
                    admit = [self._pending.popleft() for _ in range(take)]
                    self._in_flight += len(admit)
                    self._not_full.notify_all()
            try:
                # claiming moves PENDING -> RUNNING so result-setting can't
                # race a caller's cancel(); a dropped future still gets the
                # stream sentinel
                claimed = []
                for p, f in admit:
                    if f.set_running_or_notify_cancel():
                        claimed.append((p, f))
                    else:
                        f._stream.put(None)
                self._sweep_abandoned()
                if claimed:
                    self._run_prefill(claimed)
                if self._active():
                    self._run_decode()
            except Exception:
                # per-tick failures are surfaced on the affected futures;
                # this keeps a scheduler bug from killing the dispatcher
                log.exception("generation scheduler tick failed")
            finally:
                with self._lock:
                    self._in_flight -= len(admit)
                    if not self._pending and not self._in_flight \
                            and not self._active():
                        self._idle.notify_all()

    def _run_prefill(self, reqs):
        t0 = time.perf_counter()
        for _p, f in reqs:
            f._t_admit = t0
        n = len(reqs)
        bucket = self.batch_ladder.bucket_for(n) or self.batch_ladder.add(n)
        longest = max(int(p.size) for p, _ in reqs)
        t_pad = self.prompt_ladder.bucket_for(longest) \
            or self.prompt_ladder.add(longest)
        tokens = np.zeros((bucket, t_pad), np.int32)
        lengths = np.ones((bucket,), np.int32)
        slot_ids = np.full((bucket,), self._trash, np.int32)
        slots = []
        with self._lock:
            for i, (p, _f) in enumerate(reqs):
                tokens[i, : p.size] = p
                lengths[i] = p.size
                slot_ids[i] = self._free.popleft()
                slots.append(int(slot_ids[i]))
        try:
            first = self._prefill_fn(self._cache, tokens, lengths, slot_ids)
        except Exception as e:
            log.exception("prefill tick failed (%d prompts)", n)
            self._tick_failed(e, [f for _p, f in reqs], slots)
            return
        for i, (p, f) in enumerate(reqs):
            slot = _Slot(f, int(first[i]), pos=int(p.size))
            self._slots[slots[i]] = slot
            self._deliver(slots[i], slot)

    def _run_decode(self):
        s = self.slots + 1
        tokens = np.zeros((s,), np.int32)
        pos = np.zeros((s,), np.int32)
        active = self._active()
        for i, slot in active:
            tokens[i] = slot.last
            pos[i] = slot.pos
        try:
            nxt = self._decode_fn(self._cache, tokens, pos)
        except Exception as e:
            log.exception("decode tick failed (%d slots)", len(active))
            self._tick_failed(e, [], [])
            return
        for i, slot in active:
            slot.pos += 1
            slot.last = int(nxt[i])
            slot.tokens.append(slot.last)
            self._deliver(i, slot)

    def _tick_failed(self, e, futs, extra_free):
        """A failed tick may have written part of the cache: fail the
        tick's own futures and every active slot, then start from a fresh
        zero cache so NEW prompts keep being served."""
        failed = list(futs)
        for i, slot in self._active():
            failed.append(slot.fut)
            self._release_slot(i, slot)
        with self._lock:
            self._free.extend(extra_free)
        self._reset_pool()
        for f in failed:
            if not f.done():
                f._stream.put(e)
                f._stream.put(None)
                f.set_exception(e)

    def _abandon(self, fut):
        """Give up on a generation nobody will read: still pending ->
        cancel and free its queue entry; already claimed -> evict at the
        next tick boundary (``_sweep_abandoned``)."""
        if not fut.cancel():
            fut._abandoned = True
            return
        fut._stream.put(None)
        with self._lock:
            for entry in self._pending:
                if entry[1] is fut:
                    self._pending.remove(entry)
                    self._not_full.notify()
                    break

    def _sweep_abandoned(self):
        for i, slot in self._active():
            fut = slot.fut
            if not fut._abandoned or fut.done():
                continue
            self._release_slot(i, slot)
            fut.finish_reason = "abandoned"
            self._stamp_latency(fut)
            fut._stream.put(None)
            fut.set_result(list(slot.tokens))

    def _release_slot(self, index, slot):
        self._slots[index] = None
        with self._lock:
            self._free.append(index)

    def _deliver(self, index, slot):
        """Stream the slot's newest token; complete and free the slot on
        EOS or the request's token budget."""
        fut = slot.fut
        tok = slot.tokens[-1]
        if len(slot.tokens) == 1:
            fut.first_token_s = time.perf_counter() - fut._t_submit
        fut._stream.put(tok)
        reason = None
        if fut.eos_id is not None and tok == fut.eos_id:
            reason = "eos"
        elif len(slot.tokens) >= fut.max_new_tokens:
            reason = "length"
        if reason is None:
            return
        self._release_slot(index, slot)
        fut.finish_reason = reason
        self._stamp_latency(fut)
        fut._stream.put(None)
        fut.set_result(list(slot.tokens))

    @staticmethod
    def _stamp_latency(fut):
        now = time.perf_counter()
        fut.latency_s = now - fut._t_submit
        admit = fut._t_admit if fut._t_admit is not None else now
        fut.queue_wait_s = max(0.0, admit - fut._t_submit)
        fut.decode_s = max(0.0, now - admit)

    # ----- lifecycle -------------------------------------------------------- #
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until no generation work is pending or mid-flight; False
        when ``timeout`` passes with sequences still decoding."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            self._work.notify_all()
            while self._pending or self._in_flight or self._active():
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=remaining)
        return True

    def close(self, timeout: Optional[float] = 10.0):
        with self._lock:
            self._running = False
            self._work.notify_all()
            self._not_full.notify_all()
        self._dispatcher.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def paged_generate_steps(model):
    """The step triple for PAGED generation:

    - ``chunk_prefill(pool, tokens (B, Tc), start (B,), lengths (B,),
      tables (B, MB), temperature, top_k, top_p, seed) -> first (B,)``:
      one prompt chunk per row scattered through the tables; row ``i``'s
      token is drawn from its last valid chunk position (meaningful only
      for rows whose chunk completes the prompt).
    - ``decode(pool, tokens (S,), pos (S,), tables (S, MB), temperature,
      top_k, top_p, seed) -> next (S,)``: one step over the slot pool.
    - ``copy_block(pool, src, dst)``: the copy-on-write block copy.

    The draw for the token at position ``p`` is keyed on ``(seed, p)``,
    so a request replays identically however it was chunked or slotted.
    All rows greedy skips the sampler (the result is the same argmax).
    """
    dev = model.device

    def draw(logits, knobs, position):
        temperature, top_k, top_p, seed = knobs
        if not (np.asarray(temperature) > 0).any():
            return torch.argmax(logits, dim=-1)
        return sample_tokens(logits, _tensor(temperature, dev, torch.float32),
                             _tensor(top_k, dev), _tensor(top_p, dev,
                                                          torch.float32),
                             _tensor(seed, dev), position)

    @torch.no_grad()
    def chunk_prefill(pool, tokens, start, lengths, tables, *knobs):
        start_t, len_t = _tensor(start, dev), _tensor(lengths, dev)
        logits, _ = model.apply_paged(_tensor(tokens, dev), pool,
                                      _tensor(tables, dev), pos=start_t,
                                      lengths=len_t)
        row = _last_valid_row(logits, len_t)
        # the drawn token OCCUPIES position start + lengths
        first = draw(row, knobs, start_t + len_t)
        return first.cpu().numpy().astype(np.int32)

    @torch.no_grad()
    def decode(pool, tokens, pos, tables, *knobs):
        pos_t = _tensor(pos, dev)
        logits, _ = model.apply_paged(_tensor(tokens, dev)[:, None], pool,
                                      _tensor(tables, dev), pos=pos_t)
        nxt = draw(logits[:, 0], knobs, pos_t + 1)
        return nxt.cpu().numpy().astype(np.int32)

    @torch.no_grad()
    def copy_block(pool, src, dst):
        for layer in pool.values():
            for t in layer.values():
                t[dst].copy_(t[src])

    return chunk_prefill, decode, copy_block


class _PagedSlot:
    """One admitted sequence in the paged scheduler.  While ``consumed <
    len(prompt)`` it is PREFILLING; the final chunk draws the first token
    and the fields then mean what ``_Slot``'s do."""

    __slots__ = ("fut", "prompt", "seq", "consumed", "tokens", "last",
                 "pos", "seed")

    def __init__(self, fut, prompt, seq, consumed, seed):
        self.fut = fut
        self.prompt = prompt
        self.seq = seq                    # BlockAllocator sequence id
        self.consumed = int(consumed)
        self.tokens = []
        self.last = None
        self.pos = None
        self.seed = int(seed)

    @property
    def prefilling(self):
        return self.consumed < self.prompt.size


class PagedGenerateScheduler(GenerateScheduler):
    """Continuous batching over a PAGED KV cache.  The dispatcher contract
    is ``GenerateScheduler``'s; what changes:

    - K/V live in ``model.init_paged_cache(num_blocks, block_size)``,
      addressed through ``BlockAllocator`` tables; admission reserves the
      request's worst-case block need or sheds it with
      ``BlockPoolExhausted``;
    - prompts whose leading full blocks match an earlier request map the
      shared blocks (``prefix_hit_tokens``) and skip that prefill;
    - prompts prefill ``prefill_chunk`` tokens per dispatcher iteration,
      with a decode tick in between;
    - decode ticks sample per the request's ``SamplingParams``.
    """

    supports_sampling = True

    def __init__(self, model, slots: int = 8, max_len: Optional[int] = None,
                 prompt_ladder: Optional[BucketLadder] = None,
                 queue_capacity: int = 1024, admission_check=None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None):
        if not hasattr(model, "init_paged_cache"):
            raise TypeError(
                f"{type(model).__name__} has no init_paged_cache(): the "
                f"paged scheduler needs the block-pool decode mode")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = int(block_size)
        model_max = getattr(model, "max_len", None)
        eff_max = int(model_max if max_len is None
                      else min(max_len, model_max or max_len))
        #: table width: enough entries to map max_len positions
        self.max_blocks_per_seq = -(-eff_max // self.block_size)
        #: pool size; the default matches the contiguous pool's capacity
        self.num_blocks = int(num_blocks) if num_blocks is not None \
            else int(slots) * self.max_blocks_per_seq
        if prefill_chunk is None:
            prefill_chunk = min(64, eff_max)
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = int(min(prefill_chunk, eff_max))
        self._seq_counter = 0
        super().__init__(model, slots=slots, max_len=max_len,
                         prompt_ladder=prompt_ladder,
                         queue_capacity=queue_capacity,
                         admission_check=admission_check)

    def _setup_steps(self):
        self._chunk_fn, self._decode_fn, self._copy_fn = \
            paged_generate_steps(self.model)
        self._reset_pool()

    def _reset_pool(self):
        self._cache = self.model.init_paged_cache(self.num_blocks,
                                                  self.block_size)
        self._alloc = BlockAllocator(
            self.num_blocks, self.block_size,
            bytes_per_block=self.cache_bytes() // (self.num_blocks + 1))

    @staticmethod
    def _knobs(n):
        return (np.zeros((n,), np.float32), np.zeros((n,), np.int32),
                np.ones((n,), np.float32), np.zeros((n,), np.int32))

    def precompile(self) -> int:
        """Warm-up: the decode step, one chunk prefill per admission rung
        and the block copy, on a zero copy of the pool."""
        dummy = self._dummy_cache()
        s, mb = self.slots, self.max_blocks_per_seq
        trash = self._alloc.trash
        self._decode_fn(dummy, np.zeros((s,), np.int32),
                        np.zeros((s,), np.int32),
                        np.full((s, mb), trash, np.int32), *self._knobs(s))
        runs = 1
        for b in self.batch_ladder:
            self._chunk_fn(dummy, np.zeros((b, self.prefill_chunk), np.int32),
                           np.zeros((b,), np.int32), np.ones((b,), np.int32),
                           np.full((b, mb), trash, np.int32),
                           *self._knobs(b))
            runs += 1
        self._copy_fn(dummy, 0, 0)
        return runs + 1

    # ----- dispatcher ticks -------------------------------------------------- #
    def _release_slot(self, index, slot):
        seq = getattr(slot, "seq", None)
        if seq is not None:
            self._alloc.free_sequence(seq)
        super()._release_slot(index, slot)

    def _run_prefill(self, reqs):
        """ADMISSION only: assign a slot, match the prefix cache, reserve
        the worst-case block need.  The prompt is computed one chunk per
        dispatcher iteration in ``_run_decode``."""
        t0 = time.perf_counter()
        for p, f in reqs:
            f._t_admit = t0
        for p, f in reqs:
            sp = f.sampling
            seed = 0
            if sp is not None and not sp.greedy:
                seed = sp.seed if sp.seed is not None else \
                    int.from_bytes(os.urandom(4), "little") & 0x7fffffff
            seq = self._seq_counter
            self._seq_counter += 1
            with self._lock:
                idx = self._free.popleft()
            try:
                cached = self._alloc.begin_sequence(
                    seq, p.tolist(), int(p.size) + f.max_new_tokens)
            except BlockPoolExhausted as e:
                with self._lock:
                    self._free.append(idx)
                f._stream.put(e)
                f._stream.put(None)
                f.set_exception(e)
                continue
            f.prefix_hit_tokens = cached
            self._slots[idx] = _PagedSlot(f, p, seq, cached, seed)

    @staticmethod
    def _fill_sampling(arrs, r, slot):
        sp = slot.fut.sampling
        if sp is None or sp.greedy:
            return
        temp, top_k, top_p, seed = arrs
        temp[r] = sp.temperature
        top_k[r] = sp.top_k
        top_p[r] = sp.top_p
        seed[r] = slot.seed

    def _run_decode(self):
        """One dispatcher iteration: one chunk for every prefilling
        sequence, then one decode tick over every decoding slot."""
        if any(s.prefilling for _i, s in self._active()):
            self._run_chunk_tick()
        if any(not s.prefilling for _i, s in self._active()):
            self._run_decode_tick()

    def _run_chunk_tick(self):
        rows = [(i, s) for i, s in self._active() if s.prefilling]
        n = len(rows)
        bucket = self.batch_ladder.bucket_for(n) or self.batch_ladder.add(n)
        tc = self.prefill_chunk
        mb = self.max_blocks_per_seq
        tokens = np.zeros((bucket, tc), np.int32)
        start = np.zeros((bucket,), np.int32)
        lens = np.zeros((bucket,), np.int32)
        tables = np.full((bucket, mb), self._alloc.trash, np.int32)
        knobs = self._knobs(bucket)
        for r, (i, s) in enumerate(rows):
            chunk = s.prompt[s.consumed:s.consumed + tc]
            tokens[r, :chunk.size] = chunk
            start[r] = s.consumed
            lens[r] = chunk.size
            self._cow_guard(s, s.consumed, s.consumed + chunk.size - 1)
            tables[r] = self._alloc.table_row(s.seq, mb)
            self._fill_sampling(knobs, r, s)
        try:
            first = self._chunk_fn(self._cache, tokens, start, lens, tables,
                                   *knobs)
        except Exception as e:
            log.exception("chunk prefill tick failed (%d prompts)", n)
            self._tick_failed(e, [], [])
            return
        for r, (i, s) in enumerate(rows):
            s.consumed += int(lens[r])
            # full prompt blocks now hold real K/V: register their hashes
            self._alloc.commit_full_blocks(s.seq, s.consumed)
            if not s.prefilling:                     # prompt complete
                s.last = int(first[r])
                s.tokens = [s.last]
                s.pos = int(s.prompt.size)
                self._deliver(i, s)

    def _run_decode_tick(self):
        s_n = self.slots
        mb = self.max_blocks_per_seq
        tokens = np.zeros((s_n,), np.int32)
        pos = np.zeros((s_n,), np.int32)
        tables = np.full((s_n, mb), self._alloc.trash, np.int32)
        knobs = self._knobs(s_n)
        active = [(i, s) for i, s in self._active() if not s.prefilling]
        for i, s in active:
            self._cow_guard(s, s.pos, s.pos)
            tokens[i] = s.last
            pos[i] = s.pos
            tables[i] = self._alloc.table_row(s.seq, mb)
            self._fill_sampling(knobs, i, s)
        try:
            nxt = self._decode_fn(self._cache, tokens, pos, tables, *knobs)
        except Exception as e:
            log.exception("decode tick failed (%d slots)", len(active))
            self._tick_failed(e, [], [])
            return
        for i, s in active:
            s.pos += 1
            s.last = int(nxt[i])
            s.tokens.append(s.last)
            self._deliver(i, s)

    def _cow_guard(self, slot, first_pos, last_pos):
        """Copy-on-write over the blocks a write will touch: a shared
        block is first copied into a private one."""
        bs = self.block_size
        for b in range(int(first_pos) // bs, int(last_pos) // bs + 1):
            cow = self._alloc.ensure_writable(slot.seq, b * bs)
            if cow is not None:
                src, dst = cow
                self._copy_fn(self._cache, src, dst)
