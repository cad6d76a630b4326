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
  contract over a paged block pool (``serving/paging.py``), fp32 or int8
  (``cache_dtype``): prefix sharing, chunked prefill interleaved with
  decode, and sampling (``serving/sampling.py``).
- ``speculative_verify_step(model)`` / ``SpeculativeScheduler`` -- draft
  with the int8 twin, verify ``k + 1`` tokens in one fp32 forward.
- ``GenerateFuture`` -- the streaming per-request handle.

The JAX steps are jitted per shape and donate the cache.  These take and
return device tensors and write the cache in place; each scheduler builds
them once per shape key in ``precompile()`` (on the card as CUDA graphs,
``serving/graphs.py``), so a tick is one host-to-device copy of its
inputs, one replay (``spec_k + 2`` for a speculative round) and one
device-to-host copy of its tokens.  The attention inside them goes
through the CUDA kernels on the card (``ops/flash_attention``).
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
from bigdl_tpu_torch.serving.graphs import StepGraphs
from bigdl_tpu_torch.serving.paging import BlockAllocator, BlockPoolExhausted
from bigdl_tpu_torch.serving.sampling import sample_tokens

log = logging.getLogger("bigdl_tpu_torch.serving")


#: the paged pool's storage dtypes and their short names
_KV_DTYPES = {torch.float32: "fp32", torch.int8: "int8"}


_I32, _F32 = np.int32, np.float32


def _zero_(pool):
    """Zero every leaf of a per-layer pool or cache IN PLACE: the built
    steps hold its tensors' addresses, so it is never reallocated."""
    for layer in pool.values():
        for t in layer.values():
            t.zero_()


def _tree_bytes(pool):
    """Device bytes of every leaf of a per-layer pool or cache."""
    return int(sum(t.numel() * t.element_size()
                   for layer in pool.values() for t in layer.values()))


def _last_valid_row(logits, lengths):
    """Each row's logits at its last real position ``lengths - 1``."""
    n, t = logits.shape[:2]
    idx = (lengths.long() - 1).clamp(0, t - 1)
    return logits[torch.arange(n, device=logits.device), idx]


def _argmax(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def generate_steps(model):
    """The ``(prefill, decode)`` pair over a contiguous slot cache.  Both
    take int32 device tensors, write the cache in place and return the
    drawn tokens (int32) and the logits they were drawn from.

    - ``prefill(slot_cache, tokens (B, T), lengths (B,), slot_ids (B,))
      -> (first (B,), logits (B, V))``: runs the cached forward over the
      padded prompt batch, copies its K/V into the slot rows
      ``slot_ids`` (padding rows name the trash row) and reads each
      row's first token at its true ``length - 1``.
    - ``decode(slot_cache, tokens (S,), pos (S,)) -> (next (S,), logits
      (S, V))``: one step over the whole pool.
    """

    @torch.no_grad()
    def prefill(slot_cache, tokens, lengths, slot_ids):
        n, t = tokens.shape
        local = model.init_cache(n, t)
        logits, frag = model(tokens, cache=local)
        row = _last_valid_row(logits, lengths)
        sid = slot_ids.long()
        for name, layer in slot_cache.items():
            for kv in ("k", "v"):
                # the batch axis sits at ndim - 4: the scanned layout's
                # leaves have a leading layer axis
                rows = (slice(None),) * (layer[kv].dim() - 4)
                layer[kv][(*rows, sid, slice(0, t))] = frag[name][kv]
        return _argmax(row), row

    @torch.no_grad()
    def decode(slot_cache, tokens, pos):
        logits, _ = model(tokens[:, None], cache=slot_cache, pos=pos)
        return _argmax(logits[:, 0]), logits[:, 0]

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
    their slot at once; the next prefill reuses it.  Greedy only.

    Its steps are built once per shape (``serving/graphs.py``): the
    decode step over ``slots + 1`` rows and one prefill per (admission
    rung x prompt rung), all in ``precompile()``; a shape outside the
    ladders is built by the tick that needs it.  Steps are built and run
    under ``_step_lock``, on the dispatcher thread or in
    ``precompile()``."""

    #: the paged scheduler samples; this one refuses non-greedy requests
    supports_sampling = False

    def __init__(self, model, slots: int = 8, max_len: Optional[int] = None,
                 prompt_ladder: Optional[BucketLadder] = None,
                 queue_capacity: int = 1024, admission_check=None,
                 exhausted_hook=None):
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
        #: called with a ``BlockPoolExhausted`` before the shed request
        #: sees it (the engine's memory forensics)
        self._exhausted_hook = exhausted_hook
        self.prompt_ladder = prompt_ladder.copy() \
            if prompt_ladder is not None \
            else BucketLadder(self.max_len, min_size=min(8, self.max_len))
        if self.prompt_ladder.max > self.max_len:
            raise ValueError(
                f"prompt ladder's largest rung {self.prompt_ladder.max} "
                f"exceeds the cache max_len {self.max_len}")
        self.batch_ladder = BucketLadder(self.slots)
        self._trash = self.slots
        self._step_lock = threading.Lock()
        self._setup_steps()
        self._slots = [None] * self.slots
        self._free = collections.deque(range(self.slots))
        self._pending = collections.deque()
        # popped off the queue but not yet slotted (or failed), so drain()
        # waits for true quiescence
        self._in_flight = 0
        self._tick = 0
        self._served = 0
        self._tokens_out = 0
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
        self._graphs = StepGraphs(self.model.device)
        self._cache = self.model.init_cache(self.slots + 1, self.max_len)

    def _reset_pool(self):
        _zero_(self._cache)

    def cache_bytes(self) -> int:
        """Device bytes the KV cache holds."""
        return _tree_bytes(self._cache)

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

    def stats(self):
        with self._lock:
            return {"pending": len(self._pending),
                    "in_flight": self._in_flight,
                    "slots": self.slots, "slots_active": len(self._active()),
                    "ticks": self._tick, "served": self._served,
                    "tokens": self._tokens_out,
                    "running": self._running,
                    "graphs": self._graphs.stats()}

    # ----- the built steps ------------------------------------------------- #
    def _prefill_step(self, b, t):
        """The key and static inputs of the prefill at ``(b, t)``, built
        at first use.  Idle rows name the trash row."""
        key = ("prefill", b, t)
        inp = self._graphs.inputs(key, [("tokens", (b, t), _I32),
                                        ("lengths", (b,), _I32),
                                        ("slot_ids", (b,), _I32)])
        self._graphs.ensure(
            key, lambda: self._prefill_fn(self._cache, **inp.dev),
            inp, dict(tokens=0, lengths=1, slot_ids=self._trash))
        return key, inp

    def _decode_step(self):
        """The decode step over every slot and the trash row.  Idle, each
        row writes position ``max_len - 1``, which no sequence writes or
        reads: a request's ``prompt + max_new_tokens <= max_len``, and
        its last token is never fed back."""
        s = self.slots + 1
        key = ("decode", s)
        inp = self._graphs.inputs(key, [("tokens", (s,), _I32),
                                        ("pos", (s,), _I32)])
        self._graphs.ensure(
            key, lambda: self._decode_fn(self._cache, **inp.dev),
            inp, dict(tokens=0, pos=self.max_len - 1))
        return key, inp

    def _run_step(self, key, inp, **values):
        """One tick's device work: the inputs copied up, the step run,
        its tokens copied down."""
        inp.set(**values)
        inp.upload()
        return self._graphs.run(key)[0].cpu().numpy()

    # ----- warmup ----------------------------------------------------------- #
    def precompile(self) -> int:
        """Build every step before traffic, on the live cache through the
        trash row: the decode step and every (admission rung x prompt
        rung) prefill.  Returns the number of steps built (on the card,
        CUDA graphs captured): JAX's "backend compiles performed"."""
        with self._step_lock, self._graphs.precompiling():
            before = self._graphs.captured
            self._decode_step()
            for b in self.batch_ladder:
                for t in self.prompt_ladder:
                    self._prefill_step(b, t)
            return self._graphs.captured - before

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
            with self._step_lock:
                self._iteration()

    def _iteration(self):
        """One dispatcher iteration: admit what is pending into free
        slots, then the ticks (under ``_step_lock``)."""
        with self._lock:
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
            key, inp = self._prefill_step(bucket, t_pad)
            first = self._run_step(key, inp, tokens=tokens, lengths=lengths,
                                   slot_ids=slot_ids)
        except Exception as e:
            log.exception("prefill tick failed (%d prompts)", n)
            self._tick_failed(e, [f for _p, f in reqs], slots)
            return
        self._tick += 1
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
            key, inp = self._decode_step()
            nxt = self._run_step(key, inp, tokens=tokens, pos=pos)
        except Exception as e:
            log.exception("decode tick failed (%d slots)", len(active))
            self._tick_failed(e, [], [])
            return
        self._tick += 1
        for i, slot in active:
            slot.pos += 1
            slot.last = int(nxt[i])
            slot.tokens.append(slot.last)
            self._deliver(i, slot)

    def _tick_failed(self, e, futs, extra_free):
        """A failed tick (or a failed build of its step) may have written
        part of the cache: fail the tick's own futures and every active
        slot, then zero the cache so NEW prompts keep being served."""
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
        self._tokens_out += 1
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
        self._served += 1
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


def _draw(logits, knobs, position, sample):
    """Tokens from ``logits`` per the rows' sampling knobs ``(temperature,
    top_k, top_p, seed)``, the draw for a token at ``position`` keyed on
    ``(seed, position)``.  ``sample`` is part of the step's shape key:
    when every row is greedy the step skips the sampler (the result is
    the same argmax) and its vocabulary-wide sort."""
    if not sample:
        return _argmax(logits)
    return sample_tokens(logits, *knobs, position)


#: the sampling knobs of a paged step: name and dtype, one per row
_KNOBS = (("temperature", _F32), ("top_k", _I32), ("top_p", _F32),
          ("seed", _I32))
#: their values on a greedy row
_GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, seed=0)


def paged_generate_steps(model):
    """The step triple for PAGED generation; the first two take int32
    (knobs: fp32 temperature and top_p) device tensors, write the pool in
    place and return the drawn tokens (int32) and the logits they were
    drawn from:

    - ``chunk_prefill(pool, tokens (B, Tc), start (B,), lengths (B,),
      tables (B, MB), temperature, top_k, top_p, seed, sample=...) ->
      (first (B,), logits (B, V))``: one prompt chunk per row scattered
      through the tables; row ``i``'s token is drawn from its last valid
      chunk position (meaningful only for rows whose chunk completes the
      prompt).
    - ``decode(pool, tokens (S,), pos (S,), tables (S, MB), temperature,
      top_k, top_p, seed, sample=...) -> (next (S,), logits (S, V))``:
      one step over the slot pool.
    - ``copy_block(pool, src, dst)``: the copy-on-write block copy, over
      every leaf of the pool (an int8 pool's scales included), with
      Python int block ids.

    The pool carries its own layout (fp32, or int8 payloads plus
    scales), so one triple serves both.  The draw for the token at
    position ``p`` is keyed on ``(seed, p)``, so a request replays
    identically however it was chunked or slotted.
    """

    @torch.no_grad()
    def chunk_prefill(pool, tokens, start, lengths, tables, temperature,
                      top_k, top_p, seed, sample):
        logits, _ = model.apply_paged(tokens, pool, tables, pos=start,
                                      lengths=lengths)
        row = _last_valid_row(logits, lengths)
        # the drawn token OCCUPIES position start + lengths
        return _draw(row, (temperature, top_k, top_p, seed),
                     start + lengths, sample), row

    @torch.no_grad()
    def decode(pool, tokens, pos, tables, temperature, top_k, top_p, seed,
               sample):
        logits, _ = model.apply_paged(tokens[:, None], pool, tables,
                                      pos=pos)
        row = logits[:, 0]
        return _draw(row, (temperature, top_k, top_p, seed), pos + 1,
                     sample), row

    @torch.no_grad()
    def copy_block(pool, src, dst):
        for layer in pool.values():
            for t in layer.values():
                # the block axis sits at ndim - 4 (a leading layer axis
                # in the scanned layout)
                lead = (slice(None),) * (t.dim() - 4)
                t[(*lead, dst)].copy_(t[(*lead, src)])

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
    - decode ticks sample per the request's ``SamplingParams``;
    - ``cache_dtype=torch.int8`` stores the pool as int8 payloads plus
      one fp32 scale per (position, head) vector, decoded through K3q;
      the allocator namespaces its prefix hashes by the pool's dtype and
      reports the bytes measured from the pool's tensors;
    - the built steps are the decode step and one chunk prefill per
      admission rung, each greedy and sampled; the copy-on-write block
      copy runs eagerly (rare, and its block ids are Python ints).
    """

    supports_sampling = True

    def __init__(self, model, slots: int = 8, max_len: Optional[int] = None,
                 prompt_ladder: Optional[BucketLadder] = None,
                 queue_capacity: int = 1024, admission_check=None,
                 exhausted_hook=None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 cache_dtype=torch.float32):
        if cache_dtype not in _KV_DTYPES:
            raise ValueError(f"cache_dtype must be one of "
                             f"{list(_KV_DTYPES)}, got {cache_dtype}")
        self._cache_dtype = cache_dtype
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
                         admission_check=admission_check,
                         exhausted_hook=exhausted_hook)

    def _setup_steps(self):
        self._chunk_fn, self._decode_fn, self._copy_fn = \
            paged_generate_steps(self.model)
        self._graphs = StepGraphs(self.model.device)
        self._cache = self.model.init_paged_cache(
            self.num_blocks, self.block_size, self._cache_dtype)
        self._alloc = self._make_alloc()

    def _reset_pool(self):
        # a failed tick may have written part of the pool: every cached
        # prefix block's content goes with it (fresh allocator)
        _zero_(self._cache)
        self._alloc = self._make_alloc()

    def kv_dtype(self) -> str:
        """Short name of the pool's storage dtype ("fp32" / "int8"), the
        spelling ``BlockAllocator`` namespaces prefix hashes with."""
        return _KV_DTYPES[self._cache_dtype]

    def _make_alloc(self):
        """The allocator for the pool: it learns the pool's storage dtype
        (prefix hashes never cross formats) and the device bytes behind
        one addressable block, measured from every leaf of the pool,
        scales included."""
        return BlockAllocator(
            self.num_blocks, self.block_size, kv_dtype=self.kv_dtype(),
            bytes_per_block=_tree_bytes(self._cache)
            // (self.num_blocks + 1))

    def flush_prefix_cache(self):
        """Forget every cached prefix block (a weight swap calls this:
        K/V computed under the old weights must not serve new prompts;
        live sequences keep their blocks)."""
        self._alloc.flush_cached()

    def stats(self):
        st = super().stats()
        st["kv"] = self._alloc.stats()
        st["block_size"] = self.block_size
        st["prefill_chunk"] = self.prefill_chunk
        return st

    # ----- the built steps ------------------------------------------------- #
    def _paged_inputs(self, key, rows, *fields):
        """Static inputs of ``rows`` table rows: ``fields`` (name, shape)
        int32, the tables and the sampling knobs."""
        mb = self.max_blocks_per_seq
        return self._graphs.inputs(key, [
            *((name, shape, _I32) for name, shape in fields),
            ("tables", (rows, mb), _I32),
            *((name, (rows,), dt) for name, dt in _KNOBS)])

    def _idle_inputs(self, **values):
        """Idle inputs: every table entry the trash block, greedy knobs."""
        return dict(values, tables=self._alloc.trash, **_GREEDY)

    def _chunk_step(self, b, sample):
        """The chunk prefill of ``b`` rows, built at first use."""
        tc = self.prefill_chunk
        inp = self._paged_inputs(("chunk", b, tc), b, ("tokens", (b, tc)),
                                 ("start", (b,)), ("lengths", (b,)))
        key = ("chunk", b, tc, "sampled" if sample else "greedy")
        self._graphs.ensure(key, self._chunk_graph_fn(inp, sample), inp,
                            self._idle_inputs(tokens=0, start=0, lengths=1))
        return key, inp

    def _chunk_graph_fn(self, inp, sample):
        """What the chunk step runs (the speculative scheduler adds its
        drafter's chunk)."""
        return lambda: self._chunk_fn(self._cache, **inp.dev, sample=sample)

    def _decode_step(self, sample):
        s = self.slots
        inp = self._paged_inputs(("decode", s), s, ("tokens", (s,)),
                                 ("pos", (s,)))
        key = ("decode", s, "sampled" if sample else "greedy")
        self._graphs.ensure(
            key, lambda: self._decode_fn(self._cache, **inp.dev,
                                         sample=sample),
            inp, self._idle_inputs(tokens=0, pos=0))
        return key, inp

    def precompile(self) -> int:
        """Build every step before traffic, on the live pool with every
        row on the trash block: the decode step and one chunk prefill
        per admission rung, each greedy and sampled.  Returns the number
        of steps built (on the card, CUDA graphs captured)."""
        with self._step_lock, self._graphs.precompiling():
            before = self._graphs.captured
            self._precompile_steps()
            return self._graphs.captured - before

    def _precompile_steps(self):
        for sample in (False, True):
            self._decode_step(sample)
            for b in self.batch_ladder:
                self._chunk_step(b, sample)

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
                hook = self._exhausted_hook
                if hook is not None:
                    # the forensics before the caller sees the failure
                    try:
                        hook(e)
                    except Exception:
                        log.exception("exhausted_hook failed")
                f._stream.put(e)
                f._stream.put(None)
                f.set_exception(e)
                continue
            f.prefix_hit_tokens = cached
            self._slots[idx] = _PagedSlot(f, p, seq, cached, seed)

    def _rows(self, n):
        """Host arrays of one step's tables and knobs, every row idle."""
        rows = {"tables": np.full((n, self.max_blocks_per_seq),
                                  self._alloc.trash, np.int32)}
        for name, dt in _KNOBS:
            rows[name] = np.full((n,), _GREEDY[name], dt)
        return rows

    def _fill_row(self, rows, r, slot):
        """Row ``r`` of ``rows``: the slot's table and sampling knobs."""
        rows["tables"][r] = self._alloc.table_row(slot.seq,
                                                  self.max_blocks_per_seq)
        sp = slot.fut.sampling
        if sp is None or sp.greedy:
            return
        rows["temperature"][r] = sp.temperature
        rows["top_k"][r] = sp.top_k
        rows["top_p"][r] = sp.top_p
        rows["seed"][r] = slot.seed

    @staticmethod
    def _sampled(rows):
        return bool((rows["temperature"] > 0).any())

    def _run_decode(self):
        """One dispatcher iteration: one chunk for every prefilling
        sequence, then one decode tick over every decoding slot."""
        if any(s.prefilling for _i, s in self._active()):
            self._run_chunk_tick()
        if any(not s.prefilling for _i, s in self._active()):
            self._run_decode_tick()

    def _run_chunk_tick(self):
        active = [(i, s) for i, s in self._active() if s.prefilling]
        n = len(active)
        bucket = self.batch_ladder.bucket_for(n) or self.batch_ladder.add(n)
        tc = self.prefill_chunk
        rows = self._rows(bucket)
        tokens = np.zeros((bucket, tc), np.int32)
        start = np.zeros((bucket,), np.int32)
        lens = np.zeros((bucket,), np.int32)
        for r, (i, s) in enumerate(active):
            chunk = s.prompt[s.consumed:s.consumed + tc]
            tokens[r, :chunk.size] = chunk
            start[r] = s.consumed
            lens[r] = chunk.size
            self._cow_guard(s, s.consumed, s.consumed + chunk.size - 1)
            self._fill_row(rows, r, s)
        try:
            key, inp = self._chunk_step(bucket, self._sampled(rows))
            first = self._run_step(key, inp, tokens=tokens, start=start,
                                   lengths=lens, **rows)
        except Exception as e:
            log.exception("chunk prefill tick failed (%d prompts)", n)
            self._tick_failed(e, [], [])
            return
        self._tick += 1
        for r, (i, s) in enumerate(active):
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
        rows = self._rows(s_n)
        tokens = np.zeros((s_n,), np.int32)
        pos = np.zeros((s_n,), np.int32)
        active = [(i, s) for i, s in self._active() if not s.prefilling]
        for i, s in active:
            self._cow_guard(s, s.pos, s.pos)
            tokens[i] = s.last
            pos[i] = s.pos
            self._fill_row(rows, i, s)
        try:
            key, inp = self._decode_step(self._sampled(rows))
            nxt = self._run_step(key, inp, tokens=tokens, pos=pos, **rows)
        except Exception as e:
            log.exception("decode tick failed (%d slots)", len(active))
            self._tick_failed(e, [], [])
            return
        self._tick += 1
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
                self._copy_cow_block(src, dst)

    def _copy_cow_block(self, src, dst):
        """Copy physical block ``src`` into ``dst`` (the speculative
        scheduler also copies its drafter's pool: the shared allocator's
        table move covers both)."""
        self._copy_fn(self._cache, src, dst)


def speculative_verify_step(model):
    """The VERIFY step of speculative decoding (counterpart of
    ``speculative_verify_step``, JAX ``serving/generation.py:1263``).

    ``verify(pool, last (S,), drafts (k, S), pos (S,), tables (S, MB),
    temperature, top_k, top_p, seed, sample=...) -> (sampled (S, k + 1),
    logits (S, k + 1, V))``, device tensors in and out: row ``i`` feeds
    ``[last, d_1 .. d_k]``, assembled on the device as JAX does in-jit,
    at positions ``pos .. pos + k`` through the chunk-prefill path (every
    position's K/V written, every position's logits returned) and draws
    a token at EVERY position ``pos + 1 .. pos + k + 1`` with the
    ``(seed, position)`` sampler of plain decode.  Column ``j`` is
    therefore the token one decode step would have drawn at ``pos + j +
    1`` after the fed prefix.
    """

    @torch.no_grad()
    def verify(pool, last, drafts, pos, tables, temperature, top_k, top_p,
               seed, sample):
        tokens = torch.cat([last[:, None], drafts.t()], dim=1)
        k1 = tokens.shape[1]
        logits, _ = model.apply_paged(tokens, pool, tables, pos=pos,
                                      lengths=torch.full_like(pos, k1))
        positions = pos[:, None] + 1 + torch.arange(
            k1, dtype=torch.int32, device=pos.device)[None, :]
        knobs = [a.repeat_interleave(k1)
                 for a in (temperature, top_k, top_p, seed)]
        sampled = _draw(logits.reshape(-1, logits.shape[-1]), knobs,
                        positions.reshape(-1), sample)
        return sampled.reshape(tokens.shape), logits

    return verify


class SpeculativeScheduler(PagedGenerateScheduler):
    """Draft/verify decoding over the paged pool (counterpart of
    ``SpeculativeScheduler``, JAX ``serving/generation.py:1317``): per
    round the int8 twin drafts ``spec_k`` tokens with sequential decode
    steps and the fp32 verifier scores all of them in one chunk-shaped
    forward.  The longest prefix of drafts equal to what the verifier
    itself draws is accepted, plus the verifier's own next token, so one
    round emits 1 to ``spec_k + 1`` tokens and the stream is the
    verifier-only stream (greedy, and seeded sampling through the
    ``(seed, position)`` draw).

    The drafter runs on its OWN pool, of the verifier's dtype, but both
    pools share ONE ``BlockAllocator``: prefix hits, copy-on-write
    detaches and evictions stay single-sourced (a copy-on-write copies
    the block in both pools; every prompt chunk step also runs the chunk
    through the drafter's pool).  A rejected draft's K/V lies beyond the
    committed frontier, masked until the next round overwrites it, and
    the copy-on-write guard runs over the whole ``pos .. pos + k`` span
    first.  Table rows carry ``ceil((spec_k + 1) / block_size)`` extra
    trash entries, so a round that overshoots a finishing sequence's
    reserved blocks writes into the trash block.

    A round is ``spec_k + 2`` built steps on one set of static inputs:
    draft ``j`` (``0 .. spec_k``) feeds ``last`` or draft ``j - 1`` at
    ``pos + j``, all on the device, and writes its token into a static
    ``(spec_k + 1, S)`` buffer; the verify reads the drafts from it and
    returns them beside its own tokens in one ``(S, 2 spec_k + 1)``
    tensor, the round's one device-to-host copy.
    """

    def __init__(self, model, draft_model, spec_k: int = 4, **kw):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if not hasattr(draft_model, "init_paged_cache"):
            raise TypeError(
                f"{type(draft_model).__name__} has no init_paged_cache():"
                f" the drafter must run the verifier's paged decode mode")
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        super().__init__(model, **kw)
        # no request can arrive before the constructor returns, so the
        # dispatcher never sees the narrower rows
        self.max_blocks_per_seq += -(-(self.spec_k + 1) // self.block_size)
        self._drafts = torch.zeros((self.spec_k + 1, self.slots),
                                   dtype=torch.int32,
                                   device=self.model.device)

    def _setup_steps(self):
        super()._setup_steps()
        self._dchunk_fn, self._ddecode_fn, self._dcopy_fn = \
            paged_generate_steps(self.draft_model)
        self._verify_fn = speculative_verify_step(self.model)
        self._dcache = self.draft_model.init_paged_cache(
            self.num_blocks, self.block_size, self._cache_dtype)
        self._alloc.bytes_per_block += self._draft_block_bytes()

    def _draft_block_bytes(self):
        """One addressable block is backed by both pools."""
        return _tree_bytes(self._dcache) // (self.num_blocks + 1)

    def _reset_pool(self):
        super()._reset_pool()
        _zero_(self._dcache)
        self._alloc.bytes_per_block += self._draft_block_bytes()

    def cache_bytes(self) -> int:
        """Verifier pool + drafter pool."""
        return super().cache_bytes() + _tree_bytes(self._dcache)

    def stats(self):
        st = super().stats()
        drafted = self._spec_drafted
        st["speculative"] = {
            "k": self.spec_k, "rounds": self._spec_rounds,
            "drafted": drafted, "accepted": self._spec_accepted,
            "acceptance_rate": (self._spec_accepted / drafted)
            if drafted else None}
        return st

    def _chunk_graph_fn(self, inp, sample):
        """The verifier's prompt chunk, then the same chunk through the
        drafter's pool (same tables: the allocator is shared), so the
        drafter holds its own K/V for every prompt position once the
        sequence decodes."""
        def fn():
            out = self._chunk_fn(self._cache, **inp.dev, sample=sample)
            self._dchunk_fn(self._dcache, **inp.dev, sample=sample)
            return out
        return fn

    def _copy_cow_block(self, src, dst):
        super()._copy_cow_block(src, dst)
        self._dcopy_fn(self._dcache, src, dst)

    def _decode_step(self, sample):
        """The keys of one round's ``spec_k + 2`` steps and their shared
        static inputs, built at first use (the round takes the place of
        the decode step)."""
        s = self.slots
        inp = self._paged_inputs(("round", s), s, ("last", (s,)),
                                 ("pos", (s,)))
        variant = "sampled" if sample else "greedy"
        idle = self._idle_inputs(last=0, pos=0)
        dev = inp.dev
        knobs = {name: dev[name] for name, _ in _KNOBS}
        keys = []
        for j in range(self.spec_k + 1):
            def draft(j=j):
                fed = dev["last"] if j == 0 else self._drafts[j - 1]
                tok, logits = self._ddecode_fn(
                    self._dcache, fed, dev["pos"] + j, dev["tables"],
                    **knobs, sample=sample)
                self._drafts[j].copy_(tok)
                return self._drafts[j], logits

            keys.append(("draft", s, j, variant))
            self._graphs.ensure(keys[-1], draft, inp, idle)

        def verify():
            drafts = self._drafts[:self.spec_k]
            tok, logits = self._verify_fn(
                self._cache, dev["last"], drafts, dev["pos"], dev["tables"],
                **knobs, sample=sample)
            return torch.cat([drafts.t(), tok], dim=1), logits

        keys.append(("verify", s, variant))
        self._graphs.ensure(keys[-1], verify, inp, idle)
        return keys, inp

    def _run_decode_tick(self):
        """One draft/verify round over every decoding slot:

        1. ``spec_k + 1`` drafter decode steps: the first ``spec_k`` give
           the drafts ``d_1 .. d_k`` (each fed back in), the last only
           writes ``d_k``'s K/V, so the drafter's pool covers the same
           ``pos .. pos + k`` span the verifier writes;
        2. one fp32 verify over ``[last, d_1 .. d_k]``;
        3. the longest matching draft prefix plus the verifier's next
           token are streamed (EOS or the token budget cut the run)."""
        s_n = self.slots
        k = self.spec_k
        rows = self._rows(s_n)
        tokens = np.zeros((s_n,), np.int32)
        pos = np.zeros((s_n,), np.int32)
        active = [(i, s) for i, s in self._active() if not s.prefilling]
        for i, s in active:
            # the whole write span, clamped to the sequence's reserved
            # range (overshoot goes to the trash entries of the row)
            hi = min(s.pos + k,
                     int(s.prompt.size) + s.fut.max_new_tokens - 1)
            self._cow_guard(s, s.pos, max(s.pos, hi))
            tokens[i] = s.last
            pos[i] = s.pos
            self._fill_row(rows, i, s)
        try:
            keys, inp = self._decode_step(self._sampled(rows))
            inp.set(last=tokens, pos=pos, **rows)
            inp.upload()
            for key in keys[:-1]:
                self._graphs.run(key)
            out = self._graphs.run(keys[-1])[0].cpu().numpy()
        except Exception as e:
            log.exception("speculative tick failed (%d slots)", len(active))
            self._tick_failed(e, [], [])
            return
        self._tick += 1
        dtoks, vtoks = out[:, :k], out[:, k:]
        drafted = accepted = 0
        for i, s in active:
            drafted += k
            a = 0
            while a < k and int(dtoks[i, a]) == int(vtoks[i, a]):
                a += 1
            accepted += a
            # vtoks[i, :a] are the accepted drafts, vtoks[i, a] the
            # verifier's own next token (correction or bonus)
            for j in range(a + 1):
                s.pos += 1
                s.last = int(vtoks[i, j])
                s.tokens.append(s.last)
                self._deliver(i, s)
                if s.fut.done():
                    break
        self._spec_rounds += 1
        self._spec_drafted += drafted
        self._spec_accepted += accepted
