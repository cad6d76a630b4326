"""Dynamic-batched inference serving over one model (counterpart of
``bigdl_tpu/serving/engine.py`` ``ServingEngine`` :285 with its
``_LocalEval`` backend :80).

``predict`` / ``submit`` coalesce concurrent requests: a dispatcher
thread drains a bounded queue under a ``max_batch_size`` /
``max_wait_ms`` deadline, pads the batch to a rung of a bucket ladder
and runs one forward.  ``generate`` hands prompts to the continuous-
batching decode scheduler (``serving/generation.py``), paged by default.

Int8: ``quantize=True`` serves the model's int8 twin
(``nn.quantized.quantize_model``), ``kv_cache_dtype="int8"`` stores the
paged pool as int8 blocks decoded through K3q, and ``speculative=k``
drafts ``k`` tokens a round with the twin and verifies them with the fp32
model in one forward.  ``accuracy_gate`` holds the twin against the fp32
model on a held-out batch before the engine serves.

The model's attention runs through the hand-written CUDA kernels on the
card.  The JAX reference computes in full fp32, and so does the engine
unless ``compute_dtype`` asks for bf16 ``predict``: building it on a
CUDA device switches TF32 matrix products off
(``utils.device.require_fp32_matmul``).
"""

import collections
import logging
import threading
import time
from concurrent.futures import Future, TimeoutError as FutureTimeoutError
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.quantized import model_bytes, quantize_model
from bigdl_tpu_torch.optim.train_step import compute_copy, make_eval_step
from bigdl_tpu_torch.optim.validation import AccuracyDeltaGate
from bigdl_tpu_torch.serving.buckets import (BucketLadder, ladder_or_default,
                                             pad_batch_axis)
from bigdl_tpu_torch.utils.device import resolve_device, same_device

log = logging.getLogger("bigdl_tpu_torch.serving")


class EngineDraining(RuntimeError):
    """``submit()`` refused because the engine is draining: admission is
    closed while the dispatcher finishes what it already accepted."""


class ServeFuture(Future):
    """Per-request handle: ``result(timeout)`` plus, once served, the
    ``bucket`` the request rode in and its end-to-end ``latency_s``."""

    def __init__(self):
        super().__init__()
        self.bucket: Optional[int] = None
        self.latency_s: Optional[float] = None
        self._t_submit = time.perf_counter()


class _LocalEval:
    """Single-device layout: the model's own placement, evaluated in
    ``compute_dtype`` and returned in fp32 (``make_eval_step``).  In a
    compute dtype the dispatcher evaluates a copy of the model cast at
    construction (``compute_copy``), as the int8 twin is quantized then:
    the generation scheduler's thread keeps reading ``model``."""

    def __init__(self, model, compute_dtype=None):
        self.model = model
        self.device = next(model.parameters()).device
        if compute_dtype is not None:
            model = compute_copy(model, compute_dtype)
        self.step = make_eval_step(model, compute_dtype)

    def eval(self, x):
        tokens = torch.as_tensor(x, device=self.device)
        return self.step(tokens).cpu().numpy()

    def precompile(self, sample, buckets):
        for b in buckets:
            self.eval(pad_batch_axis(np.asarray(sample)[None], int(b)))


class ServingEngine:
    """Coalescing, bucketed inference server for one model.

    >>> eng = ServingEngine(model, max_batch_size=32, max_wait_ms=2.0)
    >>> y = eng.predict(tokens)             # blocking, (T, vocab) logits
    >>> fut = eng.generate(prompt, max_new_tokens=32)
    >>> fut.result()                        # generated token ids

    A tick dispatches when ``max_batch_size`` requests are pending or the
    oldest has waited ``max_wait_ms``; a full queue back-pressures
    ``submit``.  A tick that raises fails only its own requests.

    Generation: ``decode_slots`` (default 8) sequences decode together
    over a KV cache of ``decode_max_len`` positions per sequence,
    ``kv_cache="paged"`` (block pool of ``kv_block_size`` positions per
    block, prefix sharing, chunked prefill, sampling) or
    ``"contiguous"`` (greedy only).

    ``device`` (``None`` means the CUDA card) must be where the model
    lies; the CPU serves only when asked for (``device="cpu"``).

    ``quantize=True`` (or a ``select(path, module)`` predicate for the
    quantizer) serves the int8 twin; the fp32 model is not changed.
    ``accuracy_gate`` (an ``AccuracyDeltaGate`` or a dict of its
    arguments) compares the fp32 model with the twin on a held-out batch
    at construction and refuses to serve, with ``ValueError``, when the
    twin diverges beyond its tolerance.  ``kv_cache_dtype="int8"``
    stores the paged pool as int8 payloads plus one fp32 scale per
    (position, head) vector.  ``speculative=k`` drafts ``k`` tokens a
    round with the twin (on its own pool of the same dtype) and verifies
    them with the fp32 model: the stream is the fp32 model's own.  Both
    need ``kv_cache="paged"``.

    ``compute_dtype`` (``torch.bfloat16``) runs ``predict`` and the
    accuracy gate in that dtype on the fp32 weights (cast when the
    engine is built) and returns fp32 logits, as the JAX engine's eval
    step does; generation is not affected (its schedulers take the KV
    cache dtype only).
    """

    def __init__(self, model, max_batch_size: int = 32,
                 max_wait_ms: float = 2.0, queue_capacity: int = 1024,
                 ladder: Optional[BucketLadder] = None,
                 decode_slots: Optional[int] = None,
                 decode_max_len: Optional[int] = None,
                 prompt_ladder: Optional[BucketLadder] = None,
                 kv_cache: str = "paged", kv_block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 quantize=False, accuracy_gate=None,
                 kv_cache_dtype: str = "fp32", speculative: int = 0,
                 compute_dtype=None, device=None):
        device = resolve_device(device)
        model_device = next(model.parameters()).device
        if not same_device(device, model_device):
            raise ValueError(f"ServingEngine on {device} was given a model "
                             f"on {model_device}")
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got "
                             f"{max_batch_size}")
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, got "
                             f"{queue_capacity}")
        if kv_cache not in ("paged", "contiguous"):
            raise ValueError(f"kv_cache must be 'paged' or 'contiguous', "
                             f"got {kv_cache!r}")
        if speculative < 0:
            raise ValueError(
                f"speculative must be >= 0 (draft tokens per verify "
                f"step; 0 disables), got {speculative}")
        if kv_cache_dtype not in ("fp32", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'fp32' or 'int8', "
                             f"got {kv_cache_dtype!r}")
        if kv_cache_dtype != "fp32" and kv_cache != "paged":
            raise ValueError(
                "int8 KV blocks live in the paged pool (payload and scale "
                "per block); kv_cache_dtype='int8' needs kv_cache='paged'")
        if speculative and kv_cache != "paged":
            raise ValueError(
                "speculative decoding rides the paged block tables (the "
                "drafter's pool shares the verifier's allocator); "
                "speculative=k needs kv_cache='paged'")
        if (kv_cache_dtype != "fp32" or speculative) \
                and not hasattr(model, "init_paged_cache"):
            raise TypeError(
                f"{type(model).__name__} has no init_paged_cache(): int8 "
                f"KV blocks and speculative decoding need the paged "
                f"decode mode (TransformerLM has one)")
        self._quantized = bool(quantize)
        self._qselect = quantize if callable(quantize) else None
        self.speculative = int(speculative)
        if accuracy_gate is not None and not self._quantized \
                and not self.speculative:
            raise ValueError(
                "accuracy_gate compares the fp32 model against its int8 "
                "twin; it needs quantize=... (int8 serving) or "
                "speculative=k (int8 drafter) to have a candidate to gate")
        self._gate = self._make_gate(accuracy_gate)
        self.model = model.eval()
        # the int8 twin SERVES on a quantized engine and DRAFTS on a
        # speculative one (the fp32 model then verifies)
        self._qmodel = quantize_model(model, select=self._qselect)[0] \
            if self._quantized or self.speculative else None
        serve_model = self._qmodel if self._quantized else model
        self._compute_dtype = compute_dtype
        self._backend = _LocalEval(serve_model, compute_dtype)
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.queue_capacity = int(queue_capacity)
        self.ladder = ladder_or_default(ladder, self.max_batch_size)
        if self.ladder.max < self.max_batch_size:
            self.ladder.add(self.max_batch_size)
        if self.ladder.min > self.max_batch_size:
            raise ValueError(
                f"ladder's smallest rung {self.ladder.min} exceeds "
                f"max_batch_size {self.max_batch_size}")
        self._pending = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._running = True
        self._draining = False
        self._in_tick = 0
        self._tick = 0
        self._served = 0
        if decode_slots is None:
            decode_slots = 8 if hasattr(model, "init_cache") else 0
        self.decode_slots = int(decode_slots)
        self.decode_max_len = decode_max_len
        self._prompt_ladder = prompt_ladder
        self.kv_cache = kv_cache
        self.kv_cache_dtype = kv_cache_dtype
        self.kv_block_size = int(kv_block_size)
        self.kv_blocks = kv_blocks
        self.prefill_chunk = prefill_chunk
        self._gen = None
        self._gen_lock = threading.Lock()
        self._gate_detail = None
        if self._gate is not None:
            # the twin must clear the gate before the engine serves at all
            ok, detail = self._gate.check(self._gate_eval(self.model),
                                          self._gate_eval(self._qmodel))
            self._gate_detail = detail
            if not ok:
                raise ValueError(
                    f"accuracy gate refused the initial int8 quantization "
                    f"({detail.get('reason')}); serve fp32 or relax the "
                    f"gate tolerances")
        self._dispatcher = threading.Thread(
            target=self._loop, name="bigdl-torch-serving-dispatcher",
            daemon=True)
        self._dispatcher.start()

    # ----- request surface -------------------------------------------------- #
    def submit(self, feature, timeout: Optional[float] = None) -> ServeFuture:
        """Enqueue one request (a token-id array); returns a future.
        Blocks while ``queue_capacity`` requests are pending."""
        fut = ServeFuture()
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            if not self._running:
                raise RuntimeError("ServingEngine is closed")
            if self._draining:
                raise EngineDraining(
                    "ServingEngine is draining: admission is closed")
            while self._running and not self._draining and \
                    len(self._pending) >= self.queue_capacity:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    raise FutureTimeoutError(
                        f"submit timed out after {timeout}s: queue full "
                        f"({self.queue_capacity} requests pending)")
                self._not_full.wait(timeout=remaining)
            if not self._running:
                raise RuntimeError("ServingEngine is closed")
            if self._draining:
                raise EngineDraining(
                    "ServingEngine began draining while this submit "
                    "waited for queue space; request not accepted")
            self._pending.append((feature, fut))
            self._not_empty.notify()
        return fut

    def predict(self, feature, timeout: Optional[float] = None):
        """Blocking single request: its output rows (numpy).  ``timeout``
        bounds the whole call; a timed-out request is cancelled."""
        t0 = time.perf_counter()
        fut = self.submit(feature, timeout=timeout)
        remaining = None if timeout is None \
            else max(0.0, timeout - (time.perf_counter() - t0))
        try:
            return fut.result(remaining)
        except FutureTimeoutError:
            self._abandon(fut)
            raise

    def _abandon(self, fut):
        from bigdl_tpu_torch.serving.generation import GenerateFuture

        if isinstance(fut, GenerateFuture):
            if self._gen is not None:
                self._gen._abandon(fut)
            return
        if not fut.cancel():
            return
        with self._lock:
            for entry in self._pending:
                if entry[1] is fut:
                    self._pending.remove(entry)
                    self._not_full.notify()
                    break

    # ----- autoregressive generation ---------------------------------------- #
    def _generation(self):
        """The lazily built generation scheduler."""
        if self._gen is None:
            with self._gen_lock:
                if self._gen is None:
                    if self.decode_slots < 1:
                        raise ValueError(
                            "generation is disabled on this engine "
                            "(decode_slots=0)")
                    from bigdl_tpu_torch.serving.generation import (
                        GenerateScheduler, PagedGenerateScheduler,
                        SpeculativeScheduler)

                    serve_model = self._backend.model
                    kw = dict(slots=self.decode_slots,
                              max_len=self.decode_max_len,
                              prompt_ladder=self._prompt_ladder,
                              queue_capacity=self.queue_capacity,
                              admission_check=self._gen_admission_check)
                    paged_kw = dict(
                        kw, block_size=self.kv_block_size,
                        num_blocks=self.kv_blocks,
                        prefill_chunk=self.prefill_chunk,
                        cache_dtype={"fp32": torch.float32,
                                     "int8": torch.int8}[self.kv_cache_dtype])
                    if self.speculative:
                        # the fp32 model verifies, so the stream is its own
                        self._gen = SpeculativeScheduler(
                            self.model, self._qmodel,
                            spec_k=self.speculative, **paged_kw)
                    elif self.kv_cache == "paged" \
                            and hasattr(serve_model, "init_paged_cache"):
                        self._gen = PagedGenerateScheduler(serve_model,
                                                           **paged_kw)
                    else:
                        self._gen = GenerateScheduler(serve_model, **kw)
        return self._gen

    def _gen_admission_check(self):
        if not self._running:
            raise RuntimeError("ServingEngine is closed")
        if self._draining:
            raise EngineDraining(
                "ServingEngine began draining while this generate was "
                "being admitted; request not accepted")

    def generate(self, prompt, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None):
        """Autoregressive generation of a prompt (1-D token ids); returns
        a streaming ``GenerateFuture``.  Greedy by default;
        ``temperature > 0`` samples (optionally cut by ``top_k`` /
        ``top_p``), and an explicit ``seed`` makes the stream replay
        identically.  Sampling needs ``kv_cache='paged'``."""
        with self._lock:
            if not self._running:
                raise RuntimeError("ServingEngine is closed")
            if self._draining:
                raise EngineDraining(
                    "ServingEngine is draining: admission is closed")
        sampling = None
        if temperature > 0.0 or top_k > 0 or top_p < 1.0 \
                or seed is not None:
            from bigdl_tpu_torch.serving.sampling import SamplingParams

            sampling = SamplingParams(temperature=temperature, top_k=top_k,
                                      top_p=top_p, seed=seed)
        return self._generation().submit(prompt,
                                         max_new_tokens=max_new_tokens,
                                         eos_id=eos_id, timeout=timeout,
                                         sampling=sampling)

    # ----- int8: the twin, the gate ---------------------------------------- #
    @property
    def quantized(self) -> bool:
        """Whether this engine serves the int8 twin."""
        return self._quantized

    def serving_model_bytes(self) -> int:
        """Bytes of the weights that answer requests: the twin's int8
        payloads and scales when quantized, the fp32 tree otherwise."""
        return model_bytes(self._backend.model.parameters_tree())

    @staticmethod
    def _make_gate(accuracy_gate):
        if accuracy_gate is None or \
                isinstance(accuracy_gate, AccuracyDeltaGate):
            return accuracy_gate
        if isinstance(accuracy_gate, dict):
            return AccuracyDeltaGate(**accuracy_gate)
        raise ValueError(
            f"accuracy_gate must be an AccuracyDeltaGate or a dict of its "
            f"kwargs, got {type(accuracy_gate).__name__}")

    def _gate_eval(self, model):
        """``model`` as the gate's ``x -> logits`` callable: the held-out
        batch is padded to its ladder rung, as a served tick would be
        (the int8 side's activation scale is taken over the padded
        batch), and the result sliced back.  Both sides run in the
        engine's ``compute_dtype`` and give fp32."""
        step = make_eval_step(model, self._compute_dtype)
        device = next(model.parameters()).device

        def run(x):
            x = np.asarray(x)
            n = x.shape[0]
            bucket = self.ladder.bucket_for(n)
            xb = x if bucket is None or bucket == n \
                else pad_batch_axis(x, bucket)
            return step(torch.as_tensor(xb, device=device))[:n]
        return run

    # ----- warmup ----------------------------------------------------------- #
    def precompile(self, example_feature=None) -> int:
        """Warm-up before traffic: builds every generation step (on the
        card, one CUDA graph per shape: ``serving/graphs.py``); with
        ``example_feature`` (one request's token ids) also runs every
        predict batch rung once, which loads the kernels.  Returns the
        number of steps built, JAX's "backend compiles performed":
        ``predict`` runs eagerly and builds none."""
        built = 0
        if self.decode_slots > 0 and hasattr(self.model, "init_cache"):
            built += self._generation().precompile()
        if example_feature is not None:
            self._backend.precompile(example_feature, list(self.ladder))
        return built

    def stats(self):
        """Live engine occupancy (JAX ``ServingEngine.stats``): pending
        queue depth, requests claimed by the in-flight tick, lifetime
        ticks and requests served, the drain flag; ``"generate"`` is the
        generation scheduler's ``stats()`` (its ``"graphs"`` counts the
        steps built, built after ``precompile()``, and run)."""
        with self._lock:
            stats = {"pending": len(self._pending),
                     "in_tick": self._in_tick,
                     "draining": self._draining,
                     "running": self._running,
                     "ticks": self._tick,
                     "served": self._served,
                     "queue_capacity": self.queue_capacity}
        if self._gen is not None:
            stats["generate"] = self._gen.stats()
        return stats

    # ----- dispatcher ------------------------------------------------------- #
    def _loop(self):
        fill = min(self.max_batch_size, self.queue_capacity)
        while True:
            with self._lock:
                while self._running and not self._pending:
                    self._idle.notify_all()
                    self._not_empty.wait()
                if not self._running and not self._pending:
                    self._idle.notify_all()
                    return
                deadline = self._pending[0][1]._t_submit + self.max_wait_s
                while self._running and not self._draining \
                        and len(self._pending) < fill:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._not_empty.wait(timeout=remaining)
                take = min(self.max_batch_size, len(self._pending))
                reqs = [self._pending.popleft() for _ in range(take)]
                self._in_tick += len(reqs)
                self._not_full.notify_all()
            claimed = [r for r in reqs
                       if r[1].set_running_or_notify_cancel()]
            try:
                if claimed:
                    self._tick += 1
                    self._run_tick(claimed)
            finally:
                with self._lock:
                    self._in_tick -= len(reqs)
                    self._served += len(claimed)
                    if not self._pending and not self._in_tick:
                        self._idle.notify_all()

    def _form_batch(self, features, bucket):
        x = np.stack([np.asarray(f) for f in features])
        return pad_batch_axis(x, bucket)

    def _run_tick(self, reqs):
        futs = [r[1] for r in reqs]
        try:
            n = len(reqs)
            bucket = self.ladder.bucket_for(n) or self.ladder.add(n)
            y = self._backend.eval(self._form_batch([r[0] for r in reqs],
                                                    bucket))
        except Exception as e:
            log.exception("serving tick failed (%d requests)", len(futs))
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)
            return
        t_done = time.perf_counter()
        for i, fut in enumerate(futs):
            fut.bucket = bucket
            fut.latency_s = t_done - fut._t_submit
            fut.set_result(y[i])

    # ----- lifecycle -------------------------------------------------------- #
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, serve everything already accepted (generations
        included) and return True once idle; False if ``timeout`` passed
        first (the engine keeps draining)."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            self._draining = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            while self._pending or self._in_tick:
                remaining = None if deadline is None \
                    else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(timeout=remaining)
        if self._gen is not None:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.perf_counter())
            return self._gen.drain(timeout=remaining)
        return True

    def close(self, timeout: Optional[float] = 10.0):
        """Stop accepting requests, serve the queue, join the dispatcher
        threads.  Idempotent."""
        with self._lock:
            self._running = False
            self._not_empty.notify_all()
            self._not_full.notify_all()
        self._dispatcher.join(timeout)
        if self._gen is not None:
            self._gen.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
