"""Dynamic-batched inference serving over one model (counterpart of
``bigdl_tpu/serving/engine.py`` ``ServingEngine`` :285 with its
``_LocalEval`` backend :80).

``predict`` / ``submit`` coalesce concurrent requests: a dispatcher
thread drains a bounded queue under a ``max_batch_size`` /
``max_wait_ms`` deadline, pads the batch to a rung of a bucket ladder
(and, with a ``length_ladder``, the time axis to a length rung) and runs
the compiled eval step (``optim.validation.compiled_eval_step``): on the
card one CUDA graph per (batch rung, length rung), captured by
``precompile()`` or by the first tick of that shape, replayed by every
later one.  ``generate`` hands prompts to the continuous-batching decode
scheduler (``serving/generation.py``), paged by default.

Int8: ``quantize=True`` serves the model's int8 twin
(``nn.quantized.quantize_model``), ``kv_cache_dtype="int8"`` stores the
paged pool as int8 blocks decoded through K3q, and ``speculative=k``
drafts ``k`` tokens a round with the twin and verifies them with the fp32
model in one forward.  ``accuracy_gate`` holds the twin against the fp32
model on a held-out batch before the engine serves and at every refresh.

Weights: ``stage_weights`` builds a candidate beside the live weights,
``eval_staged`` / ``set_canary`` / ``set_shadow`` expose it, and
``commit_staged`` (or ``refresh_params``, ``refresh_from_snapshot``)
makes it live.  A CUDA graph reads every tensor at the address it had
when it was captured, where JAX passes the weights to its compiled step
as arguments: so a commit copies the candidate into the very tensors the
graphs read, in place -- the fp32 model's parameters and state, the int8
twin's payloads, scales and state, the compute-dtype copy's parameters,
and K6's packed copy of each int8 convolution weight
(``nn.quantized.repack_in_place``) -- under the locks of the steps that
replay them, so a tick sees either the old weights or the new ones.
``memory_ledger()`` attributes the card's bytes to the weights, the KV
pool, the graphs and the staged candidates.

The model's attention runs through the hand-written CUDA kernels on the
card.  The JAX reference computes in full fp32, and so does the engine
unless ``compute_dtype`` asks for bf16 ``predict``: building it on a
CUDA device switches TF32 matrix products off
(``utils.device.require_fp32_matmul``).

A checkpoint of another layout (``src_layout=``, and every snapshot
``refresh_from_snapshot`` reads: its manifest's ``layout`` block) is
redistributed onto the model's own tree first
(``parallel/reshard.to_model_layout``: tp, ep, sp trees as they are, pp
and pp+tp stage-stacked trees unstacked, scanned and unrolled block
keyings crossed, dp flat planes unravelled), then held to the contract
as any incoming tree; the heterogeneous pipeline's per-stage subtrees
are refused by name (JAX's ``to_model_layout`` passes them through and
its contract check rejects them).

Not ported: the sharded and round-robin layouts (``mesh=``,
``round_robin=``: they need a machine with more than one card, ROADMAP
A6), sharded (orbax) snapshots (A4), request tracing and spans
(``trace=``: A8), the ``reshard`` telemetry event (A8).
"""

import collections
import contextlib
import copy
import logging
import os
import threading
import time
import weakref
from concurrent.futures import Future, TimeoutError as FutureTimeoutError
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.minibatch import (PaddingParam, Sample,
                                               samples_to_minibatch)
from bigdl_tpu_torch.interop.jax_params import (_flatten, is_scanned,
                                                to_port_tree)
from bigdl_tpu_torch.nn.quantized import (model_bytes, packed_weight_bytes,
                                          quantize_model, repack_in_place)
from bigdl_tpu_torch.optim.train_step import compute_copy, make_eval_step
from bigdl_tpu_torch.optim.validation import (AccuracyDeltaGate,
                                              compiled_eval_step)
from bigdl_tpu_torch.serving.buckets import (BucketLadder, ladder_or_default,
                                             pad_batch_axis, pad_length_axis,
                                             walk_length_leaves)
from bigdl_tpu_torch.utils.device import resolve_device, same_device
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

log = logging.getLogger("bigdl_tpu_torch.serving")

_TRACE_REFUSAL = ("request tracing (trace=) is observability/tracing.py, "
                  "not ported (ROADMAP A8)")


class EngineDraining(RuntimeError):
    """``submit()`` refused because the engine is draining: admission is
    closed (``drain()`` .. ``undrain()``) while the dispatcher finishes
    what it already accepted."""


class ServeFuture(Future):
    """Per-request handle: ``result(timeout)`` plus, once served, the
    ``bucket`` the request rode in and its end-to-end ``latency_s``."""

    def __init__(self):
        super().__init__()
        self.bucket: Optional[int] = None
        self.latency_s: Optional[float] = None
        self._t_submit = time.perf_counter()


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, e) for e in tree)
    return fn(tree)


def _as_feature(f):
    """A request's feature as numpy: a tuple is a multi-input activity,
    anything else (an array, a tensor, a list of token ids) one array."""
    if isinstance(f, Sample):
        return f
    if isinstance(f, tuple):
        return Sample(tuple(np.asarray(e) for e in f))
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    return Sample(np.asarray(f))


def _model_copy(model):
    """A copy of ``model`` holding copies of its parameters and buffers
    (no gradients); caches kept outside them (compiled eval steps, K6's
    packed weights, the fused plan) start empty in the copy."""
    memo = {id(p.grad): None for p in model.parameters()
            if p.grad is not None}
    return copy.deepcopy(model, memo).eval()


# --------------------------------------------------------------------------- #
# The weight contract (JAX :224-283).
# --------------------------------------------------------------------------- #


def _flat_leaves(tree):
    """``{"a.b.c": leaf}`` of a nested dict (JAX's ``()`` entries, a layer
    without parameters, hold nothing); ``{}`` for an empty state."""
    return _flatten(tree) if isinstance(tree, dict) else {}


def _clean_state(mstate):
    """A snapshot's model state, or None where it holds no leaf."""
    return mstate if _flat_leaves(mstate) else None


def _dtype_name(leaf):
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        dt = np.result_type(leaf)
    return str(dt).replace("torch.", "")


def _keyed_leaves(tree, path=""):
    """``{"['a']['b']": leaf}`` of a nested dict in JAX's flatten order
    (sorted keys) and ``keystr`` labels; ``()`` entries hold nothing."""
    out = {}
    if not isinstance(tree, dict):
        return out
    for key in sorted(tree):
        leaf, label = tree[key], f"{path}[{key!r}]"
        if isinstance(leaf, dict):
            out.update(_keyed_leaves(leaf, label))
        elif not (isinstance(leaf, (tuple, list)) and not leaf):
            out[label] = leaf
    return out


def _tree_spec(tree):
    """``{label: (shape, dtype)}`` of a weight tree, labelled and ordered
    as JAX's ``_tree_spec`` (``keystr`` paths, sorted keys), so a
    mismatch names the leaf JAX's names: reads the leaves' shape and
    dtype only, so validating weights on the card moves no bytes."""
    return {label: (tuple(np.shape(leaf)), _dtype_name(leaf))
            for label, leaf in _keyed_leaves(tree).items()}


def _spec_mismatch(expect, got, what):
    """The first structure, shape or dtype difference between two
    ``_tree_spec`` results as a reason naming the leaf, or None."""
    for label, e in expect.items():
        if label not in got:
            return (f"{what} tree structure differs at {label}: serving "
                    f"contract expects shape {e[0]} dtype {e[1]}, leaf "
                    f"missing from the incoming tree")
    for label, g in got.items():
        if label not in expect:
            return (f"{what} tree structure differs at {label}: incoming "
                    f"tree carries an unexpected leaf (shape {g[0]} dtype "
                    f"{g[1]}) the serving contract has no plane for")
    for label, e in expect.items():
        g = got[label]
        if e != g:
            return (f"{what} leaf {label}: expected shape {e[0]} dtype "
                    f"{e[1]}, got shape {g[0]} dtype {g[1]}")
    return None


# --------------------------------------------------------------------------- #
# The eval backend (JAX :80-116).
# --------------------------------------------------------------------------- #


class _Staged:
    """A weight set on the device beside the live one: ``ref``, a copy of
    the fp32 model holding it; ``serve``, the model that answers with it
    (a copy of the int8 twin on a quantized engine, else ``ref``);
    ``eval``, what the graphs run (``serve``'s compute-dtype copy, or
    ``serve``); ``step``, the compiled eval step of ``eval``, its own
    graphs."""

    __slots__ = ("ref", "serve", "eval", "compute_dtype", "_step",
                 "__weakref__")

    def __init__(self, ref, serve, eval_model, compute_dtype):
        self.ref, self.serve, self.eval = ref, serve, eval_model
        self.compute_dtype = compute_dtype
        self._step = None

    @property
    def step(self):
        if self._step is None:
            self._step = compiled_eval_step(self.eval, self.compute_dtype)
        return self._step

    def nbytes(self):
        """Device bytes this weight set holds: its models' parameters,
        K6's packed copies and its graphs' pools."""
        models = {id(m): m for m in (self.ref, self.serve, self.eval)}
        total = sum(model_bytes(m.parameters_tree()) +
                    packed_weight_bytes(m) for m in models.values())
        if self._step is not None:
            total += self._step.stats()["pool_bytes"]
        return total


class _LocalEval:
    """Single-device layout: ``model`` (the fp32 model, or the int8 twin
    on a quantized engine) evaluated through its compiled eval step in
    ``compute_dtype`` and returned in fp32.  In a compute dtype the step
    runs a copy of ``model`` cast at construction (``compute_copy``,
    which shares ``model``'s buffers), as the int8 twin is quantized
    then: the generation scheduler's thread keeps reading ``model``."""

    kind = "local"
    align = 1
    replicas = 1

    def __init__(self, model, compute_dtype=None):
        self.model = model
        self.compute_dtype = compute_dtype
        self.device = next(model.parameters()).device
        self.eval_model = model if compute_dtype is None \
            else compute_copy(model, compute_dtype)
        self.step = compiled_eval_step(self.eval_model, compute_dtype)

    def stage(self, ref, serve, warm=True):
        """A ``_Staged`` over ``serve`` (its compute-dtype copy made
        here); with ``warm`` its step is built at every shape the live
        step has built, so its evals capture nothing on ladder-shaped
        batches."""
        eval_model = serve if self.compute_dtype is None \
            else compute_copy(serve, self.compute_dtype)
        staged = _Staged(ref, serve, eval_model, self.compute_dtype)
        if warm:
            staged.step.max_executables = self.step.max_executables
            staged.step.warm_like(self.step)
        return staged

    @torch.no_grad()
    def install(self, staged):
        """After the engine loaded ``model`` in place: the compute copy's
        parameters from the staged one (the same casts), and K6's packed
        copies re-packed in place.  The caller holds ``step.lock``."""
        if self.eval_model is not self.model:
            live = dict(self.eval_model.named_parameters())
            cand = dict(staged.eval.named_parameters())
            for name, p in live.items():
                src = cand[name]
                if src.shape != p.shape or src.dtype != p.dtype:
                    raise ValueError(
                        f"compute copy: {name} cannot be written in place "
                        f"({tuple(src.shape)} {src.dtype} into "
                        f"{tuple(p.shape)} {p.dtype})")
                p.copy_(src)
            repack_in_place(self.eval_model)
        repack_in_place(self.model)

    def _to_device(self, x):
        return _tree_map(lambda a: torch.as_tensor(a, device=self.device), x)

    def eval(self, x, tick=0, weights=None):
        """The padded batch ``x`` (numpy) through the live step, or a
        staged weight set's: numpy out, the replay and the copy to the
        host under the step's lock."""
        step = self.step if weights is None else weights.step
        return step.host(self._to_device(x))

    def precompile(self, sample_spec, buckets):
        """Build the live step at every rung of ``buckets``; returns the
        shapes built."""
        before = self.step.executables()
        self.step.precompile(sample_spec, buckets)
        return self.step.executables() - before


# --------------------------------------------------------------------------- #
# The engine.
# --------------------------------------------------------------------------- #


class ServingEngine:
    """Coalescing, bucketed inference server for one model.

    >>> eng = ServingEngine(model, max_batch_size=32, max_wait_ms=2.0)
    >>> eng.precompile(example_feature=x)   # warm every rung
    >>> y = eng.predict(x)                  # blocking single request
    >>> fut = eng.generate(prompt, max_new_tokens=32)
    >>> fut.result()                        # generated token ids

    A tick dispatches when ``max_batch_size`` requests are pending or the
    oldest has waited ``max_wait_ms``; a full queue back-pressures
    ``submit``.  A tick that raises fails only its own requests.

    ``length_ladder`` (a ``BucketLadder``, copied) rounds the time axis
    of every rank >= 2 input leaf up to a rung (``length_select(i, leaf)``
    picks the leaves; a length past the largest rung adds a rung);
    ``feature_padding`` (``PaddingParam``) stacks requests of different
    lengths.  A result keeps its rung's padded length.  The engine raises
    the compiled step's bound (``max_executables``, default: its batch
    rungs x length rungs + 8) so a warmed ladder does not read as a shape
    leak.

    Generation: ``decode_slots`` (default 8) sequences decode together
    over a KV cache of ``decode_max_len`` positions per sequence,
    ``kv_cache="paged"`` (block pool of ``kv_block_size`` positions per
    block, prefix sharing, chunked prefill, sampling) or
    ``"contiguous"`` (greedy only).

    ``device`` (``None`` means the CUDA card) must be where the model
    lies; the CPU serves only when asked for (``device="cpu"``).

    ``quantize=True`` (or a ``select(path, module)`` predicate for the
    quantizer) serves the int8 twin; the fp32 model stays the weight
    contract (``refresh_params`` takes fp32 trees and quantizes them).
    ``accuracy_gate`` (an ``AccuracyDeltaGate`` or a dict of its
    arguments) compares the fp32 model with the twin on a held-out batch
    at construction and at every refresh, and refuses, with
    ``ValueError``, a twin that diverges beyond its tolerance.
    ``kv_cache_dtype="int8"`` stores the paged pool as int8 payloads plus
    one fp32 scale per (position, head) vector.  ``speculative=k``
    drafts ``k`` tokens a round with the twin (on its own pool of the
    same dtype) and verifies them with the fp32 model: the stream is the
    fp32 model's own.  Both need ``kv_cache="paged"``.

    ``compute_dtype`` (``torch.bfloat16``) runs ``predict`` and the
    accuracy gate in that dtype on the fp32 weights (cast when the engine
    is built) and returns fp32 logits, as the JAX engine's eval step
    does; generation is not affected (its schedulers take the KV cache
    dtype only).

    ``telemetry`` is any object with ``record(kind, **fields)`` (and
    ``set_serving_info(info)``): each tick records a ``kind:
    "inference"`` event, each weight swap a ``param_refresh`` one.
    """

    def __init__(self, model, max_batch_size: int = 32,
                 max_wait_ms: float = 2.0, queue_capacity: int = 1024,
                 ladder: Optional[BucketLadder] = None,
                 length_ladder: Optional[BucketLadder] = None,
                 length_select=None,
                 feature_padding: Optional[PaddingParam] = None,
                 compute_dtype=None, mesh=None, axis: str = "data",
                 round_robin: bool = False, telemetry=None,
                 max_executables: Optional[int] = None,
                 quantize=False, accuracy_gate=None,
                 decode_slots: Optional[int] = None,
                 decode_max_len: Optional[int] = None,
                 prompt_ladder: Optional[BucketLadder] = None,
                 kv_cache: str = "paged", kv_block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_cache_dtype: str = "fp32", speculative: int = 0,
                 device=None):
        device = resolve_device(device)
        model_device = next(model.parameters()).device
        if not same_device(device, model_device):
            raise ValueError(f"ServingEngine on {device} was given a model "
                             f"on {model_device}")
        if mesh is not None and _axis_size(mesh, axis) > 1:
            raise UnsupportedFeatureError(
                "the sharded serving layout (mesh=) is not ported: it "
                "needs a machine with more than one card (ROADMAP A6)")
        if round_robin and device.type == "cuda" \
                and torch.cuda.device_count() > 1:
            raise UnsupportedFeatureError(
                "the round-robin serving layout over several cards is not "
                "ported: it needs a machine with more than one card "
                "(ROADMAP A6)")
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
        # the serving contract frozen at construction: every later weight
        # set is checked against the fp32 tree before anything is staged
        self._params_spec = _tree_spec(model.parameters_tree())
        self._mstate_spec = _tree_spec(model.state_tree())
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
        # copied: over-max lengths grow this ladder under traffic, which
        # must not reach a ladder the caller shares with other engines
        self.length_ladder = None if length_ladder is None \
            else length_ladder.copy()
        self.length_select = length_select
        self.feature_padding = feature_padding
        self.telemetry = telemetry
        self._explicit_bound = max_executables is not None
        if self._explicit_bound:
            # the bound lives on the (model, dtype)'s shared step
            self._backend.step.max_executables = max_executables
        else:
            self._fit_bound(len(self.ladder))
        #: one request's feature (numpy), recorded by precompile()
        self._spec = None
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
        # staged exposure: set by a rollout thread, read once a tick
        self._canary = None           # (handle, fraction, version)
        self._canary_acc = 0.0
        self._canary_ticks = 0
        self._canary_rows = 0
        self._canary_failures = 0
        self._shadow = None           # (fn, fraction)
        self._shadow_acc = 0.0
        self._version_info = None
        self._retained = weakref.WeakSet()
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
        self._memory_ledger = None
        self._gate_detail = None
        if self._gate is not None:
            # the twin must clear the gate before the engine serves at all
            ok, detail = self._gate.check(self._gate_eval(self.model),
                                          self._gate_eval(self._qmodel))
            self._gate_detail = detail
            if not ok:
                self._record_refresh("rejected", detail.get("reason"),
                                     accuracy_gate=detail)
                raise ValueError(
                    f"accuracy gate refused the initial int8 quantization "
                    f"({detail.get('reason')}); serve fp32 or relax the "
                    f"gate tolerances")
        self._stamp_serving_info()
        self._dispatcher = threading.Thread(
            target=self._loop, name="bigdl-torch-serving-dispatcher",
            daemon=True)
        self._dispatcher.start()

    # ----- request surface -------------------------------------------------- #
    def submit(self, feature, timeout: Optional[float] = None,
               trace=None) -> ServeFuture:
        """Enqueue one request (an array, a tuple of arrays, or a
        ``Sample``); returns a future.  Blocks while ``queue_capacity``
        requests are pending; with ``timeout``, a queue still full after
        that many seconds raises ``concurrent.futures.TimeoutError``."""
        if trace is not None:
            raise UnsupportedFeatureError(_TRACE_REFUSAL)
        fut = ServeFuture()
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            if not self._running:
                raise RuntimeError("ServingEngine is closed")
            if self._draining:
                raise EngineDraining(
                    "ServingEngine is draining (admission closed until "
                    "undrain()); already-accepted requests will still be "
                    "served")
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

    def predict(self, feature, timeout: Optional[float] = None,
                trace=None):
        """Blocking single request: its output rows (numpy).  ``timeout``
        bounds the whole call, admission included; a timed-out request
        is cancelled."""
        t0 = time.perf_counter()
        fut = self.submit(feature, timeout=timeout, trace=trace)
        remaining = None if timeout is None \
            else max(0.0, timeout - (time.perf_counter() - t0))
        try:
            return fut.result(remaining)
        except FutureTimeoutError:
            self._abandon(fut)
            raise

    def predict_many(self, features, timeout: Optional[float] = None):
        """Submit a burst and wait for every result.  ``timeout`` bounds
        the whole call: each admission and every result wait draw on one
        budget, and a timeout cancels the burst's pending requests."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout

        def remaining():
            return None if deadline is None \
                else max(0.0, deadline - time.perf_counter())

        futs: List[ServeFuture] = []
        try:
            for f in features:
                futs.append(self.submit(f, timeout=remaining()))
            return [f.result(remaining()) for f in futs]
        except FutureTimeoutError:
            for f in futs:
                self._abandon(f)
            raise

    def _abandon(self, fut):
        """Cancel a timed-out request and free its queue slot now; a
        ``GenerateFuture`` goes to the generation scheduler's queue."""
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

    def predict_at(self, feature, bucket: int):
        """This one request padded to ``bucket`` rows (and its length
        rung), evaluated on the caller's thread outside the queue through
        the same step and shape as a tick of that bucket: within a shape
        the kernels and their reduction order are fixed, so where eval
        rows are independent it is bitwise the request served in such a
        tick.  An int8 twin's activation scale is taken over the whole
        padded batch, so there it is bitwise a tick that held this
        request alone."""
        x = self._form_batch([feature], bucket)
        y = self._backend.eval(x, tick=0)
        return _tree_map(lambda a: a[0], y)

    # ----- autoregressive generation ---------------------------------------- #
    def _generation(self):
        """The lazily built generation scheduler, over the model the
        eval path serves (the twin on a quantized engine)."""
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
                              admission_check=self._gen_admission_check,
                              exhausted_hook=self._on_pool_exhausted)
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
                 timeout: Optional[float] = None, trace=None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None):
        """Autoregressive generation of a prompt (1-D token ids); returns
        a streaming ``GenerateFuture``.  Greedy by default;
        ``temperature > 0`` samples (optionally cut by ``top_k`` /
        ``top_p``), and an explicit ``seed`` makes the stream replay
        identically.  Sampling needs ``kv_cache='paged'``."""
        if trace is not None:
            raise UnsupportedFeatureError(_TRACE_REFUSAL)
        with self._lock:
            if not self._running:
                raise RuntimeError("ServingEngine is closed")
            if self._draining:
                raise EngineDraining(
                    "ServingEngine is draining (admission closed until "
                    "undrain()); in-flight generations still complete")
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

    # ----- the step's shape set --------------------------------------------- #
    def _fit_bound(self, n_buckets):
        """Raise the shared step's bound to this engine's closed shape set
        (batch rungs x length rungs) plus headroom for validation's own
        batch; an explicit ``max_executables`` is left alone."""
        if self._explicit_bound:
            return
        combos = n_buckets * (len(self.length_ladder)
                              if self.length_ladder is not None else 1)
        step = self._backend.step
        step.max_executables = max(step.max_executables, combos + 8)

    def _executables(self):
        """Shapes the live predict step has built (on the card: graphs
        captured); a rise after ``precompile()`` is a shape leak."""
        return self._backend.step.executables()

    def executables(self):
        """Steps this engine has built: the predict step's shapes plus
        the generation scheduler's (on the card: CUDA graphs)."""
        n = self._executables()
        if self._gen is not None:
            n += self._gen.stats()["graphs"]["captured"]
        return n

    def _sample_spec(self, example_feature=None):
        if example_feature is not None:
            feat = example_feature.feature \
                if isinstance(example_feature, Sample) else example_feature
            self._spec = _tree_map(np.asarray, _as_feature(feat).feature)
        if self._spec is None:
            raise ValueError(
                "precompile() needs the per-sample feature shape: the "
                "model records none (the port builds no spec) -- pass "
                "example_feature=")
        return self._spec

    def precompile(self, buckets=None, example_feature=None) -> int:
        """Build every step before traffic; returns the steps built
        (on the card: CUDA graphs captured), generation's included.

        Generation's shape set is warmed whenever the served model has a
        decode mode.  The predict step is warmed at every rung of
        ``buckets`` (default: the whole batch ladder), each at every
        length rung with a ``length_ladder`` (``walk_length_leaves`` over
        one sample, as ``pad_length_axis`` does to traffic), from
        ``example_feature``, one request's feature.  The port's models
        record no input spec, so the first call that warms predict needs
        ``example_feature`` (later calls reuse it): without one,
        ``precompile()`` warms generation only, and ``precompile(buckets)``
        raises ``ValueError`` ("pass example_feature=") before building
        anything.  After it, traffic within the ladders builds nothing."""
        if buckets is not None:
            buckets = [int(b) for b in buckets]
            bad = [b for b in buckets if b < 1 or b % self._backend.align]
            if bad:
                raise ValueError(f"buckets {bad} are not batch sizes of "
                                 f"this layout (align "
                                 f"{self._backend.align})")
        if buckets is not None or example_feature is not None:
            spec = self._sample_spec(example_feature)
        else:
            spec = self._spec
        built = 0
        if self.decode_slots > 0 \
                and hasattr(self._backend.model, "init_cache"):
            built += self._generation().precompile()
        if spec is None:
            return built
        if buckets is None:
            buckets = list(self.ladder)
        self._fit_bound(len(buckets))
        if self.length_ladder is None:
            return built + self._backend.precompile(spec, buckets)
        for rung in self.length_ladder:
            at_rung = walk_length_leaves(
                spec, self.length_select,
                lambda a, _r=int(rung): np.zeros((_r,) + a.shape[1:],
                                                 a.dtype),
                batched=False)
            built += self._backend.precompile(at_rung, buckets)
        return built

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
                qdepth = len(self._pending)
                self._in_tick += len(reqs)
                self._not_full.notify_all()
            claimed = [r for r in reqs
                       if r[1].set_running_or_notify_cancel()]
            try:
                if claimed:
                    self._tick += 1
                    self._run_tick(claimed, qdepth)
            finally:
                with self._lock:
                    self._in_tick -= len(reqs)
                    self._served += len(claimed)
                    if not self._pending and not self._in_tick:
                        self._idle.notify_all()

    def _form_batch(self, features, bucket):
        samples = [_as_feature(f) for f in features]
        mb = samples_to_minibatch(samples,
                                  feature_padding=self.feature_padding)
        x = pad_batch_axis(mb.get_input(), bucket)
        if self.length_ladder is not None:
            x = pad_length_axis(x, self.length_ladder, self.length_select)
        return x

    def _span(self, name, **kw):
        """Span seam of a tick (JAX's ``observability/spans.py``): a no-op
        until ROADMAP A8."""
        return contextlib.nullcontext()

    def _run_tick(self, reqs, qdepth=0):
        t0 = time.perf_counter()
        feats = [r[0] for r in reqs]
        futs = [r[1] for r in reqs]
        execs_before = self._executables() \
            if self.telemetry is not None else 0
        # canary routing decided up front (error diffusion: a fraction f
        # serves f of the ticks, spread evenly); the tuple is read once
        canary = self._canary
        on_canary = False
        if canary is not None:
            self._canary_acc += canary[1]
            if self._canary_acc >= 1.0 - 1e-9:
                self._canary_acc -= 1.0
                on_canary = True
        reached_eval = False
        try:
            with self._span("serve_tick", tick=self._tick,
                            records=len(reqs)):
                n = len(feats)
                bucket = self.ladder.bucket_for(n) or self.ladder.add(n)
                x = self._form_batch(feats, bucket)
                t_formed = time.perf_counter()
                reached_eval = True
                y = self._backend.eval(
                    x, tick=self._tick,
                    weights=canary[0]["staged"] if on_canary else None)
        except Exception as e:
            log.exception("serving tick %d failed (%d requests)",
                          self._tick, len(futs))
            if on_canary and reached_eval:
                # a failing candidate eval is canary evidence; a malformed
                # request failing batch formation is not
                self._canary_failures += 1
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)
            return
        t_done = time.perf_counter()
        for i, fut in enumerate(futs):
            fut.bucket = bucket
            fut.latency_s = t_done - fut._t_submit
            fut.set_result(_tree_map(lambda a, _i=i: a[_i], y))
        if on_canary:
            self._canary_ticks += 1
            self._canary_rows += n
        # shadow mirroring after the results are delivered: the observer
        # gets the padded batch and the live outputs and must only enqueue
        shadow = self._shadow
        if shadow is not None:
            self._shadow_acc += shadow[1]
            if self._shadow_acc >= 1.0 - 1e-9:
                self._shadow_acc -= 1.0
                try:
                    shadow[0](x, y, bucket, n, self._tick)
                except Exception:
                    log.exception("shadow observer failed (tick %d)",
                                  self._tick)
        if self.telemetry is not None:
            try:
                wall = t_done - t0
                event = dict(
                    step=self._tick, wall_s=wall,
                    data_wait_s=t_formed - t0, device_s=t_done - t_formed,
                    records=n, records_per_s=n / max(wall, 1e-9),
                    queue_depth=qdepth, queue_capacity=self.queue_capacity,
                    bucket=bucket, batch_fill=n / bucket,
                    pad_waste=(bucket - n) / bucket,
                    request_latency_s=[round(f.latency_s, 6) for f in futs])
                if on_canary:
                    event["canary"] = True
                    event["canary_version"] = canary[2]
                compiles = self._executables() - execs_before
                if compiles > 0:
                    event["compiles"] = compiles
                self.telemetry.record("inference", **event)
            except Exception:
                log.exception("serving telemetry record failed (tick %d)",
                              self._tick)

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

    def _check_accuracy(self, staged):
        """The gate on a staged candidate (nothing committed): its fp32
        copy against its twin on the held-out batch; ``(ok, detail)``."""
        return self._gate.check(self._gate_eval(staged.ref),
                                self._gate_eval(staged.serve))

    def _stamp_serving_info(self):
        """The telemetry's serving header: precision, weight bytes,
        layout, generation settings, version and gate detail."""
        if self.telemetry is None:
            return
        info = {"quantized": self._quantized,
                "weight_dtype": "int8" if self._quantized else "float32",
                "model_bytes": self.serving_model_bytes(),
                "backend": self._backend.kind,
                "replicas": self._backend.replicas}
        if self.decode_slots > 0:
            info["decode_slots"] = self.decode_slots
            info["kv_cache"] = self.kv_cache
            if self.kv_cache == "paged":
                info["kv_block_size"] = self.kv_block_size
                info["kv_cache_dtype"] = self.kv_cache_dtype
            if self.speculative:
                info["speculative"] = self.speculative
        if self._version_info is not None:
            info["version"] = self._version_info["version"]
            info["digest"] = self._version_info["digest"]
        if self._quantized:
            info["model_bytes_fp32"] = model_bytes(
                self.model.parameters_tree())
        if self._gate_detail is not None:
            info["accuracy_gate"] = self._gate_detail
        setter = getattr(self.telemetry, "set_serving_info", None)
        if setter is None:
            return
        try:
            setter(info)
        except Exception:
            log.exception("serving_info telemetry stamp failed")

    def _flush_prefix_cache(self):
        """After a weight swap: drop the paged scheduler's prefix cache
        (K/V computed under the old weights must not serve new prompts;
        live sequences keep their blocks and finish mid-flight)."""
        flush = getattr(self._gen, "flush_prefix_cache", None)
        if flush is not None:
            flush()

    # ----- device-memory ledger -------------------------------------------- #
    def memory_ledger(self):
        """The engine's ``MemoryLedger``: ``params`` (plus
        ``params_fp32``, the retained fp32 tree, on a quantized engine),
        ``kv_cache`` with its active / prefix-cached / free block split,
        ``graphs`` (the pools of the predict and generation graphs) and
        ``staged``: the weight sets this engine staged that a caller
        still holds, their graphs' pools included.  Built once, attached
        to the telemetry."""
        if self._memory_ledger is None:
            from bigdl_tpu_torch.observability.memory import MemoryLedger

            led = MemoryLedger()
            led.register("params", self.serving_model_bytes)
            if self._quantized:
                led.register("params_fp32", lambda: model_bytes(
                    self.model.parameters_tree()))
            led.register("kv_cache", self._kv_cache_bytes)
            led.register("graphs", self._graph_bytes)
            led.register("staged", self._staged_bytes)
            if self.telemetry is not None:
                led.attach(self.telemetry)
            self._memory_ledger = led
        return self._memory_ledger

    def _staged_bytes(self):
        handles = list(self._retained)
        return {"bytes": sum(h.nbytes() for h in handles),
                "handles": len(handles)}

    def _graph_bytes(self):
        """Ledger source for the graphs: the predict step's pools (and
        its shapes) plus the generation scheduler's."""
        st = self._backend.step.stats()
        rec = {"bytes": st["pool_bytes"], "predict_graphs": st["captured"]}
        gen = self._gen
        if gen is not None:
            rec["bytes"] += gen._graphs.pool_bytes
            rec["generate_graphs"] = gen.stats()["graphs"]["captured"]
        return rec

    def _kv_cache_bytes(self):
        """Ledger source for the generation KV pool: its bytes plus the
        allocator's block split (0 until the scheduler is built)."""
        gen = self._gen
        if gen is None:
            return 0
        rec = {"bytes": gen.cache_bytes()}
        alloc = getattr(gen, "_alloc", None)
        if alloc is not None:
            st = alloc.stats()
            total = st.get("blocks_total") or 0
            per_block = st.get("bytes_per_block")
            if per_block is None:
                per_block = rec["bytes"] / total if total else 0
            rec.update(
                blocks_total=total,
                blocks_active=st.get("blocks_used"),
                blocks_cached=st.get("blocks_cached"),
                blocks_free=st.get("blocks_free"),
                kv_dtype=st.get("kv_dtype"),
                active_bytes=int(st.get("blocks_used", 0) * per_block),
                cached_bytes=int(st.get("blocks_cached", 0) * per_block),
                free_bytes=int(st.get("blocks_free", 0) * per_block))
        return rec

    def memory_headroom(self):
        """The capacity signal: the allocator's headroom (None on the
        CPU) plus the KV pool's block occupancy, cached blocks counting
        as free (they are evictable)."""
        snap = self.memory_ledger().snapshot()
        out = {"headroom_bytes": snap["headroom_bytes"],
               "headroom_fraction": snap["headroom_fraction"],
               "attributed_bytes": snap["attributed_bytes"],
               "live_bytes": snap["live_bytes"]}
        gen = self._gen
        alloc = getattr(gen, "_alloc", None) if gen is not None else None
        if alloc is not None:
            st = alloc.stats()
            total = st.get("blocks_total") or 0
            free = st.get("blocks_free", 0) + st.get("blocks_cached", 0)
            out["kv_blocks_total"] = total
            out["kv_blocks_free"] = free
            out["kv_fill"] = round(1.0 - free / total, 6) if total else 0.0
        return out

    def record_memory(self, **extra):
        """The ledger's snapshot as a ``kind: "memory"`` event."""
        return self.memory_ledger().record(step=self._tick, **extra)

    def _on_pool_exhausted(self, exc):
        """Generation's ``BlockPoolExhausted`` hook: the ledger's one
        forensic dump, with the block occupancy."""
        try:
            self.memory_ledger().handle_allocation_failure(
                exc, detail={"kv": self._kv_cache_bytes()},
                reason="kv_block_pool_exhausted")
        except Exception:
            log.exception("memory forensics dump failed")

    # ----- staged deployment ----------------------------------------------- #
    def _validate_incoming(self, params, mstate):
        """The first structure, shape or dtype mismatch of an incoming
        weight set against the construction-time contract, or None."""
        reason = _spec_mismatch(self._params_spec, _tree_spec(params),
                                "params")
        if reason is None and mstate is not None:
            reason = _spec_mismatch(self._mstate_spec, _tree_spec(mstate),
                                    "mstate")
        return reason

    def _stage(self, params, mstate, warm=True):
        """A ``_Staged`` candidate built from an fp32 tree (validated):
        a copy of the fp32 model loaded with it, quantized once on a
        quantized engine."""
        ref = _model_copy(self.model)
        ref.load_parameters_tree(params)
        if mstate is not None:
            ref.load_state_tree(mstate)
        serve = quantize_model(ref, select=self._qselect)[0] \
            if self._quantized else ref
        return self._backend.stage(ref, serve, warm=warm)

    def _handle(self, staged):
        """JAX's handle keys over a ``_Staged`` weight set."""
        self._retained.add(staged)
        serve_tree = staged.serve.parameters_tree()
        return {"params": staged.ref.parameters_tree(),
                "mstate": staged.ref.state_tree() or None,
                "qparams": serve_tree if self._quantized else None,
                "staged": staged, "model_bytes": model_bytes(serve_tree),
                "quantized": self._quantized}

    def stage_weights(self, params, mstate=None, src_layout=None):
        """Validate a candidate fp32 weight set (``parameters_tree()``
        keys; numpy or tensor leaves) and build it on the device beside
        the live weights, committing nothing: returns a handle for
        ``eval_staged``, ``set_canary`` and ``commit_staged``.  A
        half-written tree raises here, before anything is staged.  On a
        quantized engine the candidate is quantized once, here.  The
        candidate lives in a copy of the model with its own compiled
        eval step, built at every shape the live step has built, so its
        evals on ladder-shaped batches capture nothing.  ``src_layout``
        (a ``LayoutSpec`` or its manifest dict): ``params`` were saved
        under that layout and are redistributed onto this model's tree
        before the check (``_from_layout``)."""
        if src_layout is not None:
            params = self._from_layout(params, src_layout, "deploy-stage")
        reason = self._validate_incoming(params, mstate)
        if reason is not None:
            raise ValueError(
                f"stage_weights rejected the candidate ({reason}); "
                f"nothing was staged -- is the source checkpoint "
                f"half-written or from a different model?")
        return self._handle(self._stage(params, mstate))

    def capture_staged(self):
        """The weights serving now as a staged handle, for a rollback.
        A commit overwrites the live tensors in place (the graphs read
        them), so this clones them -- the fp32 model's parameters and
        state, the twin's payloads and scales, never re-quantized -- into
        a weight set of its own; committing the handle later restores
        these weights bit for bit.  A commit only copies tensors, so the
        handle's step is not warmed here: its graphs are built when the
        handle is first evaluated (``eval_staged``, a canary)."""
        ref = _model_copy(self.model)
        serve = _model_copy(self._qmodel) if self._quantized else ref
        return self._handle(self._backend.stage(ref, serve, warm=False))

    @contextlib.contextmanager
    def _swap_locks(self):
        """The locks of every step that replays the live weights: the
        predict step's and the generation scheduler's."""
        gen = self._gen
        with self._backend.step.lock:
            if gen is None:
                yield
            else:
                with gen._step_lock:
                    yield

    @torch.no_grad()
    def _install(self, staged):
        """Copy a staged weight set into the live tensors, in place,
        under the steps' locks: the fp32 model, the twin, the compute
        copy, K6's packed copies.  A tensor that cannot take it in place
        raises before anything is copied (``load_parameters_tree``
        checks every leaf first)."""
        with self._swap_locks():
            self.model.load_parameters_tree(staged.ref.parameters_tree())
            self.model.load_state_tree(staged.ref.state_tree())
            if self._quantized:
                self._qmodel.load_parameters_tree(
                    staged.serve.parameters_tree())
                self._qmodel.load_state_tree(staged.serve.state_tree())
            self._backend.install(staged)
            if self._backend.device.type == "cuda":
                torch.cuda.current_stream(self._backend.device).synchronize()

    def commit_staged(self, handle, version=None, digest=None):
        """Make a staged handle's weights live: copied in place into
        every tensor the graphs read (module docstring), under the
        replaying steps' locks, so a tick serves the old weights or the
        new ones, never a mix.  Committing a handle from
        ``capture_staged`` is the rollback.  No gate runs here: exposure
        verdicts come before the commit.  Then the prefix cache is
        flushed and the serving header stamped."""
        if handle.get("quantized") != self._quantized:
            raise ValueError(
                "staged handle precision does not match this engine "
                "(was it staged on a different engine?)")
        self._install(handle["staged"])
        if version is not None:
            self.set_serving_version(version, digest)
        audit = {"model_bytes": handle.get("model_bytes"), "staged": True}
        if self._quantized:
            audit["quantized"] = True
        self._record_refresh("ok", **audit)
        self._flush_prefix_cache()
        self._stamp_serving_info()
        return self

    def eval_staged(self, handle, x, tick=0):
        """A padded batch ``x`` through a staged handle's own step (the
        shadow evaluation path): numpy out, nothing committed.  Runs on
        the caller's thread."""
        return self._backend.eval(x, tick=tick, weights=handle["staged"])

    def set_canary(self, handle, fraction=0.1, version=None):
        """Route ``fraction`` of ticks onto a staged handle's weights
        (error-diffused, so the fraction holds over any window);
        ``set_canary(None)`` ends it.  The stats reset on every call."""
        if handle is not None and not 0.0 < float(fraction) <= 1.0:
            raise ValueError(
                f"canary fraction must be in (0, 1], got {fraction}")
        self._canary_acc = 0.0
        self._canary_ticks = 0
        self._canary_rows = 0
        self._canary_failures = 0
        self._canary = None if handle is None \
            else (handle, float(fraction), version)
        return self

    def canary_stats(self):
        """``{"ticks", "rows", "failures"}`` of the current canary
        window (since the last ``set_canary``)."""
        return {"ticks": self._canary_ticks, "rows": self._canary_rows,
                "failures": self._canary_failures}

    def set_shadow(self, fn, fraction=1.0):
        """Mirror ``fraction`` of ticks to ``fn(x_padded, y_live, bucket,
        n_real, tick)`` after their results are delivered, on the
        dispatcher thread (the observer must only enqueue; evaluate the
        candidate elsewhere, ``eval_staged``).  ``set_shadow(None)``
        stops; an observer's exception is logged and swallowed."""
        if fn is not None and not 0.0 < float(fraction) <= 1.0:
            raise ValueError(
                f"shadow fraction must be in (0, 1], got {fraction}")
        self._shadow_acc = 0.0
        self._shadow = None if fn is None else (fn, float(fraction))
        return self

    def set_serving_version(self, version, digest=None):
        """Stamp which model version this engine serves (the serving
        header and every ``param_refresh`` event carry it)."""
        self._version_info = {"version": int(version),
                              "digest": None if digest is None
                              else str(digest)}
        self._stamp_serving_info()
        return self

    # ----- refresh ----------------------------------------------------------- #
    def refresh_from_snapshot(self, path):
        """Hot-swap the weights of a training snapshot written under any
        layout: ``path`` is a ``checkpoint.<tag>.pkl`` file (either
        package writes the same pickle layout) or a checkpoint
        directory, whose newest intact snapshot is taken (corrupt ones
        are quarantined, as resume does).  The snapshot is loaded under
        its own layout (its manifest's ``layout`` block) and handed on
        with it: ``refresh_params(src_layout=)`` redistributes it onto
        this model's tree, then the contract check and the gate run.  A
        data-parallel snapshot's flat plane (``model_params_flat``,
        ``optim.DistriOptimizer``) unravels through this model's
        parameter tree here.  A sharded (orbax) snapshot is not ported:
        ROADMAP A4."""
        p = self._resolve_snapshot(path)
        params, mstate, src = self._read_snapshot(p)
        return self.refresh_params(params, mstate, src_layout=src)

    def _read_snapshot(self, p):
        """``(params, mstate, src_layout)`` of the pickle snapshot ``p``:
        its tree under the layout its manifest names, and that layout;
        or the tree in this model's layout and None (a dp flat plane,
        unravelled here; a snapshot whose manifest names no layout)."""
        from bigdl_tpu_torch.parallel.reshard import read_snapshot_layout

        src = read_snapshot_layout(p)
        if src is not None and src.kind == "dp":
            src = None
        params, mstate = self._load_snapshot_weights(p, src)
        return params, mstate, src

    def _from_layout(self, params, src_layout, what):
        """``params`` saved under ``src_layout`` -> this model's own tree
        (JAX's ``to_model_layout`` call in ``refresh_params`` and
        ``stage_weights``; its ``telemetry=`` event is A8).  The
        heterogeneous pipeline's list of per-stage subtrees is refused
        here, by name: JAX's ``to_model_layout`` returns it as it is and
        its contract check then rejects the list."""
        from bigdl_tpu_torch.parallel.reshard import (LayoutSpec,
                                                      to_model_layout)

        src = LayoutSpec.coerce(src_layout)
        if src.plane.get("het"):
            raise ValueError(
                f"src_layout {src.describe()} is the heterogeneous "
                f"Sequential pipeline's (het): its per-stage subtrees do "
                f"not redistribute onto the serving tree -- load the "
                f"snapshot into the model and refresh_params() from it")
        return to_port_tree(to_model_layout(params, src, self.model,
                                            what=what),
                            is_scanned(self.model))

    @staticmethod
    def _resolve_snapshot(path):
        from bigdl_tpu_torch.utils import file_io

        base = os.path.basename(str(path).rstrip("/"))
        if base.startswith("snap_"):
            raise UnsupportedFeatureError(
                f"{path} is a sharded (orbax) snapshot: not ported, "
                f"ROADMAP A4")
        if not file_io.isdir(path):
            return path
        intact, quarantined = file_io.scan_checkpoints(path)
        if intact:
            return intact[0]
        if any(name.startswith("snap_") for name in file_io.listdir(path)):
            raise UnsupportedFeatureError(
                f"{path} holds sharded (orbax) snapshots only: not ported, "
                f"ROADMAP A4")
        raise ValueError(
            f"no intact snapshot under {path}"
            + (f" (quarantined: {quarantined})" if quarantined else ""))

    def _load_snapshot_weights(self, p, src_layout=None):
        """``(params, mstate)`` of a pickle snapshot.  With
        ``src_layout`` (the snapshot's own layout) the tree as it was
        saved under it, for ``refresh_params(src_layout=)`` to
        redistribute (JAX :1476-1498); without, in this model's layout
        (a TransformerLM's scanned and unrolled keyings cross).  A
        data-parallel flat plane unravels here either way."""
        from bigdl_tpu_torch.utils import file_io

        payload = file_io.load(p)
        mp = payload["model_params"]
        mstate = _clean_state(payload.get("model_state"))
        if isinstance(mp, dict) and "model_params_flat" in mp:
            return self._unravel_flat(p, mp["model_params_flat"]), mstate
        if src_layout is not None:
            return mp, mstate
        return to_port_tree(mp, is_scanned(self.model)), mstate

    def _unravel_flat(self, p, flat):
        """A snapshot's flat plane as this model's parameter tree (the
        JAX keys): the padding dropped, the leaves in the JAX tree's
        order.  The manifest's ``layout`` must be data-parallel and hold
        this model's parameter count."""
        from bigdl_tpu_torch.interop.jax_params import _nest
        from bigdl_tpu_torch.parallel.zero import FlatParamSpace
        from bigdl_tpu_torch.utils import file_io

        layout = (file_io.read_manifest(p) or {}).get("layout") or {}
        if layout.get("kind", "dp") != "dp":
            raise ValueError(
                f"{p} holds a flat parameter plane, but its manifest "
                f"names a {layout['kind']!r} layout: only a data-parallel "
                f"snapshot is a flat plane")
        space = FlatParamSpace(dict(self.model.named_parameters()), 1)
        flat = np.asarray(flat, np.float32)
        true = int(layout.get("true_size", space.true_size))
        if true != space.true_size or flat.shape[-1] < space.true_size:
            raise ValueError(
                f"{p}'s flat plane holds {true} parameters, this model "
                f"{space.true_size}")
        return _nest({k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in space.unflatten(flat).items()})

    def refresh_params(self, params=None, mstate=None, src_layout=None):
        """Swap in new weights.  With ``params`` (and optionally
        ``mstate``, fp32 trees keyed like ``parameters_tree()`` /
        ``state_tree()``): the tree's structure, shapes and dtypes are
        checked against the construction-time contract first, so a
        half-written checkpoint raises ``ValueError`` and the engine keeps
        serving its weights.  Without arguments (the caller changed
        ``self.model`` in place) the model's own weights are checked and
        re-derived (twin, compute copy).  On a quantized engine the
        candidate is quantized and held to ``accuracy_gate``; a refusal
        raises through the same rejected-with-reason audit and nothing
        changes.  Then the weights are committed in place, as
        ``commit_staged`` does.  ``src_layout`` (a ``LayoutSpec`` or its
        manifest dict) names the layout the incoming ``params`` were
        saved under: they are redistributed onto this model's tree
        first (``_from_layout``), then checked and gated as any
        incoming tree."""
        incoming = params is not None
        if src_layout is not None:
            if not incoming:
                raise ValueError(
                    "src_layout describes an INCOMING params tree; "
                    "pass params= alongside it")
            params = self._from_layout(params, src_layout,
                                       "serving-refresh")
        if not incoming:
            params = self.model.parameters_tree()
        reason = self._validate_incoming(params, mstate)
        if reason is not None:
            self._record_refresh("rejected", reason)
            if incoming:
                raise ValueError(
                    f"refresh_params rejected the incoming weights "
                    f"({reason}); the engine keeps serving its current "
                    "weights -- is the source checkpoint half-written or "
                    "from a different model?")
            raise ValueError(
                f"refresh_params: the model's weights no longer match the "
                f"serving contract ({reason}); nothing was refreshed")
        staged = self._stage(params, mstate, warm=False)
        gate_detail, audit = None, {}
        if self._quantized and self._gate is not None:
            ok, gate_detail = self._check_accuracy(staged)
            if not ok:
                reason = "accuracy gate: " + gate_detail.get("reason",
                                                             "failed")
                self._record_refresh("rejected", reason,
                                     accuracy_gate=gate_detail)
                raise ValueError(
                    f"refresh_params rejected the incoming weights "
                    f"({reason}); the engine keeps serving its current "
                    "weights")
            self._gate_detail = gate_detail
        audit["model_bytes"] = model_bytes(staged.serve.parameters_tree())
        if self._quantized:
            audit["quantized"] = True
        audit["wire_bytes"] = audit["model_bytes"] * self._backend.replicas
        self._install(staged)
        if gate_detail is not None:
            audit["accuracy_gate"] = gate_detail
        self._record_refresh("ok", **audit)
        self._flush_prefix_cache()
        self._stamp_serving_info()
        return self

    def _record_refresh(self, outcome, reason=None, **extra):
        """The weight-swap audit: one ``kind: "param_refresh"`` event per
        outcome, ok or rejected (with its reason)."""
        if self.telemetry is None:
            return
        try:
            fields = {"tick": self._tick, "outcome": outcome,
                      "backend": self._backend.kind, **extra}
            if self._version_info is not None:
                fields.setdefault("version", self._version_info["version"])
                fields.setdefault("digest", self._version_info["digest"])
            if reason is not None:
                fields["reason"] = str(reason)[:300]
            self.telemetry.record("param_refresh", **fields)
        except Exception:
            log.exception("param_refresh telemetry record failed")

    # ----- lifecycle -------------------------------------------------------- #
    @property
    def draining(self) -> bool:
        """True while admission is closed (``drain()`` .. ``undrain()``)."""
        return self._draining

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

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, serve everything already accepted (generations
        included) and return True once idle; False if ``timeout`` passed
        first (the engine keeps draining; ``undrain()`` reopens)."""
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

    def undrain(self):
        """Reopen admission after a ``drain()``."""
        with self._lock:
            self._draining = False
            self._not_full.notify_all()
        return self

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


def _axis_size(mesh, axis):
    """Devices along ``axis`` of a mesh with a ``shape`` mapping, as JAX's
    ``Mesh`` has; any other mesh counts as several (refused)."""
    shape = getattr(mesh, "shape", None)
    return int(shape[axis]) if isinstance(shape, dict) else 2
