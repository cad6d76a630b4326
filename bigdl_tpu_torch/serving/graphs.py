"""Generation steps built once per shape and replayed: the port's
counterpart of the JAX engine's ``jax.jit(step, donate_argnums=...)``
executables (``bigdl_tpu/serving/generation.py:129, 851, 1312``) and of
``observability.watchdogs.backend_compile_count``.

A ``StepGraphs`` belongs to one scheduler and holds, per shape key (for
example ``("decode", 8, "greedy")`` or ``("chunk", 4, 64, "sampled")``):

- the step's static inputs (``StepInputs``): named views of one flat
  4-byte device buffer, allocated before any capture and outside the
  graph pool, filled by ONE host-to-device copy a tick from one pinned
  host buffer;
- on the card, the CUDA graph of the step and its static outputs (the
  drawn tokens and the logits they were drawn from), every graph of the
  scheduler in one graph pool;
- the launch counts of ``ops.flash_attention`` that one run of the step
  makes, recorded at capture and added at every replay (the wrappers
  count in Python, which a replay does not run).

A step is built against the scheduler's LIVE pool, whose tensors must
therefore never be reallocated (the schedulers zero them in place).
Before its capture it runs ``WARMUP_RUNS`` times on the capture stream
with its inputs at the caller's idle values, which put every row on the
trash block or trash row.  Capture, warm-up, the graph pool and the
launch records are ``utils/cuda_graphs.py``'s, shared with the compiled
training step.

On the CPU, which serves only when the caller asks for it, nothing can be
captured: a key is built by allocating its static inputs, and each run
calls the step on them.  The counts (``captured``, ``replays``) keep
their meaning, shapes built and steps run, so the closed-shape-set
checks hold on both devices.
"""

import contextlib

import numpy as np
import torch

from bigdl_tpu_torch.utils.cuda_graphs import (WARMUP_RUNS, Capturer,
                                               capture_count, note_capture)

__all__ = ["WARMUP_RUNS", "StepGraphs", "StepInputs", "capture_count"]


class StepInputs:
    """The static inputs of one step shape: ``dev[name]`` are views of one
    flat device buffer, ``host[name]`` numpy views of the pinned host
    buffer it is copied from.  ``layout`` lists ``(name, shape, dtype)``
    with ``np.int32`` or ``np.float32``."""

    def __init__(self, layout, device):
        device = torch.device(device)
        size = sum(int(np.prod(shape)) for _, shape, _ in layout)
        self._host = torch.zeros(size, dtype=torch.int32,
                                 pin_memory=device.type == "cuda")
        self._flat = torch.zeros(size, dtype=torch.int32, device=device)
        flat_host = self._host.numpy()
        self.host, self.dev = {}, {}
        at = 0
        for name, shape, dtype in layout:
            n = int(np.prod(shape))
            self.host[name] = flat_host[at:at + n].view(dtype).reshape(shape)
            view = self._flat[at:at + n]
            if dtype == np.float32:
                view = view.view(torch.float32)
            self.dev[name] = view.view(shape)
            at += n

    def set(self, **values):
        """Write host arrays (or scalars, broadcast) into the staging
        buffer; ``upload`` moves them to the device."""
        for name, value in values.items():
            self.host[name][...] = value

    def upload(self):
        """The one host-to-device copy of a tick.  The staging buffer is
        rewritten only after the tick's tokens came back, which orders
        after this copy on the same stream."""
        self._flat.copy_(self._host, non_blocking=True)


class _Step:
    __slots__ = ("fn", "inputs", "graph", "outputs", "launches")

    def __init__(self, fn, inputs, graph=None, outputs=None, launches=None):
        self.fn = fn
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.launches = launches


class StepGraphs:
    """The built generation steps of one scheduler (module docstring).
    Only one thread at a time may build or run steps: the scheduler's
    dispatcher, or ``precompile()`` holding the scheduler's step lock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self._inputs = {}
        self._steps = {}
        self._capturer = Capturer(self.device) if self.on_card else None
        self._warming = False
        #: shapes built in all, built outside ``precompile()``, and runs
        self.captured = 0
        self.captured_after_precompile = 0
        self.replays = 0
        #: device memory the captures reserved (on the card; the engine's
        #: memory ledger reads it)
        self.pool_bytes = 0

    def stats(self):
        return {"captured": self.captured,
                "captured_after_precompile": self.captured_after_precompile,
                "replays": self.replays}

    @contextlib.contextmanager
    def precompiling(self):
        """Builds inside the block are ``precompile()``'s; every other
        build counts in ``captured_after_precompile``."""
        self._warming = True
        try:
            yield
        finally:
            self._warming = False

    def inputs(self, key, layout) -> StepInputs:
        """The static inputs of shape ``key``, allocated at first use."""
        inp = self._inputs.get(key)
        if inp is None:
            inp = self._inputs[key] = StepInputs(layout, self.device)
        return inp

    def ensure(self, key, fn, inputs, idle):
        """Build step ``key`` unless it exists: ``fn()`` runs the step on
        ``inputs.dev`` (and the scheduler's live pool) and returns its
        device outputs, ``(tokens, logits)``.  On the card ``inputs`` are
        first set to ``idle`` (a dict of values that put every row on the
        trash block or row).  A capture that raises propagates: nothing
        is served eagerly in its place."""
        if key in self._steps:
            return
        if self.on_card:
            inputs.set(**idle)
            inputs.upload()
            step = self._capture(fn, inputs)
        else:
            step = _Step(fn, inputs)
        if not self.on_card:
            note_capture()
        self._steps[key] = step
        self.captured += 1
        if not self._warming:
            self.captured_after_precompile += 1

    def _capture(self, fn, inputs):
        self._capturer.warm_up(fn)
        reserved = torch.cuda.memory_reserved(self.device)
        graph, outputs, rec = self._capturer.capture(fn)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        return _Step(fn, inputs, graph, outputs, rec)

    def step(self, key) -> _Step:
        return self._steps[key]

    def run(self, key):
        """Run step ``key`` on its static inputs as they stand on the
        device (after ``StepInputs.upload``) and return its outputs: on
        the card the graph's static output tensors, read them before the
        next replay of the same key."""
        step = self._steps[key]
        self.replays += 1
        if step.graph is None:
            return step.fn()
        Capturer.replay(step.graph, step.launches)
        return step.outputs
