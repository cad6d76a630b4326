"""The compiled training step: the port's counterpart of
``jax.jit(make_train_step(...), donate_argnums=(0, 1, 2))``
(``bigdl_tpu/optim/local_optimizer.py:930-934``).

``CompiledTrainStep`` builds the eager ``make_train_step`` once and keeps,
per key (the input's shape and dtype and the target's), static input and
target buffers, allocated outside the graph pool.  On the card the key's
first step

1. copies the batch into the static buffers;
2. runs ``WARMUP_RUNS`` eager steps on the capture stream (libraries,
   cuBLAS's workspace and the stream's allocator blocks come into being
   there) on the live parameters and state, saved to pinned host memory
   before and restored after, so the warm-up leaves the run as it found
   it and costs no device memory beyond an eager step's;
3. releases the allocator's cached blocks to the device, and captures one
   step -- forward, criterion, backward, ``grad_transform``, freezing,
   clipping and the update -- into one CUDA graph in the step's graph
   pool (``utils/cuda_graphs.py``): the gradients are set to ``None``
   first, so the backward allocates them in the pool, which keeps every
   intermediate of the step reserved for as long as the graph lives
   (``stats()["pool_bytes"]``: the device memory reserved by the
   captures);
4. replays it.

Every later step of the key is one device-to-device copy of each buffer
and one replay, which returns the graph's static loss (overwritten by the
next replay).  The update reads nothing from the host (``optim_method``:
``neval``, the rate and the schedules' tables live on the device), and a
step that does -- a ``grad_transform`` that calls ``.item()`` -- fails its
capture and raises: nothing trains eagerly in its place.  So does a
capture while an earlier autograd graph of the model is alive (a loss
kept from an eager forward on another stream): its gradient accumulators
stay bound to that forward's stream.  A short last batch of an epoch is
a second key, in the same pool (JAX recompiles there too).

On the CPU nothing is captured: a key allocates its static buffers and
each step runs the eager step on them, so the keys, buffers and counts
(``stats()``) are the card's.
"""

import torch

from bigdl_tpu_torch.optim.train_step import make_train_step
from bigdl_tpu_torch.utils.cuda_graphs import Capturer, note_capture


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class _Key:
    __slots__ = ("input", "target", "graph", "loss", "launches",
                 "pool_bytes")

    def __init__(self, input, target):
        self.input = input
        self.target = target
        self.graph = self.loss = self.launches = None
        self.pool_bytes = 0


class CompiledTrainStep:
    """``run(input, target) -> loss``: one training step of ``model`` on
    the batch, the update written into ``model``'s parameters and
    ``opt_state`` in place (module docstring).  ``step_kw`` are
    ``make_train_step``'s options (clipping, ``compute_dtype``,
    ``grad_transform``).

    ``step_fn`` replaces ``make_train_step``'s step by another of its
    signature, ``step_fn(opt_state, input, target) -> (opt_state,
    loss)``, whose ``live`` attribute lists the tensors it writes beyond
    the model's and ``opt_state``'s (the data-parallel step,
    ``optim/distri_optimizer.py``).  ``capture=False`` runs every step
    eagerly on the static buffers, on the card too (a step whose
    collectives a graph cannot capture)."""

    def __init__(self, model, criterion, optim_method, opt_state, device,
                 step_fn=None, capture=True, **step_kw):
        self.model = model
        self.opt_state = opt_state
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.step_fn = step_fn or make_train_step(model, criterion,
                                                  optim_method, **step_kw)
        self._capturer = Capturer(self.device) \
            if self.on_card and capture else None
        self._keys = {}
        #: keys built (on the card: graphs captured) and steps run
        self.captured = 0
        self.replays = 0

    def stats(self):
        return {"captured": self.captured, "replays": self.replays,
                "keys": list(self._keys),
                "pool_bytes": sum(k.pool_bytes for k in self._keys.values()),
                "warmup_launches": self._capturer.warmup_launches
                if self._capturer is not None else {}}

    @staticmethod
    def key_of(input, target):
        return (tuple(input.shape), input.dtype,
                None if target is None else tuple(target.shape),
                None if target is None else target.dtype)

    def run(self, input, target):
        key = self.key_of(input, target)
        k = self._keys.get(key)
        if k is None:
            k = self._build(key, input, target)
        else:
            k.input.copy_(input, non_blocking=True)
            if target is not None:
                k.target.copy_(target, non_blocking=True)
        self.replays += 1
        if k.graph is None:
            return self._eager(k)
        Capturer.replay(k.graph, k.launches)
        return k.loss

    def _eager(self, k):
        return self.step_fn(self.opt_state, k.input, k.target)[1]

    def _build(self, key, input, target):
        k = _Key(input.clone(), None if target is None else target.clone())
        if self._capturer is not None:
            self._capture(k)
        else:
            note_capture()
        self._keys[key] = k
        self.captured += 1
        return k

    def _live(self):
        """Everything a step writes: parameters, buffers, state tensors
        and the dropout key."""
        key = self.step_fn.dropout_key
        return [*self.model.parameters(), *self.model.buffers(),
                *_tensors(self.opt_state), *([] if key is None else [key]),
                *getattr(self.step_fn, "live", ())]

    def _capture(self, k):
        live = self._live()
        with torch.no_grad():
            saved = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in live]
        try:
            self._capturer.warm_up(lambda: self._eager(k))
        finally:
            with torch.no_grad():
                for t, s in zip(live, saved):
                    t.copy_(s, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            del saved
            self.model.zero_grad(set_to_none=True)
        self._capturer.free_cached()
        reserved = torch.cuda.memory_reserved(self.device)
        try:
            k.graph, k.loss, k.launches = self._capturer.capture(
                lambda: self._eager(k))
            k.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        finally:
            # the gradients live in the pool, where the graph writes them
            # at every replay: no reference outside it
            self.model.zero_grad(set_to_none=True)
