"""Single-device training orchestration (counterpart of
``bigdl_tpu/optim/local_optimizer.py``: ``BaseOptimizer`` :51,
``_run_driver_loop`` :643, ``LocalOptimizer`` :909, ``Optimizer`` :1029).

The host loop feeds batches and evaluates triggers; each step runs
``make_train_step`` on the model's device.  Staging runs one batch
ahead: while step k's kernels run, batch k+1 is fetched on the host,
pinned and copied to the card with ``non_blocking=True`` on a side
stream, and step k+1 waits for that copy only.  The end trigger is
evaluated once per completed step, and a batch past a predicted end is
never fetched.

Not ported yet (each raises or is absent): checkpoints, validation,
summaries beyond ``Loss``/``Throughput`` scalars, telemetry, the retry
loop, prefetch workers, ``distributed=True`` (ROADMAP A4) and
``strategy=`` (ROADMAP A7).
"""

import logging
import time

import numpy as np
import torch

from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.optim.train_step import make_train_step
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.device import resolve_device, same_device
from bigdl_tpu_torch.utils.random_generator import RNG

log = logging.getLogger("bigdl_tpu_torch.optim")

#: staging sentinel: the end trigger is PREDICTED to fire after this step
PREDICTED_END = object()


class _Stager:
    """Moves ``(input, target)`` numpy batches to the device.  On a CUDA
    device the copy goes from pinned memory on a side stream; ``wait``
    makes the compute stream wait for it before the step uses it."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def _move(self, x):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            return type(x)(self._move(e) for e in x)
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def stage(self, batch):
        if self.stream is None:
            return self._move(batch.tree()), None
        with torch.cuda.stream(self.stream):
            staged = self._move(batch.tree())
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return staged, ready

    def wait(self, staged, ready):
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            for t in _leaves(staged):
                t.record_stream(cur)     # freed only after the step's use
        return staged


def _leaves(x):
    if isinstance(x, (tuple, list)):
        for e in x:
            yield from _leaves(e)
    elif x is not None:
        yield x


class BaseOptimizer:
    """The optimizer's setters (``set_end_when``, gradient clipping, the
    compute dtype, a gradient transform, a train summary) and the loop
    state ``driver_state`` (``epoch``, ``neval``, ``record_count``) that
    the triggers read."""

    def __init__(self, model, dataset, criterion, optim_method=None,
                 device=None):
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if not same_device(self.device, model_device):
            raise ValueError(f"the optimizer runs on {self.device} but the "
                             f"model lies on {model_device}; build the model "
                             f"there or pass device={str(model_device)!r}")
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method = optim_method or SGD()
        self.end_trigger = Trigger.max_epoch(1)
        self.clip_value = None
        self.clip_norm = None
        self.compute_dtype = None
        self.grad_transform = None
        self.train_summary = None
        self.driver_state = {"epoch": 1, "neval": 1, "record_count": 0}

    def set_end_when(self, trigger):
        self.end_trigger = trigger
        return self

    def set_gradient_clipping_by_value(self, min_value, max_value):
        self.clip_value = (min_value, max_value)
        return self

    def set_gradient_clipping_by_l2_norm(self, max_norm):
        self.clip_norm = max_norm
        return self

    def set_compute_dtype(self, dtype):
        """Mixed precision: ``torch.bfloat16`` runs the forward and
        backward in bf16 on fp32 master parameters, with an fp32 loss
        and update (``make_train_step``)."""
        self.compute_dtype = dtype
        return self

    def set_grad_transform(self, fn):
        """A function of the ``{name: fp32 gradient}`` dict, applied in
        the step before freezing and clipping (custom scaling, fault
        injection)."""
        self.grad_transform = fn
        return self

    def set_train_summary(self, summary):
        """Any object with ``add_scalar(tag, value, step)``: it gets
        ``Loss`` and ``Throughput`` after every step."""
        self.train_summary = summary
        return self

    def optimize(self):
        return self._optimize_impl()

    def _log_progress(self, loss, throughput, data_wait_s):
        s = self.driver_state
        log.info("Epoch %d [iteration %d] loss %.6f, %.1f records/s "
                 "(data-wait %.1f ms)", s["epoch"], s["neval"], loss,
                 throughput, data_wait_s * 1e3)

    def _stage_next_batch(self, train_iter, state, n, epoch_size):
        """Fetch the next batch while the device runs the current step.
        Returns ``(next_batch, train_iter)``; ``next_batch`` is
        ``PREDICTED_END`` when the end trigger will fire after this step,
        and ``None`` (fetch after the trigger has decided) for triggers
        that cannot be probed with a predicted state."""
        if getattr(self.end_trigger, "stateful", False):
            return None, train_iter
        predicted = dict(state)
        predicted["neval"] = state["neval"] + 1
        predicted["record_count"] = state["record_count"] + n
        if predicted["record_count"] >= epoch_size:
            predicted["epoch"] = state["epoch"] + 1
        if self.end_trigger(predicted):
            return PREDICTED_END, train_iter
        return self._fetch(train_iter, state["record_count"] + n >=
                           epoch_size)

    def _fetch(self, train_iter, epoch_over):
        if epoch_over:
            self.dataset.shuffle()
            train_iter = self.dataset.data(train=True)
        try:
            return next(train_iter), train_iter
        except StopIteration:
            # a finite iterator shorter than size(): epoch boundary
            self.dataset.shuffle()
            train_iter = self.dataset.data(train=True)
            return next(train_iter), train_iter

    def _run_driver_loop(self, train_iter, first_batch, dispatch):
        """The driver loop: stage, dispatch, fetch and stage the next
        batch, sync the loss, update the driver state, evaluate the end
        trigger.  ``dispatch(staged) -> device loss``."""
        epoch_size = self.dataset.size()
        state = self.driver_state
        stager = _Stager(self.device)
        batch, dev = first_batch, None
        while not self.end_trigger(state):
            t0 = time.perf_counter()
            if batch is None:            # fetch deferred past the trigger;
                # a reset record count means the epoch just rolled over
                batch, train_iter = self._fetch(
                    train_iter, state["record_count"] == 0)
            if dev is None:
                dev = stager.stage(batch)
            data_wait = time.perf_counter() - t0
            loss_dev = dispatch(stager.wait(*dev))
            n = batch.size()
            t_fetch = time.perf_counter()
            next_batch, train_iter = self._stage_next_batch(
                train_iter, state, n, epoch_size)
            next_dev = None
            if next_batch is not None and next_batch is not PREDICTED_END:
                next_dev = stager.stage(next_batch)
            data_wait += time.perf_counter() - t_fetch
            loss = float(loss_dev)
            wall = time.perf_counter() - t0
            state["loss"] = loss
            state["record_count"] += n
            state["throughput"] = n / max(wall, 1e-9)
            self._log_progress(loss, state["throughput"], data_wait)
            if self.train_summary is not None:
                self.train_summary.add_scalar("Loss", loss, state["neval"])
                self.train_summary.add_scalar(
                    "Throughput", state["throughput"], state["neval"])
            state["neval"] += 1
            if state["record_count"] >= epoch_size:
                state["epoch"] += 1
                state["record_count"] = 0
            batch = None if next_batch is PREDICTED_END else next_batch
            dev = next_dev


class LocalOptimizer(BaseOptimizer):
    """Training on one device.  Starts from ``optim_method.state`` when it
    is set (for example by ``interop.load_jax_opt_state``), else from
    ``init_state``, and leaves the final state there."""

    def _optimize_impl(self):
        train_iter = self.dataset.data(train=True)
        first_batch = next(train_iter)
        params = dict(self.model.named_parameters())
        opt_state = self.optim_method.state
        if opt_state is None:
            opt_state = self.optim_method.init_state(params)
        step = make_train_step(self.model, self.criterion, self.optim_method,
                               clip_value=self.clip_value,
                               clip_norm=self.clip_norm,
                               compute_dtype=self.compute_dtype,
                               grad_transform=self.grad_transform)

        def dispatch(staged):
            nonlocal opt_state
            x, target = staged
            opt_state, loss = step(opt_state, x, target,
                                   RNG.next_generator())
            return loss

        self._run_driver_loop(train_iter, first_batch, dispatch)
        self.optim_method.state = opt_state
        return self.model


class Optimizer:
    """Factory: ``Optimizer(model, dataset, criterion, optim_method,
    device=None)`` is a ``LocalOptimizer`` on the card (``device=None``)
    or on the device asked for.  The distributed and model-parallel
    routes are not ported yet."""

    def __new__(cls, model=None, dataset=None, criterion=None,
                optim_method=None, distributed=None, strategy=None,
                device=None, **strategy_kw):
        if distributed:
            raise NotImplementedError(
                "distributed=True: DistriOptimizer is not ported yet "
                "(ROADMAP A4)")
        if strategy is not None or strategy_kw:
            raise NotImplementedError(
                f"strategy={strategy!r}: the model-parallel engines are not "
                f"ported yet (ROADMAP A7)")
        return LocalOptimizer(model, dataset, criterion, optim_method,
                              device=device)
