"""Single-device training orchestration (counterpart of
``bigdl_tpu/optim/local_optimizer.py``: ``BaseOptimizer`` :51,
``_run_driver_loop`` :643, ``LocalOptimizer`` :909, ``Optimizer`` :1029).

The host loop feeds batches and evaluates triggers; each step runs
through ``CompiledTrainStep`` (``optim/graphs.py``), on the card one CUDA
graph per batch shape, the counterpart of the JAX loop's
``jax.jit(make_train_step(...))``.  Staging runs one batch ahead: while
step k runs, batch k+1 is fetched on the host, pinned and copied to the
card with ``non_blocking=True`` on a side stream; step k+1 waits for
that copy only, and moves the batch into the graph's static buffers with
a device-to-device copy on the compute stream.  The loss is read every
``sync_every``-th step (``set_sync_every``): between syncs the host
dispatches ahead of the device.  A step's loss is the graph's static
loss, which the next replay overwrites; the loop reads a loss only at a
sync point or at the end of the run, each time before it dispatches
another step, so no copy of it is kept.  The end trigger is evaluated
once per completed step, and a batch past a predicted end is never
fetched.

Not ported yet (each raises or is absent): checkpoints, validation (and
so the feed of a ``Plateau`` schedule), summaries beyond ``Loss``,
``Throughput`` and ``LearningRate`` scalars, telemetry, the retry loop,
prefetch workers, ``distributed=True`` (ROADMAP A4) and ``strategy=``
(ROADMAP A7).
"""

import logging
import time

import numpy as np
import torch

from bigdl_tpu_torch.optim.graphs import CompiledTrainStep
from bigdl_tpu_torch.optim.optim_method import SGD, build_composite_method
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.device import resolve_device, same_device
from bigdl_tpu_torch.utils.errors import ConfigurationError
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
    compute dtype, a gradient transform, per-submodule methods, the sync
    cadence, a train summary) and the loop state ``driver_state``
    (``epoch``, ``neval``, ``record_count``) that the triggers read."""

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
        self.sync_every = 1
        self._optim_methods_map = None
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
        ``Loss``, ``Throughput`` and ``LearningRate`` (one
        ``LearningRate/<name>`` per submodule of ``set_optim_methods``)
        after every step.  Reading the rate syncs every step."""
        self.train_summary = summary
        return self

    def set_sync_every(self, k):
        """Read the device loss only every ``k``-th step (default 1, the
        per-step sync).  With ``k > 1`` the host keeps dispatching ahead
        of the device; the loss in logs and summaries is then fresh only
        at sync points (the progress line says how many steps old it
        is).  An end trigger that reads step outputs (``min_loss``,
        ``max_score``) forces ``k = 1``."""
        if int(k) < 1:
            raise ConfigurationError(f"sync_every must be >= 1, got {k}")
        self.sync_every = int(k)
        return self

    def set_optim_methods(self, methods):
        """One method per named submodule (reference
        Optimizer.setOptimMethods): ``{module name: OptimMethod}``,
        resolved against the model at ``optimize()`` by
        ``build_composite_method``.  Together the subtrees must cover
        every trainable parameter."""
        self._optim_methods_map = dict(methods)
        return self

    def _resolve_optim_methods(self, params):
        if not self._optim_methods_map:
            return
        sched = getattr(self.optim_method, "schedule", None)
        if sched is not None and hasattr(sched, "record"):
            raise ConfigurationError(
                "set_optim_methods replaces the constructor's "
                "optim_method, whose Plateau-style schedule would "
                "silently never fire; drop one of the two")
        self.optim_method = build_composite_method(
            self.model, params, self._optim_methods_map)
        self._optim_methods_map = None      # resolved once, kept

    def optimize(self):
        return self._optimize_impl()

    def _log_progress(self, loss, throughput, data_wait_s, sync_skew=0):
        s = self.driver_state
        shown = "%.6f" % loss
        if sync_skew:   # deferred sync: the loss is sync_skew steps old
            shown += " [%d-step-old sync]" % sync_skew
        log.info("Epoch %d [iteration %d] loss %s, %.1f records/s "
                 "(data-wait %.1f ms)", s["epoch"], s["neval"], shown,
                 throughput, data_wait_s * 1e3)

    def _log_learning_rates(self, opt_state, state):
        """``LearningRate`` summary scalars: one per submodule for a
        composite method, a single scalar otherwise."""
        rates = getattr(self.optim_method, "learning_rates", None)
        if rates is not None:
            for name, lr in rates(opt_state).items():
                self.train_summary.add_scalar(
                    f"LearningRate/{name}", float(lr), state["neval"])
        else:
            self.train_summary.add_scalar(
                "LearningRate",
                float(self.optim_method.get_learning_rate(opt_state)),
                state["neval"])

    def _effective_sync_every(self):
        """``sync_every``, or 1 when the end trigger reads step outputs
        (``min_loss``/``max_score``), which a deferred sync would leave
        stale."""
        k = max(1, int(self.sync_every))
        if k > 1 and getattr(self.end_trigger, "uses_outputs", False):
            log.info("sync_every=%d forced to 1: a configured trigger "
                     "reads step outputs (loss/score) every step", k)
            return 1
        return k

    def _stage_next_batch(self, train_iter, state, n, epoch_size):
        """Fetch the next batch while the device runs the current step.
        Returns ``(next_batch, train_iter)``; ``next_batch`` is
        ``PREDICTED_END`` when the end trigger will fire after this step,
        and ``None`` (fetch after the trigger has decided) for triggers
        that cannot be probed with a predicted state (stateful ones, and
        those that read the step's loss or score)."""
        if getattr(self.end_trigger, "stateful", False) or \
                getattr(self.end_trigger, "uses_outputs", False):
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

    def _run_driver_loop(self, train_iter, first_batch, dispatch,
                         extra_summaries=None):
        """The driver loop: stage, dispatch, fetch and stage the next
        batch, sync the loss every ``sync_every``-th step, update the
        driver state, evaluate the end trigger.  ``dispatch(staged) ->
        device loss``; ``extra_summaries(state)`` adds train-summary
        scalars after ``Loss`` and ``Throughput``."""
        epoch_size = self.dataset.size()
        state = self.driver_state
        stager = _Stager(self.device)
        sync_every = self._effective_sync_every()
        loss = float("nan")          # the last synced loss
        # primed so the FIRST step syncs: every published loss is a real
        # (at worst stale) value
        sync_skew = sync_every - 1   # steps since the last loss sync
        loss_dev = None
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
            if sync_skew + 1 >= sync_every:
                loss = float(loss_dev)
                sync_skew = 0
            else:
                sync_skew += 1           # deferred: the host runs ahead
            wall = time.perf_counter() - t0
            state["loss"] = loss
            state["record_count"] += n
            state["throughput"] = n / max(wall, 1e-9)
            self._log_progress(loss, state["throughput"], data_wait,
                               sync_skew)
            if self.train_summary is not None:
                self.train_summary.add_scalar("Loss", loss, state["neval"])
                self.train_summary.add_scalar(
                    "Throughput", state["throughput"], state["neval"])
                if extra_summaries is not None:
                    extra_summaries(state)
            state["neval"] += 1
            if state["record_count"] >= epoch_size:
                state["epoch"] += 1
                state["record_count"] = 0
            batch = None if next_batch is PREDICTED_END else next_batch
            dev = next_dev
        if sync_skew and loss_dev is not None:
            # drain: the run's last loss lands in the driver state even
            # when the last steps deferred their sync
            state["loss"] = float(loss_dev)


class LocalOptimizer(BaseOptimizer):
    """Training on one device.  Starts from ``optim_method.state`` when it
    is set (for example by ``interop.load_jax_opt_state``), else from
    ``init_state``, and leaves the final state there.  Each ``optimize()``
    builds its compiled step anew, as the JAX loop jits a fresh
    ``make_train_step`` in each: what the step reads when it is built
    (frozen modules, regularizers, the method's settings) is read again,
    and the step's graphs and their pool are freed when the call
    returns."""

    #: ``CompiledTrainStep.stats()`` of the last ``optimize()`` (None
    #: before it): keys built, steps run, the graph pool's bytes
    compiled_stats = None

    def _compiled_step(self, opt_state):
        return CompiledTrainStep(
            self.model, self.criterion, self.optim_method, opt_state,
            self.device, clip_value=self.clip_value,
            clip_norm=self.clip_norm, compute_dtype=self.compute_dtype,
            grad_transform=self.grad_transform)

    def _optimize_impl(self):
        train_iter = self.dataset.data(train=True)
        first_batch = next(train_iter)
        params = dict(self.model.named_parameters())
        self._resolve_optim_methods(params)
        opt_state = self.optim_method.state
        if opt_state is None:
            opt_state = self.optim_method.init_state(params)
        step = self._compiled_step(opt_state)

        def dispatch(staged):
            x, target = staged
            RNG.next_generator()          # the step's stream position
            return step.run(x, target)

        try:
            self._run_driver_loop(
                train_iter, first_batch, dispatch,
                extra_summaries=lambda state: self._log_learning_rates(
                    opt_state, state))
        finally:
            self.compiled_stats = step.stats()
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
