"""Single-device training orchestration (counterpart of
``bigdl_tpu/optim/local_optimizer.py``: ``BaseOptimizer`` :51,
``_run_driver_loop`` :643, ``LocalOptimizer`` :909, ``validate`` :1010,
``Optimizer`` :1029).

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

Module state (BatchNorm's running statistics, the model's buffers) is
updated in place by the step, in the graph on the card, and travels with
the parameters through checkpoints and resume (``model_state``, JAX's
``model.state()`` tree).

Validation (``set_validation``) runs ``validate`` through the compiled
eval step (``optim/validation.py``, one CUDA graph per batch shape on
the card, reading the live parameters) and feeds a ``Plateau``
schedule's monitored value into the state's ``lr_factor``.  Checkpoints
(``set_checkpoint``) hold the parameters, the optimizer state and the
driver state (with the random stream's and the dataset's mid-epoch
position) in the JAX package's format and keys (``utils/file_io.py``,
``interop.to_jax_params``), so either package resumes the other's.  A
validation or checkpoint firing syncs the loss first, and a checkpoint
syncs the compute stream before it reads the device state.
``resume_from_checkpoint`` copies a snapshot into the model's
parameters and the optimizer state in place, before the step is built.
``optimize()`` retries a failed run from the newest intact checkpoint,
at most ``BIGDL_FAILURE_RETRY_TIMES`` times.

Summaries (``set_train_summary``, a ``visualization.TrainSummary`` or
any object with ``add_scalar``) get each step's event (``Loss``,
``Throughput``, ``DataWaitSeconds``), the learning rates and, where the
summary's ``"Parameters"`` trigger fires, a histogram of every
parameter.  A prefetching dataset (``dataset.prefetch()``) adds its queue
occupancy to each step's event, and its threads are shut down when
``optimize()`` returns or raises.

``Optimizer(..., distributed=True)`` is the data-parallel
``DistriOptimizer`` (``optim/distri_optimizer.py``), which shares this
loop.

Not ported yet (each raises or is absent): sharded (orbax) checkpoints
(refused, as JAX's ``LocalOptimizer`` refuses them), telemetry and
health monitoring (ROADMAP A8); ``strategy=`` routes to
``optim/strategy_optimizer.py`` (tp, sp, ep, pp).
"""

import gc
import logging
import time

import numpy as np
import torch

from bigdl_tpu_torch.optim.graphs import CompiledTrainStep
from bigdl_tpu_torch.optim.optim_method import SGD, build_composite_method
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils import config, file_io
from bigdl_tpu_torch.utils.device import resolve_device, same_device
from bigdl_tpu_torch.utils.errors import (CheckpointCorruptionError,
                                          ConfigurationError,
                                          TrainingHaltedError,
                                          UnsupportedFeatureError)
from bigdl_tpu_torch.utils.random_generator import RNG

log = logging.getLogger("bigdl_tpu_torch.optim")

#: staging sentinel: the end trigger is PREDICTED to fire after this step
PREDICTED_END = object()


def _to_device(x, device, pinned=False):
    """A host batch leaf (or a tuple of them) as tensors on ``device``;
    ``pinned``: copied from pinned memory without waiting."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(e, device, pinned) for e in x)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if pinned:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Stager:
    """Moves ``(input, target)`` numpy batches to the device (``select``,
    when given, picks what of the batch's tree is moved: a data-parallel
    rank's rows).  On a CUDA device the copy goes from pinned memory on a
    side stream; ``wait`` makes the compute stream wait for it before the
    step uses it."""

    def __init__(self, device, select=None):
        self.device = device
        self.select = select
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def stage(self, batch):
        tree = batch.tree()
        if self.select is not None:
            tree = self.select(tree)
        if self.stream is None:
            return _to_device(tree, self.device), None
        with torch.cuda.stream(self.stream):
            staged = _to_device(tree, self.device, pinned=True)
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
    """The optimizer's setters (``set_end_when``, validation,
    checkpoints, gradient clipping, the compute dtype, a gradient
    transform, per-submodule methods, the sync cadence, train and
    validation summaries), resume and the retry loop, and the loop state
    ``driver_state`` (``epoch``, ``neval``, ``record_count``,
    ``batches_consumed``, and the validation results by method name)
    that the triggers read."""

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
        self.validation_trigger = None
        self.validation_dataset = None
        self.validation_methods = []
        self.checkpoint_path = None
        self.checkpoint_trigger = None
        self.validation_summary = None
        self.clip_value = None
        self.clip_norm = None
        self.compute_dtype = None
        self.grad_transform = None
        self.train_summary = None
        self.sync_every = 1
        self._optim_methods_map = None
        self.driver_state = {"epoch": 1, "neval": 1, "record_count": 0,
                             "batches_consumed": 0}
        #: the snapshot ``resume_from_checkpoint`` resolved (loaded by
        #: every later ``optimize()``, as in JAX) and the mid-epoch
        #: dataset position it carried (consumed by the next run)
        self._resume = None
        self._resume_position = None
        self._reshuffle_pending = False

    def set_end_when(self, trigger):
        self.end_trigger = trigger
        return self

    def set_validation(self, trigger, dataset, methods):
        """Run ``methods`` (``optim.validation``) over ``dataset``'s
        ``data(train=False)`` batches whenever ``trigger`` fires; each
        result lands in ``driver_state`` under the method's name (and
        ``"score"`` for the accuracies), where a ``Plateau`` schedule's
        monitor reads it."""
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = methods
        return self

    def set_checkpoint(self, path, trigger):
        """Write ``checkpoint.<neval>.pkl`` (and its manifest) under
        ``path`` whenever ``trigger`` fires."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def set_sharded_checkpoint(self, path, trigger):
        """Refused: one device keeps the whole model on one host; sharded
        (orbax) snapshots are for the distributed layouts."""
        raise UnsupportedFeatureError(
            f"{type(self).__name__} keeps whole-model state on one "
            "host; use set_checkpoint (sharded snapshots are for the "
            "distributed layouts)")

    def set_validation_summary(self, summary):
        """Any object with ``add_scalar(tag, value, step)``: it gets each
        validation method's value under the method's name."""
        self.validation_summary = summary
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
        """A ``visualization.TrainSummary``, or any object with
        ``add_scalar(tag, value, step)``: after every step it gets the
        step event (``add_step_event``: ``Loss``, ``Throughput``,
        ``DataWaitSeconds``; plain ``Loss`` and ``Throughput`` scalars
        without that method) and ``LearningRate`` (one
        ``LearningRate/<name>`` per submodule of ``set_optim_methods``),
        and, where its ``"Parameters"`` summary trigger fires, a
        histogram of every parameter.  Reading the rate syncs every
        step."""
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

    def resume_from_checkpoint(self, path=None):
        """Resolve the newest intact snapshot under ``path`` (default: the
        checkpoint path); the next ``optimize()`` loads it.  Snapshots
        that fail verification, or verify but do not load, are
        quarantined and the next one is tried; an empty directory is a
        fresh start, a directory whose every snapshot failed raises
        ``CheckpointCorruptionError`` listing them."""
        base = path or self.checkpoint_path
        if base is None:
            raise ConfigurationError(
                "no checkpoint path: call set_checkpoint first or pass "
                "path=")
        snap, quarantined = None, []
        while True:
            intact, q = file_io.scan_checkpoints(base)
            quarantined.extend(q)
            if not intact:
                break
            ckpt_file = intact[0]
            try:
                snap = file_io.load(ckpt_file)
                break
            except Exception:
                log.exception("snapshot %s verified but failed to load",
                              ckpt_file)
                quarantined.extend(file_io.quarantine_snapshot(ckpt_file))
        if snap is None:
            if quarantined:
                raise CheckpointCorruptionError(
                    f"every snapshot under {base} failed verification; "
                    f"quarantined: {quarantined} -- a fresh start here "
                    "would silently discard the run (move the *.corrupt "
                    "files away to force one)")
            return self
        self._resume = snap
        self._resume_path = ckpt_file
        ds = snap["driver_state"]
        log.info("Resuming from %s (epoch %s, neval %s)", ckpt_file,
                 ds.get("epoch"), ds.get("neval"))
        return self

    def _apply_driver_state(self, snap_state):
        """Restore the loop counters, the random stream's position and
        the mid-epoch dataset position (consumed by
        ``_resume_data_stream``).  The snapshot's scalars come back as
        0-d arrays: they become Python numbers again."""
        d = dict(snap_state)
        rng_state = d.pop("rng_state", None)
        self._resume_position = d.pop("data_position", None)
        for k, v in d.items():
            if isinstance(v, (np.ndarray, np.generic)) and \
                    getattr(v, "ndim", 1) == 0:
                d[k] = v.item()
        self.driver_state.update(d)
        if rng_state is not None:
            RNG.set_state(rng_state)

    def _resume_data_stream(self, train_iter, first_batch):
        """After a resume: put the dataset back at the snapshot's
        mid-epoch position and fast-forward a fresh iterator past the
        batches the checkpointed steps consumed, so the resumed sample
        stream is the uninterrupted run's.  A no-op without a restored
        position; the pre-resume ``first_batch`` is dropped."""
        pos, self._resume_position = self._resume_position, None
        if pos is None:
            return train_iter, first_batch
        consumed = int(pos.get("batches_consumed", 0))
        ds_state = pos.get("dataset")
        if ds_state is None:
            if consumed or pos.get("reshuffle_pending"):
                log.warning(
                    "snapshot carries a mid-epoch position (%d batches "
                    "into epoch %d) but %s exposes no position_state(); "
                    "resuming from the top of the epoch -- the resumed "
                    "sample stream will NOT match the uninterrupted run",
                    consumed, self.driver_state.get("epoch", 1),
                    type(self.dataset).__name__)
            return train_iter, first_batch
        self.dataset.restore_position(ds_state)
        if pos.get("reshuffle_pending"):
            self.dataset.shuffle()
        train_iter = self.dataset.data(train=True)
        for i in range(consumed):
            try:
                next(train_iter)
            except StopIteration:
                raise CheckpointCorruptionError(
                    f"dataset exhausted {i}/{consumed} batches into the "
                    "mid-epoch fast-forward: the snapshot's position does "
                    "not fit this dataset (changed size or batch "
                    "shape?)") from None
        log.info("resumed dataset position: epoch %d, fast-forwarded %d "
                 "consumed batches", self.driver_state.get("epoch", 1),
                 consumed)
        return train_iter, next(train_iter)

    def _capture_data_position(self):
        """The mid-epoch position stamped into every snapshot: batches
        consumed by completed steps this epoch, whether an epoch-boundary
        reshuffle is pending, and the dataset's own state (None where it
        has none)."""
        pos_fn = getattr(self.dataset, "position_state", None)
        return {
            "batches_consumed": int(
                self.driver_state.get("batches_consumed", 0)),
            "reshuffle_pending": bool(self._reshuffle_pending),
            "dataset": pos_fn() if callable(pos_fn) else None,
        }

    def _check_plateau_monitor(self):
        """Fail before the retry loop on a ``Plateau`` monitor that the
        validation methods can never produce (a retry would replay it)."""
        sched = getattr(self.optim_method, "schedule", None)
        if (sched is None or not hasattr(sched, "record")
                or self.validation_trigger is None):
            return
        monitor = getattr(sched, "monitor", "score")
        available = [m.name for m in self.validation_methods]
        if any(n in ("Top1Accuracy", "Top5Accuracy") for n in available):
            available.append("score")
        available.append("loss")      # the training loss is always there
        if monitor not in available:
            raise ValueError(
                f"Plateau schedule requires monitored value {monitor!r}, "
                f"which the validation methods will never produce "
                f"(available: {available})")

    def _feed_plateau(self, state, opt_state):
        """Feed the monitored value to a ``Plateau`` schedule, which
        writes the state's ``lr_factor`` in place.  Only the named
        monitor is fed; where this interval produced none, the factor
        stays."""
        sched = getattr(self.optim_method, "schedule", None)
        if sched is None or not hasattr(sched, "record"):
            return opt_state
        monitor = getattr(sched, "monitor", "score")
        value = state.get(monitor)
        if value is None:
            log.warning(
                "Plateau schedule: monitored value %r absent this "
                "validation interval; LR factor unchanged", monitor)
            return opt_state
        return sched.record(value, opt_state)

    def _record_validation(self, results, state):
        """Log each result and record it in the driver state under the
        method's name (``"score"`` also takes an accuracy)."""
        for method, res in zip(self.validation_methods, results):
            if res is None:
                log.warning(
                    "validation dataset produced no full batches; skipping "
                    "%s (reduce batch size or grow the validation split)",
                    method.name)
                continue
            value, _ = res.result()
            log.info("Validation %s: %s", method.name, res)
            state[method.name] = value
            if method.name in ("Top1Accuracy", "Top5Accuracy"):
                state["score"] = value
            if self.validation_summary is not None:
                self.validation_summary.add_scalar(
                    method.name, value, state["neval"])
        return results

    def optimize(self):
        """Train, with the reference's failure-retry semantics: on an
        exception, resume from the newest intact checkpoint and go on, at
        most ``BIGDL_FAILURE_RETRY_TIMES`` times.  Configuration and
        capability errors, and a halt, are raised at once.  A prefetching
        dataset's threads are shut down however it ends."""
        self._check_plateau_monitor()
        retries_left = config.failure_retry_times()
        try:
            while True:
                try:
                    return self._optimize_impl()
                except KeyboardInterrupt:
                    raise
                except (ConfigurationError, UnsupportedFeatureError,
                        TrainingHaltedError):
                    raise
                except Exception:
                    if retries_left <= 0 or self.checkpoint_path is None:
                        raise
                    retries_left -= 1
                    log.exception(
                        "training failed; restoring last checkpoint and "
                        "retrying (%d retries left)", retries_left)
                # the failed run's compiled step (its graphs and their pool)
                # goes before the next one is built
                gc.collect()
                self.resume_from_checkpoint()
        finally:
            shutdown = getattr(self.dataset, "shutdown", None)
            if callable(shutdown):
                shutdown()       # no prefetch thread outlives the run

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

    def _histograms(self, state):
        """``Parameters`` histograms where the summary's trigger fires
        (reference: AbstractOptimizer.saveSummary; JAX :597-612), tagged
        like JAX's ``keystr`` paths (``Parameters['0']['weight']``).  The
        parameters are read to the host only then."""
        getter = getattr(self.train_summary, "get_summary_trigger", None)
        trig = getter("Parameters") if getter is not None else None
        if trig is None or not trig(state):
            return
        from bigdl_tpu_torch.interop.jax_params import to_jax_params

        for path, leaf in _tree_leaves(to_jax_params(self.model)):
            self.train_summary.add_histogram(
                "Parameters" + "".join(f"[{k!r}]" for k in path), leaf,
                state["neval"])

    def _effective_sync_every(self):
        """``sync_every``, or 1 when a configured trigger reads step
        outputs (``min_loss``/``max_score``), which a deferred sync would
        leave stale.  Count-based validation and checkpoint triggers keep
        the cadence: their firings sync the loss on the spot."""
        k = max(1, int(self.sync_every))
        if k == 1:
            return 1
        for t in (self.end_trigger, self.validation_trigger,
                  self.checkpoint_trigger):
            if t is not None and getattr(t, "uses_outputs", False):
                log.info("sync_every=%d forced to 1: a configured trigger "
                         "reads step outputs (loss/score) every step", k)
                return 1
        return k

    def _stage_next_batch(self, train_iter, state, n, epoch_size,
                          force=False):
        """Fetch the next batch while the device runs the current step.
        Returns ``(next_batch, train_iter)``; ``next_batch`` is
        ``PREDICTED_END`` when the end trigger will fire after this step,
        and ``None`` (fetch after the trigger has decided) for triggers
        that cannot be probed with a predicted state (stateful ones, and
        those that read the step's loss or score).  ``force`` is that
        deferred fetch."""
        if not force:
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
        if self._reshuffle_pending:
            # the deferred fetch after an epoch rolled over
            self._reshuffle_pending = False
            self.dataset.shuffle()
            train_iter = self.dataset.data(train=True)
        elif state["record_count"] + n >= epoch_size:
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
                         extra_summaries=None, validate_cb=None,
                         feed_plateau=None, checkpoint_cb=None,
                         select=None):
        """The driver loop: stage, dispatch, fetch and stage the next
        batch, sync the loss every ``sync_every``-th step, update the
        driver state, run validation and checkpoints where their triggers
        fire (each first syncs a deferred loss), evaluate the end
        trigger.  ``dispatch(staged) -> device loss``;
        ``extra_summaries(state)`` adds train-summary scalars after
        ``Loss`` and ``Throughput``; ``validate_cb() -> results``, then
        ``feed_plateau(state)``; ``checkpoint_cb(state)`` writes one;
        ``select(tree)`` picks what of each batch is staged (the records
        counted are the whole batch's)."""
        self._reshuffle_pending = False
        epoch_size = self.dataset.size()
        state = self.driver_state
        stager = _Stager(self.device, select)
        queue_stats = getattr(self.dataset, "queue_stats", None)
        sync_every = self._effective_sync_every()
        loss = float("nan")          # the last synced loss
        # primed so the FIRST step syncs: every published loss is a real
        # (at worst stale) value
        sync_skew = sync_every - 1   # steps since the last loss sync
        loss_dev = None
        batch, dev = first_batch, None

        def point_sync():
            nonlocal loss, sync_skew
            loss = float(loss_dev)
            sync_skew = 0
            state["loss"] = loss

        while not self.end_trigger(state):
            t0 = time.perf_counter()
            if batch is None:            # fetch deferred past the trigger
                batch, train_iter = self._stage_next_batch(
                    train_iter, state, 0, epoch_size, force=True)
            if dev is None:
                dev = stager.stage(batch)
            data_wait = time.perf_counter() - t0
            loss_dev = dispatch(stager.wait(*dev))
            n = batch.size()
            qdepth = queue_stats() if queue_stats is not None else None
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
            # batches of COMPLETED steps this epoch: the staged next batch
            # is not counted, so a snapshot's position replays it
            state["batches_consumed"] = state.get("batches_consumed", 0) + 1
            state["throughput"] = n / max(wall, 1e-9)
            event = {"step": state["neval"], "epoch": state["epoch"],
                     "wall_s": wall, "data_wait_s": data_wait,
                     "device_s": wall - data_wait, "loss": loss,
                     "records": n, "records_per_s": state["throughput"],
                     "sync_skew": sync_skew}
            if qdepth is not None:
                event["queue_depth"], event["queue_capacity"] = qdepth
            self._log_progress(loss, state["throughput"], data_wait,
                               sync_skew)
            if self.train_summary is not None:
                add_event = getattr(self.train_summary, "add_step_event",
                                    None)
                if add_event is not None:
                    add_event(event)
                else:
                    self.train_summary.add_scalar("Loss", loss,
                                                  state["neval"])
                    self.train_summary.add_scalar(
                        "Throughput", state["throughput"], state["neval"])
                if extra_summaries is not None:
                    extra_summaries(state)
            state["neval"] += 1
            if state["record_count"] >= epoch_size:
                state["epoch"] += 1
                state["record_count"] = 0
                state["batches_consumed"] = 0
                if next_batch is None:   # fetch deferred past the reset
                    self._reshuffle_pending = True

            if self.validation_trigger is not None and \
                    self.validation_trigger(state):
                if sync_skew:
                    point_sync()
                self._record_validation(validate_cb(), state)
                if feed_plateau is not None:
                    feed_plateau(state)
            if self.checkpoint_trigger is not None and \
                    self.checkpoint_trigger(state):
                if sync_skew:
                    point_sync()
                state["rng_state"] = RNG.get_state()
                state["data_position"] = self._capture_data_position()
                checkpoint_cb(state)

            batch = None if next_batch is PREDICTED_END else next_batch
            dev = next_dev
        if sync_skew and loss_dev is not None:
            # drain: the run's last loss lands in the driver state even
            # when the last steps deferred their sync
            point_sync()


class LocalOptimizer(BaseOptimizer):
    """Training on one device.  Starts from ``optim_method.state`` when it
    is set (for example by ``interop.load_jax_opt_state``), else from
    ``init_state``, and leaves the final state there; a resolved
    checkpoint is copied into the parameters and that state in place
    first.  Each ``optimize()`` builds its compiled step anew, as the JAX
    loop jits a fresh ``make_train_step`` in each: what the step reads
    when it is built (frozen modules, regularizers, the method's
    settings) is read again, and the step's graphs and their pool are
    freed when the call returns."""

    #: ``CompiledTrainStep.stats()`` of the last ``optimize()`` (None
    #: before it): keys built, steps run, the graph pool's bytes
    compiled_stats = None

    def _compiled_step(self, opt_state):
        return CompiledTrainStep(
            self.model, self.criterion, self.optim_method, opt_state,
            self.device, clip_value=self.clip_value,
            clip_norm=self.clip_norm, compute_dtype=self.compute_dtype,
            grad_transform=self.grad_transform)

    @torch.no_grad()
    def _load_snapshot(self, snap, opt_state):
        """Copy a snapshot's parameters, model state (BatchNorm's running
        statistics) and optimizer state into the model's parameters and
        buffers and ``opt_state``, in place (a built step reads them
        where they lie)."""
        from bigdl_tpu_torch.interop.jax_params import (from_jax_opt_state,
                                                        load_jax_params,
                                                        load_jax_state)

        load_jax_params(self.model, snap["model_params"])
        load_jax_state(self.model, snap.get("model_state", ()))
        _copy_into(opt_state, from_jax_opt_state(
            self.optim_method, snap["opt_state"], self.device,
            jax_params=snap["model_params"], model=self.model))

    def _checkpoint(self, opt_state):
        """Write the parameters, the model state, the optimizer state and
        the driver state, in the JAX package's keys and tree layout,
        after the compute stream's work."""
        from bigdl_tpu_torch.interop.jax_params import (to_jax_opt_state,
                                                        to_jax_params,
                                                        to_jax_state)

        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return file_io.save_checkpoint(
            self.checkpoint_path, self.driver_state["neval"],
            to_jax_params(self.model), to_jax_state(self.model),
            to_jax_opt_state(self.optim_method, opt_state, self.model),
            self.driver_state)

    def _optimize_impl(self):
        train_iter = self.dataset.data(train=True)
        first_batch = next(train_iter)
        params = dict(self.model.named_parameters())
        self._resolve_optim_methods(params)
        opt_state = self.optim_method.state
        if opt_state is None:
            opt_state = self.optim_method.init_state(params)
        if self._resume is not None:
            self._load_snapshot(self._resume, opt_state)
            self._apply_driver_state(self._resume["driver_state"])
        train_iter, first_batch = self._resume_data_stream(
            train_iter, first_batch)
        step = self._compiled_step(opt_state)

        def dispatch(staged):
            x, target = staged
            RNG.next_generator()          # the step's stream position
            return step.run(x, target)

        try:
            self._run_driver_loop(
                train_iter, first_batch, dispatch,
                extra_summaries=lambda state: (
                    self._log_learning_rates(opt_state, state),
                    self._histograms(state)),
                validate_cb=lambda: validate(
                    self.model, self.validation_dataset,
                    self.validation_methods, self.compute_dtype),
                feed_plateau=lambda state: self._feed_plateau(
                    state, opt_state),
                checkpoint_cb=lambda state: self._checkpoint(opt_state))
        finally:
            self.compiled_stats = step.stats()
        self.optim_method.state = opt_state
        return self.model


def _tree_leaves(tree, path=()):
    """``(path, leaf)`` of a nested dict in sorted key order, as JAX
    flattens it; empty ``()`` entries hold no leaf."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_leaves(v, path + (k,))
        elif not isinstance(v, tuple):
            yield path + (k,), v


def _copy_into(dst, src):
    """Copy the tensors of the state tree ``src`` into ``dst``'s, which
    has the same structure; a key ``dst`` lacks is added."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst.setdefault(k, {}), v)
        elif k in dst and dst[k].shape == v.shape:
            dst[k].copy_(v)
        else:
            dst[k] = v


def validate(model, dataset, methods, compute_dtype=None):
    """The evaluation loop: ``methods`` over ``dataset``'s
    ``data(train=False)`` batches through the model's compiled eval step
    (``validation.compiled_eval_step``, one graph per batch shape, shared
    with ``Predictor``), on the model's device and current weights.
    Returns one merged ``ValidationResult`` per method (None where no
    batch came)."""
    from bigdl_tpu_torch.optim.validation import compiled_eval_step

    eval_step = compiled_eval_step(model, compute_dtype)
    totals = [None] * len(methods)
    for batch in dataset.data(train=False):
        out = eval_step(_to_device(batch.get_input(), eval_step.device))
        target = _to_device(batch.get_target(), eval_step.device)
        for i, m in enumerate(methods):
            r = m(out, target)
            totals[i] = r if totals[i] is None else totals[i] + r
    return totals


class Optimizer:
    """Factory: ``Optimizer(model, dataset, criterion, optim_method,
    device=None)`` is a ``LocalOptimizer`` on the card (``device=None``)
    or on the device asked for; with ``distributed=True`` (or
    ``strategy="dp"``, its options forwarded) a ``DistriOptimizer`` over
    the process group (``utils.engine.Engine``; a world of one when none
    is initialized); with ``strategy="tp"``, ``"sp"``, ``"ep"`` or
    ``"pp"`` a ``StrategyOptimizer`` over ``mesh=``
    (``Engine.build_mesh``), its options (``data_axis``, ``seq_axis``,
    ``rules``, ``aux_weight``, ``pipe_axis``, ``n_microbatches``,
    ``schedule``) forwarded."""

    def __new__(cls, model=None, dataset=None, criterion=None,
                optim_method=None, distributed=None, strategy=None,
                device=None, **strategy_kw):
        if strategy is not None and strategy != "dp":
            from bigdl_tpu_torch.optim.strategy_optimizer import \
                StrategyOptimizer

            return StrategyOptimizer(model, dataset, criterion,
                                     optim_method, strategy=strategy,
                                     device=device, **strategy_kw)
        if distributed or strategy == "dp":
            from bigdl_tpu_torch.optim.distri_optimizer import \
                DistriOptimizer

            return DistriOptimizer(model, dataset, criterion, optim_method,
                                   device=device, **strategy_kw)
        if strategy_kw:
            raise TypeError(
                f"unexpected arguments {sorted(strategy_kw)}; pass "
                "strategy= ('dp', 'tp', 'sp', 'ep' or 'pp') to route them")
        return LocalOptimizer(model, dataset, criterion, optim_method,
                              device=device)
