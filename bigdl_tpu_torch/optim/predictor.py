"""Batch inference (counterpart of ``bigdl_tpu/optim/predictor.py``:
``Predictor`` :36, ``PredictionService`` :189 and ``evaluate`` :291).

``Predictor`` runs the model's compiled eval step
(``validation.compiled_eval_step``), the one validation builds, so a
model that was validated predicts through validation's graphs.  A ragged
batch (a dataset's tail) is zero-padded up to a bucket before it runs,
so the set of shapes stays closed: by default the largest batch seen in
the run (one graph for a dataset of uniform batches), or the smallest
rung of a ``serving.BucketLadder`` that holds it.  The padded rows are
sliced off on the host.  The step is shared with every other user of the
(model, dtype), so a run and the read of its output hold the step's
lock.

``PredictionService`` serves single requests from many threads: by
default each runs the compiled step at batch 1 behind a semaphore of
``num_threads`` permits; with ``coalesce=True`` the requests go through a
``serving.ServingEngine``, which batches them.
"""

import io
import threading
from typing import List

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.minibatch import (MiniBatch, Sample,
                                               samples_to_minibatch)
from bigdl_tpu_torch.optim.validation import (_tree_clone,
                                               compiled_eval_step)


def _host(y):
    if isinstance(y, (tuple, list)):
        return type(y)(_host(e) for e in y)
    return y.detach().cpu().numpy()


class Predictor:
    """Batched prediction over a dataset of MiniBatches or a list of
    Samples (or arrays), on the model's device.  ``ladder``: an optional
    ``BucketLadder`` (copied: a batch above its largest rung adds a rung
    to this Predictor's copy only)."""

    def __init__(self, model, batch_size: int = 128, compute_dtype=None,
                 ladder=None):
        self.model = model
        self.batch_size = batch_size
        self.ladder = None if ladder is None else ladder.copy()
        self._eval = compiled_eval_step(model, compute_dtype)
        #: the step's lock: a run and the read of its output hold it
        self._lock = self._eval.lock

    def predict_minibatch(self, batch):
        """The model's output on one batch, a tensor of its own: on the
        card the eval step returns its graph's static output, which the
        next batch of the shape overwrites, so this returns a copy."""
        with self._lock:
            return _tree_clone(self._run(batch))

    def _run(self, batch):
        """The eval step's own output (``predict`` reads it before the
        next batch runs)."""
        from bigdl_tpu_torch.optim.local_optimizer import _to_device

        return self._eval(_to_device(batch.get_input(), self._eval.device))

    def _bucket_for(self, n: int, run_max: int) -> int:
        """The pad target of an ``n``-row batch: the ladder's rung (grown
        past its largest when needed), else the run's largest batch."""
        if self.ladder is not None:
            b = self.ladder.bucket_for(n)
            return b if b is not None else self.ladder.add(n)
        return max(n, run_max)

    def predict(self, data) -> List:
        """One output per sample: a numpy row, or for a model with
        several outputs, the sample's tuple of rows.  Batch k+1 is
        fetched while batch k runs; the output's copy to the host is the
        sync."""
        outs = []
        it = self._batches(data)
        batch = next(it, None)
        run_max = 0
        while batch is not None:
            n = batch.size()
            bucket = self._bucket_for(n, run_max)
            try:
                staged = batch.pad_to(bucket, pad_target=False)
            except TypeError:          # leaves that cannot be zero-padded
                staged, bucket = batch, n
            run_max = max(run_max, bucket)
            with self._lock:
                y = self._run(staged)
                next_batch = next(it, None)
                y = _host(y)
            if isinstance(y, (tuple, list)):
                outs.extend(tuple(rows) for rows in
                            zip(*(leaf[:n] for leaf in y)))
            else:
                outs.extend(y[:n])
            batch = next_batch
        return outs

    def predict_class(self, data) -> List[int]:
        """The argmax over the last axis of each output."""
        return [int(np.argmax(o, axis=-1)) for o in self.predict(data)]

    def _batches(self, data):
        if isinstance(data, AbstractDataSet):
            yield from data.data(train=False)
            return
        records = list(data)
        for i in range(0, len(records), self.batch_size):
            chunk = records[i:i + self.batch_size]
            if isinstance(chunk[0], Sample):
                yield samples_to_minibatch(chunk)
            else:
                yield MiniBatch(np.stack(chunk))


class PredictionService:
    """Thread-safe concurrent serving (JAX ``optim/predictor.py:189``,
    reference ``optim/PredictionService.scala:56``).

    By default ``num_threads`` bounds the requests in flight, each run at
    batch 1 through the model's compiled eval step (one graph, shared by
    every thread, as the reference's pooled clones share weights); a
    permit is released whatever the request's outcome.  ``coalesce=True``
    sends the requests through a ``ServingEngine`` instead (``engine_kw``
    are its arguments, ``device`` among them), which pads concurrent
    requests into one batch a tick (``max_batch_size`` /
    ``max_wait_ms``); its bounded queue then does the admission control.
    ``close()`` (or the context manager) stops the engine."""

    def __init__(self, model, num_threads: int = 4, compute_dtype=None,
                 coalesce: bool = False, max_batch_size: int = 16,
                 max_wait_ms: float = 2.0, **engine_kw):
        self.predictor = Predictor(model, compute_dtype=compute_dtype)
        self._sem = threading.Semaphore(num_threads)
        self.engine = None
        if coalesce:
            from bigdl_tpu_torch.serving import ServingEngine

            self.engine = ServingEngine(
                model, max_batch_size=max_batch_size,
                max_wait_ms=max_wait_ms, compute_dtype=compute_dtype,
                **engine_kw)
        elif engine_kw:
            raise TypeError(
                f"unexpected arguments {sorted(engine_kw)}: engine options "
                "require coalesce=True")

    def predict(self, activity):
        """One activity (an array or a tuple of them, without the batch
        axis) -> its output rows (numpy).  A failure inside (a bad
        payload, a device error) releases the permit and reaches the
        caller."""
        if self.engine is not None:
            return self.engine.predict(activity)
        self._sem.acquire()
        try:
            step = self.predictor._eval
            x = _batch_of_one(activity, step.device)
            return _tree_row0(step.host(x))
        finally:
            self._sem.release()

    def predict_bytes(self, data: bytes) -> bytes:
        """The byte API (reference :128-255 uses protobuf): an npz of the
        activity's arrays in, taken in sorted key order, an npz of the
        outputs (``out0``, ``out1``, ...) back."""
        with io.BytesIO(data) as f:
            arrs = np.load(f, allow_pickle=False)
            activity = tuple(arrs[k] for k in sorted(arrs.files))
        if len(activity) == 1:
            activity = activity[0]
        out = self.predict(activity)
        buf = io.BytesIO()
        if isinstance(out, tuple):
            np.savez(buf, **{f"out{i}": np.asarray(o)
                             for i, o in enumerate(out)})
        else:
            np.savez(buf, out0=np.asarray(out))
        return buf.getvalue()

    def precompile(self, buckets=None, example_feature=None):
        """Warm the coalescing engine's ladder (``ServingEngine.
        precompile``); 0 on the semaphore path, whose one batch-1 shape is
        built by its first request."""
        if self.engine is not None:
            return self.engine.precompile(buckets, example_feature)
        return 0

    def close(self):
        if self.engine is not None:
            self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _batch_of_one(activity, device):
    if isinstance(activity, (tuple, list)):
        return tuple(_batch_of_one(a, device) for a in activity)
    return torch.as_tensor(np.asarray(activity), device=device)[None]


def _tree_row0(y):
    if isinstance(y, (tuple, list)):
        return tuple(_tree_row0(e) for e in y)
    return y[0]


def evaluate(model, dataset, methods, compute_dtype=None):
    """``model.evaluate``: ``methods`` over ``dataset`` through the
    compiled eval step; one merged ``ValidationResult`` per method."""
    from bigdl_tpu_torch.optim.local_optimizer import validate

    return validate(model, dataset, methods, compute_dtype)
