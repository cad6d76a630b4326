"""Batch inference (counterpart of ``bigdl_tpu/optim/predictor.py``:
``Predictor`` :36 and ``evaluate`` :291).

``Predictor`` runs the model's compiled eval step
(``validation.compiled_eval_step``), the one validation builds, so a
model that was validated predicts through validation's graphs.  A ragged
batch (a dataset's tail) is zero-padded up to a bucket before it runs,
so the set of shapes stays closed: by default the largest batch seen in
the run (one graph for a dataset of uniform batches), or the smallest
rung of a ``serving.BucketLadder`` that holds it.  The padded rows are
sliced off on the host.  ``PredictionService`` (the semaphore and
coalescing front of JAX's :189) is not ported: coalescing goes through
the serving engine (ROADMAP A2).
"""

from typing import List

import numpy as np

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

    def predict_minibatch(self, batch):
        """The model's output on one batch, a tensor of its own: on the
        card the eval step returns its graph's static output, which the
        next batch of the shape overwrites, so this returns a copy."""
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


def evaluate(model, dataset, methods, compute_dtype=None):
    """``model.evaluate``: ``methods`` over ``dataset`` through the
    compiled eval step; one merged ``ValidationResult`` per method."""
    from bigdl_tpu_torch.optim.local_optimizer import validate

    return validate(model, dataset, methods, compute_dtype)
