"""Transformer chain (the port's copy of ``bigdl_tpu/dataset/
transformer.py``: ``Transformer`` :16, ``FnTransformer`` :44,
``SampleToMiniBatch`` :69, ``Normalizer`` :98): composable Iterator ->
Iterator stages, ``a >> b``."""

from typing import Iterator, Optional

import numpy as np

from bigdl_tpu_torch.dataset.minibatch import (PaddingParam, Sample,
                                               samples_to_minibatch)


class Transformer:
    """apply(iterator) -> iterator; compose with ``a >> b``.

    A stage that maps elements independently (no state across elements,
    no batching) may also define ``apply_one(x) -> y``: the prefetch
    pipeline (``dataset/prefetch.py``) fans such stages out across worker
    threads, while order-dependent stages (``SampleToMiniBatch``) run
    serially on the reordered stream."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it):
        return self.apply(it)

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    def __init__(self, first, second):
        self.first, self.second = first, second

    def apply(self, it):
        return self.second.apply(self.first.apply(it))


class FnTransformer(Transformer):
    """A per-element function.  ``parallel_safe`` (default True) says
    that ``fn`` is pure per element, so ``.prefetch()`` may run it on
    worker threads; pass False for a stateful ``fn`` (one drawing from a
    shared seeded generator), which then runs single-threaded in source
    order and keeps the batch sequence the synchronous path's."""

    def __init__(self, fn, parallel_safe: bool = True):
        self.fn = fn
        if not parallel_safe:
            # no usable apply_one: prefetch keeps the stage serial
            self.apply_one = None

    def apply_one(self, x):
        return self.fn(x)

    def apply(self, it):
        return (self.fn(x) for x in it)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches; an incomplete trailing batch is
    dropped when ``drop_remainder``."""

    def __init__(self, batch_size: int,
                 feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None,
                 drop_remainder: bool = True):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.drop_remainder = drop_remainder

    def apply(self, it):
        buf = []
        for sample in it:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield samples_to_minibatch(buf, self.feature_padding,
                                           self.label_padding)
                buf = []
        if buf and not self.drop_remainder:
            yield samples_to_minibatch(buf, self.feature_padding,
                                       self.label_padding)


class Normalizer(Transformer):
    """``(x - mean) / std`` on Sample features."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def apply_one(self, s):
        return Sample((np.asarray(s.feature, np.float32) - self.mean)
                      / self.std, s.label)

    def apply(self, it):
        return (self.apply_one(s) for s in it)
