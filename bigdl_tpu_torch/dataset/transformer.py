"""Transformer chain (the port's copy of ``bigdl_tpu/dataset/
transformer.py``: ``Transformer`` :16, ``SampleToMiniBatch`` :69):
composable Iterator -> Iterator stages, ``a >> b``."""

from typing import Iterator, Optional

from bigdl_tpu_torch.dataset.minibatch import (PaddingParam,
                                               samples_to_minibatch)


class Transformer:
    """apply(iterator) -> iterator; compose with ``a >> b``."""

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
