"""DataSet abstractions (the port's copy of ``bigdl_tpu/dataset/
dataset.py`` :22-166).  The shuffle draws from the same
``np.random.default_rng(seed)`` stream as the JAX package, so both
packages see the same batches in the same order."""

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.minibatch import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


class AbstractDataSet:
    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        pass

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer):
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset over a list of elements; ``data(train=True)``
    loops forever over the current order."""

    def __init__(self, data: Sequence, shuffle_on_epoch: bool = True,
                 seed: int = 0):
        self._data = list(data)
        self._index = np.arange(len(self._data))
        self.shuffle_on_epoch = shuffle_on_epoch
        self._rng = np.random.default_rng(seed)

    def size(self) -> int:
        return len(self._data)

    def shuffle(self):
        self._rng.shuffle(self._index)

    def data(self, train: bool) -> Iterator:
        if train:
            def gen():
                while True:
                    for i in self._index:
                        yield self._data[i]
            return gen()
        return (self._data[i] for i in range(len(self._data)))


class TransformedDataSet(AbstractDataSet):
    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()

    def data(self, train: bool):
        return self.transformer.apply(self.base.data(train))


def array_dataset(features: np.ndarray, labels: Optional[np.ndarray] = None,
                  **kw) -> LocalDataSet:
    """One Sample per row of ``features`` (and ``labels``)."""
    if labels is None:
        samples = [Sample(f) for f in features]
    else:
        samples = [Sample(f, l) for f, l in zip(features, labels)]
    return LocalDataSet(samples, **kw)
