"""DataSet abstractions (the port's copy of ``bigdl_tpu/dataset/
dataset.py`` :22-166).  The shuffle draws from the same
``np.random.default_rng(seed)`` stream as the JAX package, so both
packages see the same batches in the same order, and a dataset's
``position_state`` (its epoch order and the shuffle stream's state, JAX
:32-48, 93-110, 126-130) is JAX's own dict: a checkpoint's mid-epoch
position restores in either package."""

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

    def position_state(self):
        """Everything a fresh ``data(train=True)`` iterator needs to
        replay this epoch's order, with the shuffle stream's state so
        later ``shuffle()`` calls continue it; ``None`` marks a source
        that cannot restore its position (a resume then restarts the
        epoch, with a warning)."""
        return None

    def restore_position(self, state):
        """Restore a ``position_state()`` snapshot."""
        raise NotImplementedError(
            f"{type(self).__name__} produced no position_state to "
            "restore")

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer):
        return self.transform(transformer)

    def prefetch(self, num_workers: int = 2, queue_depth: int = 4):
        """Run this dataset's transformer chain on background worker
        threads feeding a bounded queue (``dataset/prefetch.py``).
        Terminal: apply after the whole ``>>`` chain."""
        from bigdl_tpu_torch.dataset.prefetch import PrefetchDataSet

        return PrefetchDataSet(self, num_workers=num_workers,
                               queue_depth=queue_depth)


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

    def position_state(self):
        """The epoch's permutation and the shuffle stream's state."""
        return {"kind": "local", "index": np.asarray(self._index).copy(),
                "rng_state": self._rng.bit_generator.state}

    def restore_position(self, state):
        if state.get("kind") != "local" or \
                len(state["index"]) != len(self._data):
            raise ValueError(
                f"dataset position state does not match this dataset "
                f"({len(state.get('index', ()))} indexed elements vs "
                f"{len(self._data)} held)")
        self._index = np.asarray(state["index"]).copy()
        self._rng.bit_generator.state = state["rng_state"]


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

    def position_state(self):
        return self.base.position_state()

    def restore_position(self, state):
        self.base.restore_position(state)


def array_dataset(features: np.ndarray, labels: Optional[np.ndarray] = None,
                  **kw) -> LocalDataSet:
    """One Sample per row of ``features`` (and ``labels``)."""
    if labels is None:
        samples = [Sample(f) for f in features]
    else:
        samples = [Sample(f, l) for f, l in zip(features, labels)]
    return LocalDataSet(samples, **kw)
