"""Sample / MiniBatch (the port's copy of ``bigdl_tpu/dataset/
minibatch.py``: ``Sample`` :16, ``MiniBatch`` :29, ``PaddingParam`` :101,
``samples_to_minibatch`` :127).  Host-side data is numpy; the training
loop moves each batch to the device once."""

from typing import List, Optional, Sequence

import numpy as np


class Sample:
    """One training example: feature activity + label activity."""

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label

    def __repr__(self):
        f = np.shape(self.feature)
        l = None if self.label is None else np.shape(self.label)
        return f"Sample(feature={f}, label={l})"


class MiniBatch:
    """A batched set of samples."""

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def get_input(self):
        return self.input

    def get_target(self):
        return self.target

    def tree(self):
        """``(input, target)`` as one tuple (target may be None)."""
        return self.input, self.target

    def size(self) -> int:
        leaf = self.input
        while isinstance(leaf, (tuple, list)):
            leaf = leaf[0]
        return leaf.shape[0]


class PaddingParam:
    """Pad variable-length features to a common shape."""

    def __init__(self, padding_value=0.0, fixed_length: Optional[int] = None):
        self.padding_value = padding_value
        self.fixed_length = fixed_length


def _stack(arrays: Sequence[np.ndarray], padding: Optional[PaddingParam]):
    """Stack, padding the first (time) axis if lengths differ."""
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and (padding is None or padding.fixed_length is None):
        return np.stack(arrays)
    if padding is None:
        padding = PaddingParam()
    max_len = max(a.shape[0] for a in arrays)
    if padding.fixed_length is not None:
        max_len = padding.fixed_length
    out_shape = (len(arrays), max_len) + arrays[0].shape[1:]
    out = np.full(out_shape, padding.padding_value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a[:max_len]
    return out


def samples_to_minibatch(samples: List[Sample],
                         feature_padding: Optional[PaddingParam] = None,
                         label_padding: Optional[PaddingParam] = None
                         ) -> MiniBatch:
    """Batch a list of Samples."""
    first = samples[0]
    if isinstance(first.feature, (tuple, list)):
        input = tuple(_stack([s.feature[i] for s in samples], feature_padding)
                      for i in range(len(first.feature)))
    else:
        input = _stack([s.feature for s in samples], feature_padding)
    target = None
    if first.label is not None:
        if isinstance(first.label, (tuple, list)):
            target = tuple(_stack([s.label[i] for s in samples],
                                  label_padding)
                           for i in range(len(first.label)))
        else:
            target = _stack([np.asarray(s.label) for s in samples],
                            label_padding)
    return MiniBatch(input, target)
