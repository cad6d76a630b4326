"""Sample / MiniBatch (the port's copy of ``bigdl_tpu/dataset/
minibatch.py``: ``Sample`` :16, ``MiniBatch`` :29, ``PaddingParam`` :101,
``samples_to_minibatch`` :127; ``MiniBatch.pad_to`` :64).  Host-side data is numpy; the training
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

    def pad_to(self, batch_to: int, pad_target: bool = True) -> "MiniBatch":
        """Zero-pad the batch axis up to ``batch_to`` rows (the predict
        path's bucket): padded rows are inert in eval mode and the
        caller slices them off the output.  Identity when already sized;
        a smaller ``batch_to`` raises.  ``pad_target=False`` passes the
        target through untouched (prediction never reads it)."""
        n = self.size()
        if batch_to == n:
            return self
        if batch_to < n:
            raise ValueError(
                f"pad_to({batch_to}) cannot shrink a batch of {n}")
        from bigdl_tpu_torch.serving.buckets import pad_batch_axis

        def check(x, label):
            if isinstance(x, (tuple, list)):
                for e in x:
                    check(e, label)
            elif np.asarray(x).dtype == object:
                raise TypeError(
                    f"pad_to cannot zero-pad non-array {label} leaves "
                    f"({type(x).__name__})")

        check(self.input, "input")
        target = self.target
        if pad_target and target is not None:
            check(target, "target")
            target = pad_batch_axis(target, batch_to)
        return MiniBatch(pad_batch_axis(self.input, batch_to), target)


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
