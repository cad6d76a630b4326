"""Loss functions of the training path (counterpart of
``bigdl_tpu/nn/criterion.py``: ``ClassNLLCriterion`` :25,
``CrossEntropyCriterion`` :54, ``FusedSoftmaxCrossEntropyCriterion`` :68,
``TimeDistributedCriterion`` :303).

Class labels are 0-based integers; ``size_average=True`` averages over
the batch, else sums.  Losses are computed in fp32 whatever the logits'
dtype.
"""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.ops.cross_entropy import fused_softmax_cross_entropy


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities ``(N, C)``; labels
    ``(N,)`` are clipped into ``[0, C)``.  Optional per-class ``weights``;
    rows whose label equals ``padding_value`` weigh 0."""

    def __init__(self, weights=None, size_average=True, padding_value=None):
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average
        self.padding_value = padding_value

    def apply(self, input, target):
        target = target.long()
        safe_t = target.clamp(0, input.shape[-1] - 1)
        nll = -input.gather(-1, safe_t[..., None])[..., 0]
        w = torch.ones_like(nll)
        if self.weights is not None:
            w = self.weights.to(nll.device)[safe_t].to(nll.dtype)
        if self.padding_value is not None:
            w = torch.where(target == self.padding_value,
                            torch.zeros_like(w), w)
        total = (nll * w).sum()
        if self.size_average:
            return total / w.sum().clamp_min(1e-8)
        return total


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL on raw logits ``(N, C)``: the plain
    formulation, which holds the whole ``(N, C)`` log-softmax."""

    def __init__(self, weights=None, size_average=True):
        self.inner = ClassNLLCriterion(weights, size_average)
        self.size_average = size_average

    def apply(self, input, target):
        return self.inner.apply(F.log_softmax(input.float(), dim=-1), target)


class FusedSoftmaxCrossEntropyCriterion(Criterion):
    """CrossEntropyCriterion through the K4/K5 kernels
    (``ops/cross_entropy.py``), for large vocabularies where the plain
    formulation's ``(N, V)`` log-softmax costs a round trip through
    device memory.  2-D input with at least ``min_classes`` classes takes
    the kernels (their plain versions on CPU tensors), for every N; other
    input takes ``CrossEntropyCriterion``, as in the JAX package.  Wrap in
    ``TimeDistributedCriterion`` for ``(B, T, V)`` LM heads."""

    def __init__(self, size_average=True, min_classes=512):
        self.size_average = size_average
        self.min_classes = min_classes

    def apply(self, input, target):
        if input.dim() != 2 or input.shape[1] < self.min_classes:
            return CrossEntropyCriterion(
                size_average=self.size_average).apply(input, target)
        # clip like ClassNLLCriterion so out-of-range markers give the
        # same losses on every path
        y = target.long().clamp(0, input.shape[1] - 1)
        losses = fused_softmax_cross_entropy(input, y)
        return losses.mean() if self.size_average else losses.sum()


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of ``(N, T, ...)`` input: the
    input becomes ``(N*T, ...)`` (a view when it is contiguous, as the
    LM head's logits are) and the inner criterion's own mean or sum is
    returned."""

    def __init__(self, criterion, size_average=True):
        self.criterion = criterion
        self.size_average = size_average

    def apply(self, input, target):
        n, t = input.shape[0], input.shape[1]
        flat_in = input.reshape((n * t,) + tuple(input.shape[2:]))
        flat_t = target.reshape((n * t,) + tuple(target.shape[2:]))
        return self.criterion.apply(flat_in, flat_t)
