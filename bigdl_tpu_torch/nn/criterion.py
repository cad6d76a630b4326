"""Loss functions (counterpart of ``bigdl_tpu/nn/criterion.py``, all 18
classes; the rest of the reference's are in ``criterion_extras``).

Class labels are 0-based integers; ``size_average=True`` averages over
the batch (or the elements, where the JAX class does), else sums.  The
training path's criteria compute in fp32 whatever the logits' dtype.

``backward`` is the gradient with respect to the input, as ``jax.grad``
gives it, kinks included: ``jnp.abs`` has gradient +1 at 0, and
``jnp.maximum`` / ``jnp.minimum`` (so ``jnp.clip``) split a tie evenly,
where ``torch.abs`` gives 0 and ``torch.clamp`` 1.  The helpers below
(``_abs``, ``_clip``) keep JAX's rule.
"""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.ops.cross_entropy import fused_softmax_cross_entropy


def _abs(x):
    """``|x|`` with ``jnp.abs``'s gradient: +1 at 0 (and -0)."""
    return x * torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _const(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _clip(x, lo=None, hi=None):
    """``jnp.clip``: ``min(max(x, lo), hi)``, a tie splitting the
    gradient evenly."""
    if lo is not None:
        x = torch.maximum(x, _const(lo, x))
    if hi is not None:
        x = torch.minimum(x, _const(hi, x))
    return x


def _mean_or_sum(x, size_average):
    return x.mean() if size_average else x.sum()


def _softplus_margin(x, target):
    """``max(x, 0) - x * t + log1p(exp(-|x|))``, the stable logistic
    loss of the JAX classes."""
    return torch.maximum(x, _const(0.0, x)) - x * target + \
        torch.log1p(torch.exp(-_abs(x)))


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


class MSECriterion(Criterion):
    """Mean squared error; ``size_average`` divides by the element count
    (reference: nn/MSECriterion.scala)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        return _mean_or_sum((input - target).square(), self.size_average)


class AbsCriterion(Criterion):
    """Mean absolute error (reference: nn/AbsCriterion.scala)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        return _mean_or_sum(_abs(input - target), self.size_average)


class BCECriterion(Criterion):
    """Binary cross-entropy over probabilities, clipped into ``[eps, 1 -
    eps]`` (reference: nn/BCECriterion.scala)."""

    def __init__(self, weights=None, size_average=True, eps=1e-12):
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average
        self.eps = eps

    def apply(self, input, target):
        x = _clip(input, self.eps, 1.0 - self.eps)
        ce = -(target * torch.log(x) + (1.0 - target) * torch.log(1.0 - x))
        if self.weights is not None:
            ce = ce * self.weights.to(ce.device)
        return _mean_or_sum(ce, self.size_average)


class BCEWithLogitsCriterion(Criterion):
    """Sigmoid + BCE in the numerically stable fused form."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        return _mean_or_sum(_softplus_margin(input, target),
                            self.size_average)


class SmoothL1Criterion(Criterion):
    """Huber loss with delta 1 (reference: nn/SmoothL1Criterion.scala)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        d = _abs(input - target)
        loss = torch.where(d < 1.0, 0.5 * d.square(), d - 0.5)
        return _mean_or_sum(loss, self.size_average)


class DistKLDivCriterion(Criterion):
    """KL divergence, input log-probabilities, target probabilities;
    ``size_average`` divides by the batch (reference:
    nn/DistKLDivCriterion.scala)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        kl = torch.where(target > 0, target * (
            torch.log(_clip(target, 1e-30)) - input),
            torch.zeros_like(input))
        total = kl.sum()
        return total / input.shape[0] if self.size_average else total


class MarginCriterion(Criterion):
    """Hinge loss ``max(0, margin - y * x)``, squared with ``squared``
    (reference: nn/MarginCriterion.scala)."""

    def __init__(self, margin=1.0, size_average=True, squared=False):
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def apply(self, input, target):
        h = _clip(self.margin - input * target, 0.0)
        if self.squared:
            h = h.square()
        return _mean_or_sum(h, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    """``x`` where ``y > 0``, else ``max(0, margin - x)`` (reference:
    nn/HingeEmbeddingCriterion.scala; ``y`` in {1, -1})."""

    def __init__(self, margin=1.0, size_average=True):
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        loss = torch.where(target > 0, input,
                           _clip(self.margin - input, 0.0))
        return _mean_or_sum(loss, self.size_average)


class L1Cost(Criterion):
    """The sum of ``|input|``; the target is ignored (reference:
    nn/L1Cost.scala)."""

    def apply(self, input, target=None):
        return _abs(input).sum()


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


class CosineEmbeddingCriterion(Criterion):
    """Table input ``(x1, x2)``, target ``(N,)`` in {1, -1}: ``1 - cos``
    or ``max(0, cos - margin)`` (reference:
    nn/CosineEmbeddingCriterion.scala)."""

    def __init__(self, margin=0.0, size_average=True):
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input
        cos = (x1 * x2).sum(-1) / _clip(_norm(x1) * _norm(x2), 1e-12)
        loss = torch.where(target > 0, 1.0 - cos,
                           _clip(cos - self.margin, 0.0))
        return _mean_or_sum(loss, self.size_average)


class KullbackLeiblerDivergenceCriterion(Criterion):
    """KL over probabilities, both clipped into ``[1e-7, 1]``, summed
    over the last axis and averaged (reference:
    nn/KullbackLeiblerDivergenceCriterion.scala)."""

    def apply(self, input, target):
        x = _clip(input, 1e-7, 1.0)
        t = _clip(target, 1e-7, 1.0)
        return (t * torch.log(t / x)).sum(-1).mean()


class MultiLabelSoftMarginCriterion(Criterion):
    """The logistic loss per label, averaged over labels, then over the
    batch or summed (reference: nn/MultiLabelSoftMarginCriterion.scala)."""

    def __init__(self, weights=None, size_average=True):
        self.weights = None if weights is None else \
            torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        ce = _softplus_margin(input, target)
        if self.weights is not None:
            ce = ce * self.weights.to(ce.device)
        return _mean_or_sum(ce.mean(-1), self.size_average)


class MultiCriterion(Criterion):
    """Weighted sum of criteria on one ``(input, target)`` (reference:
    nn/MultiCriterion.scala)."""

    def __init__(self):
        self.criterions = []
        self.cweights = []

    def add(self, criterion, weight=1.0):
        self.criterions.append(criterion)
        self.cweights.append(weight)
        return self

    def apply(self, input, target):
        return sum(w * c.apply(input, target)
                   for w, c in zip(self.cweights, self.criterions))


class ParallelCriterion(Criterion):
    """Criterion i on ``(input[i], target[i])`` (the whole target with
    ``repeat_target``), weighted and summed (reference:
    nn/ParallelCriterion.scala)."""

    def __init__(self, repeat_target=False):
        self.criterions = []
        self.cweights = []
        self.repeat_target = repeat_target

    def add(self, criterion, weight=1.0):
        self.criterions.append(criterion)
        self.cweights.append(weight)
        return self

    def apply(self, input, target):
        total = 0.0
        for i, (w, c) in enumerate(zip(self.cweights, self.criterions)):
            t = target if self.repeat_target else target[i]
            total = total + w * c.apply(input[i], t)
        return total
