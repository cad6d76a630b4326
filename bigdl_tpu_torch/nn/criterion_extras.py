"""The rest of the reference's loss functions (counterpart of
``bigdl_tpu/nn/criterion_extras.py``, all 21 classes).

Where the JAX package departs from the Scala reference the port follows
the JAX package: ``ClassSimplexCriterion`` embeds the classes as the
identity's rows, and ``TimeDistributedMaskCriterion`` applies the inner
criterion to one row at a time (so an inner ``size_average`` divides by
1).  ``TransformerCriterion`` runs the port's modules.  Gradients keep
``jax.grad``'s rules at kinks (``criterion._abs``, ``criterion._clip``).
"""

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.criterion import (_abs, _clip, _mean_or_sum,
                                          _norm)
from bigdl_tpu_torch.nn.module import Criterion


class CategoricalCrossEntropy(Criterion):
    """``-sum(target * log(p))`` over probabilities ``p``, clipped at
    ``epsilon`` and renormalised (reference:
    nn/CategoricalCrossEntropy.scala)."""

    def __init__(self, epsilon=1e-8):
        self.epsilon = epsilon

    def apply(self, input, target):
        p = _clip(input, self.epsilon, 1.0)
        p = p / p.sum(-1, keepdim=True)
        return -(target * torch.log(p)).sum(-1).mean()


class CosineDistanceCriterion(Criterion):
    """``1 - cos(input, target)`` (reference:
    nn/CosineDistanceCriterion.scala)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        num = (input * target).sum(-1)
        den = _clip(_norm(input) * _norm(target), 1e-12)
        return _mean_or_sum(1.0 - num / den, self.size_average)


class CosineProximityCriterion(Criterion):
    """``-mean(cos)`` of the l2-normalised input and target (reference:
    nn/CosineProximityCriterion.scala)."""

    def apply(self, input, target):
        xn = input / _clip(_norm(input)[..., None], 1e-12)
        yn = target / _clip(_norm(target)[..., None], 1e-12)
        return -(xn * yn).sum(-1).mean()


class DiceCoefficientCriterion(Criterion):
    """``1 - (2 |X n Y| + eps) / (|X| + |Y| + eps)`` per sample (reference:
    nn/DiceCoefficientCriterion.scala)."""

    def __init__(self, size_average=True, epsilon=1.0):
        self.size_average = size_average
        self.epsilon = epsilon

    def apply(self, input, target):
        axes = tuple(range(1, input.dim()))
        inter = (input * target).sum(axes)
        union = input.sum(axes) + target.sum(axes)
        loss = 1.0 - (2.0 * inter + self.epsilon) / (union + self.epsilon)
        return _mean_or_sum(loss, self.size_average)


class DotProductCriterion(Criterion):
    """``-sum(input * target)`` (reference: nn/DotProductCriterion.scala)."""

    def __init__(self, size_average=False):
        self.size_average = size_average

    def apply(self, input, target):
        return -_mean_or_sum((input * target).sum(-1), self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """Table input ``(x1, x2)``, ``y`` in {1, -1}: the L1 distance, or its
    hinge ``max(0, margin - d)`` (reference:
    nn/L1HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin=1.0):
        self.margin = margin

    def apply(self, input, target):
        x1, x2 = input
        d = _abs(x1 - x2).sum(-1)
        y = target.reshape(d.shape)
        return torch.where(y > 0, d, _clip(self.margin - d, 0.0)).mean()


class MarginRankingCriterion(Criterion):
    """Table input ``(x1, x2)``: ``max(0, -y (x1 - x2) + margin)``
    (reference: nn/MarginRankingCriterion.scala)."""

    def __init__(self, margin=1.0, size_average=True):
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input
        y = target.reshape(x1.shape)
        loss = _clip(-y * (x1 - x2) + self.margin, 0.0)
        return _mean_or_sum(loss, self.size_average)


class MeanAbsolutePercentageCriterion(Criterion):
    """``100 * mean(|x - y| / max(|y|, 1e-7))`` (reference:
    nn/MeanAbsolutePercentageCriterion.scala)."""

    def apply(self, input, target):
        return 100.0 * (_abs(input - target)
                        / _clip(_abs(target), 1e-7)).mean()


class MeanSquaredLogarithmicCriterion(Criterion):
    """``mean((log(y + 1) - log(x + 1))^2)``, both clipped at 1e-7
    (reference: nn/MeanSquaredLogarithmicCriterion.scala)."""

    def apply(self, input, target):
        a = torch.log(_clip(input, 1e-7) + 1.0)
        b = torch.log(_clip(target, 1e-7) + 1.0)
        return (a - b).square().mean()


class MultiLabelMarginCriterion(Criterion):
    """Multi-label hinge; targets are class indices padded with -1
    (reference: nn/MultiLabelMarginCriterion.scala, 1-based there)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        n, c = input.shape
        tgt = target.long()
        valid = tgt >= 0
        safe = tgt.clamp(0, c - 1)
        is_target = (F.one_hot(safe, c) * valid[..., None]).sum(1) > 0
        x_t = input.gather(1, safe)                            # (n, k)
        margins = 1.0 - (x_t[:, :, None] - input[:, None, :])  # (n, k, c)
        mask = valid[:, :, None] & ~is_target[:, None, :]
        loss = (_clip(margins, 0.0) * mask).sum((1, 2)) / c
        return _mean_or_sum(loss, self.size_average)


class MultiMarginCriterion(Criterion):
    """Single-label margin hinge ``sum_j max(0, margin - x_y + x_j)^p / C``
    over the other classes (reference: nn/MultiMarginCriterion.scala)."""

    def __init__(self, p=1, weights=None, margin=1.0, size_average=True):
        self.p = p
        self.weights = weights
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        n, c = input.shape
        t = target.long().clamp(0, c - 1)
        x_t = input.gather(1, t[:, None])
        m = _clip(self.margin - x_t + input, 0.0) ** self.p
        if self.weights is not None:
            w = torch.as_tensor(self.weights, dtype=input.dtype,
                                device=input.device)
            m = m * w[t][:, None]
        m = m * (1.0 - F.one_hot(t, c).to(input.dtype))
        return _mean_or_sum(m.sum(1) / c, self.size_average)


class PoissonCriterion(Criterion):
    """``mean(x - y log(max(x, 1e-7)))`` (reference:
    nn/PoissonCriterion.scala)."""

    def apply(self, input, target):
        return (input - target * torch.log(_clip(input, 1e-7))).mean()


class SoftMarginCriterion(Criterion):
    """``log(1 + exp(-y x))`` (reference: nn/SoftMarginCriterion.scala)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target):
        return _mean_or_sum(torch.log1p(torch.exp(-target * input)),
                            self.size_average)


class KLDCriterion(Criterion):
    """``KL(N(mean, exp(log_var)) || N(0, 1))`` of a ``(mean, log_var)``
    table, the VAE regulariser (reference: nn/KLDCriterion.scala)."""

    def __init__(self, size_average=True):
        self.size_average = size_average

    def apply(self, input, target=None):
        mean, log_var = input
        kld = 0.5 * (mean.square() + torch.exp(log_var) - 1.0
                     - log_var).sum(-1)
        return _mean_or_sum(kld, self.size_average)


class GaussianCriterion(Criterion):
    """Negative log-likelihood of the target under ``N(mean,
    exp(log_var))`` of a ``(mean, log_var)`` table (reference:
    nn/GaussianCriterion.scala)."""

    def apply(self, input, target):
        mean, log_var = input
        nll = 0.5 * (math.log(2.0 * math.pi) + log_var
                     + (target - mean).square() / torch.exp(log_var))
        return nll.sum()


class TransformerCriterion(Criterion):
    """A criterion on the outputs of input and target transformer
    modules (reference: nn/TransformerCriterion.scala)."""

    def __init__(self, criterion, input_transformer=None,
                 target_transformer=None):
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    def apply(self, input, target):
        def run(mod, x):
            return x if mod is None else mod(x)

        return self.criterion.apply(run(self.input_transformer, input),
                                    run(self.target_transformer, target))


class TimeDistributedMaskCriterion(Criterion):
    """The inner criterion on every ``(n, t)`` row alone, rows whose
    target equals ``padding_value`` weighing 0, averaged over the kept
    rows (reference: nn/TimeDistributedMaskCriterion.scala)."""

    def __init__(self, criterion, padding_value=0):
        self.criterion = criterion
        self.padding_value = padding_value

    def apply(self, input, target):
        n, t = target.shape[0], target.shape[1]
        flat_in = input.reshape((n * t,) + tuple(input.shape[2:]))
        flat_t = target.reshape((n * t,) + tuple(target.shape[2:]))
        mask = (flat_t != self.padding_value).to(flat_in.dtype)
        per = torch.stack([self.criterion.apply(flat_in[i:i + 1],
                                                flat_t[i:i + 1])
                           for i in range(n * t)])
        m = mask.reshape(per.shape) if mask.dim() == per.dim() else mask
        return (per * m).sum() / _clip(m.sum(), 1.0)


class ClassSimplexCriterion(Criterion):
    """MSE against the class's vertex of a simplex embedding: the
    identity's rows, as the JAX package embeds it (reference:
    nn/ClassSimplexCriterion.scala)."""

    def __init__(self, n_classes):
        self.n_classes = n_classes
        self.simplex = torch.eye(n_classes)

    def apply(self, input, target):
        t = target.long().clamp(0, self.n_classes - 1)
        goal = self.simplex.to(input.device)[t]
        k = goal.shape[-1]
        return (input[..., :k] - goal).square().sum(-1).mean()


class SmoothL1CriterionWithWeights(Criterion):
    """Smooth-L1 with inside and outside weights, the Fast-RCNN box
    head's (reference: nn/SmoothL1CriterionWithWeights.scala).
    ``target``: ``(targets, inside_w, outside_w)`` or a tensor (weights
    1)."""

    def __init__(self, sigma=1.0, num=0):
        self.sigma2 = sigma * sigma
        self.num = num

    def apply(self, input, target):
        if isinstance(target, tuple):
            tgt, w_in, w_out = target
        else:
            tgt = target
            w_in = w_out = torch.ones_like(input)
        d = w_in * (input - tgt)
        ad = _abs(d)
        loss = torch.where(ad < 1.0 / self.sigma2,
                           0.5 * self.sigma2 * d * d,
                           ad - 0.5 / self.sigma2)
        total = (w_out * loss).sum()
        return total / self.num if self.num > 0 else total


class SoftmaxWithCriterion(Criterion):
    """Softmax + NLL over the last axis of spatial maps, with an optional
    ignored label, caffe's SoftmaxWithLoss (reference:
    nn/SoftmaxWithCriterion.scala)."""

    def __init__(self, ignore_label=None, normalize_mode="VALID"):
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def apply(self, input, target):
        logp = F.log_softmax(input, dim=-1)
        t = target.long().clamp(0, input.shape[-1] - 1)
        nll = -logp.gather(-1, t[..., None])[..., 0]
        if self.ignore_label is not None:
            mask = (target != self.ignore_label).to(nll.dtype)
            nll = nll * mask
            denom = _clip(mask.sum(), 1.0)
        else:
            denom = nll.numel()
        if self.normalize_mode == "NONE":
            return nll.sum()
        return nll.sum() / denom


class PGCriterion(Criterion):
    """Policy gradient: ``-sum(target * log(p))``, ``p`` clipped into
    ``[1e-8, 1]``, the target one-hot action times advantage (reference:
    nn/PGCriterion.scala)."""

    def __init__(self, size_average=False):
        self.size_average = size_average

    def apply(self, input, target):
        loss = -(target * torch.log(_clip(input, 1e-8, 1.0))).sum(-1)
        return _mean_or_sum(loss, self.size_average)
