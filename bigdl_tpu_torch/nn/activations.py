"""Element-wise activation and math layers (counterpart of
``bigdl_tpu/nn/activations.py:25-257``).

Each follows the JAX expression, including its choices at the kinks
where PyTorch's built-ins differ: ``LeakyReLU`` and ``PReLU`` keep ``x``
at ``x >= 0`` (gradient 1 at 0), ``GELU`` is the tanh approximation
(``jax.nn.gelu``'s default) and ``SoftPlus`` is the exact
``log(1 + e^(beta x)) / beta``, with no linear cut-over.  An element-wise
layer maps every tensor of a table (a tuple or list) alike.
"""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


def _map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, e) for e in x)
    return fn(x)


class _Elementwise(Module):
    def fn(self, x):
        raise NotImplementedError

    def forward(self, x):
        return _map(self.fn, x)


class ReLU(_Elementwise):
    def fn(self, x):
        return torch.relu(x)


class Tanh(_Elementwise):
    def fn(self, x):
        return torch.tanh(x)


class Sigmoid(_Elementwise):
    def fn(self, x):
        return torch.sigmoid(x)


class SoftMax(Module):
    """Softmax over ``axis`` (default the last)."""

    def __init__(self, axis=-1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.softmax(x, dim=self.axis)


class SoftMin(Module):
    def forward(self, x):
        return torch.softmax(-x, dim=-1)


class LogSoftMax(Module):
    """Log-softmax over the last dimension."""

    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


class HardTanh(_Elementwise):
    def __init__(self, min_value=-1.0, max_value=1.0, name=None):
        super().__init__(name)
        self.min_value, self.max_value = min_value, max_value

    def fn(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class Clamp(HardTanh):
    def __init__(self, min_value, max_value, name=None):
        super().__init__(min_value, max_value, name)


class ReLU6(HardTanh):
    def __init__(self, name=None):
        super().__init__(0.0, 6.0, name)


class ELU(_Elementwise):
    def __init__(self, alpha=1.0, name=None):
        super().__init__(name)
        self.alpha = alpha

    def fn(self, x):
        return F.elu(x, self.alpha)


class SoftPlus(_Elementwise):
    def __init__(self, beta=1.0, name=None):
        super().__init__(name)
        self.beta = beta

    def fn(self, x):
        bx = self.beta * x
        return torch.logaddexp(bx, torch.zeros_like(bx)) / self.beta


class SoftSign(_Elementwise):
    def fn(self, x):
        return x / (1.0 + torch.abs(x))


class LeakyReLU(_Elementwise):
    def __init__(self, negval=0.01, name=None):
        super().__init__(name)
        self.negval = negval

    def fn(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class Threshold(_Elementwise):
    def __init__(self, threshold=1e-6, value=0.0, name=None):
        super().__init__(name)
        self.threshold, self.value = threshold, value

    def fn(self, x):
        return torch.where(x > self.threshold, x,
                           torch.full_like(x, self.value))


class HardSigmoid(_Elementwise):
    def fn(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class LogSigmoid(_Elementwise):
    def fn(self, x):
        return F.logsigmoid(x)


class TanhShrink(_Elementwise):
    def fn(self, x):
        return x - torch.tanh(x)


class SoftShrink(_Elementwise):
    def __init__(self, lam=0.5, name=None):
        super().__init__(name)
        self.lam = lam

    def fn(self, x):
        zero = torch.zeros_like(x)
        return torch.where(x > self.lam, x - self.lam,
                           torch.where(x < -self.lam, x + self.lam, zero))


class HardShrink(_Elementwise):
    def __init__(self, lam=0.5, name=None):
        super().__init__(name)
        self.lam = lam

    def fn(self, x):
        return torch.where(torch.abs(x) > self.lam, x, torch.zeros_like(x))


class Power(_Elementwise):
    """``(shift + scale * x) ** power``."""

    def __init__(self, power, scale=1.0, shift=0.0, name=None):
        super().__init__(name)
        self.power, self.scale, self.shift = power, scale, shift

    def fn(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Square(_Elementwise):
    def fn(self, x):
        return torch.square(x)


class Sqrt(_Elementwise):
    def fn(self, x):
        return torch.sqrt(x)


class Abs(_Elementwise):
    def fn(self, x):
        return torch.abs(x)


class Exp(_Elementwise):
    def fn(self, x):
        return torch.exp(x)


class Log(_Elementwise):
    def fn(self, x):
        return torch.log(x)


class Negative(_Elementwise):
    def fn(self, x):
        return -x


class MulConstant(_Elementwise):
    def __init__(self, scalar, name=None):
        super().__init__(name)
        self.scalar = scalar

    def fn(self, x):
        return x * self.scalar


class AddConstant(_Elementwise):
    def __init__(self, constant, name=None):
        super().__init__(name)
        self.constant = constant

    def fn(self, x):
        return x + self.constant


class GELU(_Elementwise):
    def fn(self, x):
        return F.gelu(x, approximate="tanh")


class SiLU(_Elementwise):
    def fn(self, x):
        return F.silu(x)


class PReLU(Module):
    """Learnable leaky slope: ``n_output_plane=0`` one shared slope, else
    one per channel (the last axis, NHWC); initialised to 0.25."""

    def __init__(self, n_output_plane=0, name=None):
        super().__init__(name)
        self.n_output_plane = n_output_plane
        n = n_output_plane if n_output_plane > 0 else 1
        self.weight = torch.nn.Parameter(torch.full((n,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)
