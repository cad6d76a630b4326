"""Weight initialization (counterpart of ``bigdl_tpu/nn/initialization.py``).

Draws come from an explicit CPU ``torch.Generator`` (None: torch's
default generator).  They cannot match ``jax.random`` from the same seed,
so parity with the JAX package always goes through the weight bridge
(``interop/jax_params.py``).
"""

import math

import torch


class InitializationMethod:
    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)


class Ones(InitializationMethod):
    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value):
        self.value = value

    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.full(shape, self.value, dtype=dtype)


class RandomUniform(InitializationMethod):
    """U(lower, upper); without bounds the Torch fan-in heuristic
    U(+-1/sqrt(fan_in))."""

    def __init__(self, lower=None, upper=None):
        self.lower, self.upper = lower, upper

    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        if self.lower is None:
            bound = 1.0 / math.sqrt(max(fan_in, 1))
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, dtype=dtype).uniform_(
            lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    def __init__(self, mean=0.0, stdv=1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return self.mean + self.stdv * torch.randn(
            shape, dtype=dtype, generator=generator)


class Xavier(InitializationMethod):
    """Glorot uniform: U(+-sqrt(6 / (fan_in + fan_out)))."""

    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        bound = math.sqrt(6.0 / max(fan_in + fan_out, 1))
        return torch.empty(shape, dtype=dtype).uniform_(
            -bound, bound, generator=generator)


class MsraFiller(InitializationMethod):
    """He / MSRA normal: std sqrt(2 / n), n the mean of the fans (or
    ``fan_in`` with ``variance_norm_average=False``)."""

    def __init__(self, variance_norm_average=True):
        self.variance_norm_average = variance_norm_average

    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        n = (fan_in + fan_out) / 2.0 if self.variance_norm_average \
            else fan_in
        std = math.sqrt(2.0 / max(n, 1))
        return std * torch.randn(shape, dtype=dtype, generator=generator)


class BilinearFiller(InitializationMethod):
    """The bilinear-interpolation kernel of an upsampling deconvolution,
    built over the LEADING two (spatial) axes of an HWIO weight and
    broadcast across the channel axes, as the JAX method does."""

    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        kh, kw = shape[0], shape[1]
        if kh != kw:
            raise ValueError(f"Kernel {kh} x {kw} must be square")
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(kw, dtype=dtype)
        y = torch.arange(kh, dtype=dtype)
        wx = 1.0 - torch.abs(x / f - c)
        wy = 1.0 - torch.abs(y / f - c)
        kernel = (wy[:, None] * wx[None, :]).reshape(
            (kh, kw) + (1,) * (len(shape) - 2))
        return kernel.expand(tuple(shape)).to(dtype).clone()


def normal(generator, shape, std, dtype=torch.float32):
    """N(0, std^2) draws (the embedding and head tables' init)."""
    return std * torch.randn(shape, dtype=dtype, generator=generator)
