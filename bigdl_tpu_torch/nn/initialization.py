"""Weight initialization (counterpart of ``bigdl_tpu/nn/initialization.py``).

Draws come from an explicit CPU ``torch.Generator``.  They cannot match
``jax.random`` from the same seed, so parity with the JAX package always
goes through the weight bridge (``interop/jax_params.py``).
"""

import math

import torch


class InitializationMethod:
    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)


class Xavier(InitializationMethod):
    """Glorot uniform: U(+-sqrt(6 / (fan_in + fan_out)))."""

    def init(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        bound = math.sqrt(6.0 / max(fan_in + fan_out, 1))
        return torch.empty(shape, dtype=dtype).uniform_(
            -bound, bound, generator=generator)


def normal(generator, shape, std, dtype=torch.float32):
    """N(0, std^2) draws (the embedding and head tables' init)."""
    return std * torch.randn(shape, dtype=dtype, generator=generator)
