"""Linear layer (counterpart of ``bigdl_tpu/nn/linear.py``): weight
``(out, in)``, ``y = x @ W.T + b`` (:66)."""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import Xavier, Zeros
from bigdl_tpu_torch.nn.module import Module


class Linear(Module):
    """Xavier weight, zero bias (the JAX layer's defaults)."""

    def __init__(self, input_size: int, output_size: int, generator=None):
        super().__init__()
        self.input_size = int(input_size)
        self.output_size = int(output_size)
        fans = (self.input_size, self.output_size)
        self.weight = torch.nn.Parameter(Xavier().init(
            generator, (self.output_size, self.input_size), *fans))
        self.bias = torch.nn.Parameter(Zeros().init(
            generator, (self.output_size,), *fans))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
