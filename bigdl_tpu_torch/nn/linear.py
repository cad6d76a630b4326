"""Linear layer (counterpart of ``bigdl_tpu/nn/linear.py``): weight
``(out, in)``, ``y = x @ W.T + b`` (:66); an int8 twin's layer holds
``weight_q``/``scale`` instead and contracts in int8 (:53-62)."""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import Xavier, Zeros
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.quantized import int8_matmul


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
        if "weight_q" in self._parameters:
            # the int8 twin (nn/quantized.quantize_model): exact int32
            # contraction, bias added in fp32, cast like the float path
            return (int8_matmul(x, self.weight_q, self.scale)
                    + self.bias).to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))
