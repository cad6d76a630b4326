"""Linear layer (counterpart of ``bigdl_tpu/nn/linear.py``): weight
``(out, in)``, ``y = x @ W.T + b`` (:66); an int8 twin's layer holds
``weight_q``/``scale`` instead and contracts in int8 (:53-62)."""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import Xavier, Zeros
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.quantized import int8_matmul


class Linear(Module):
    """The JAX layer's constructor (Xavier weight and zero bias by
    default, ``with_bias``, the init methods, regularizers and ``name``)
    plus the port's ``generator``, which the weights are drawn from.
    The parameters exist from construction, so ``input_size`` is
    required (JAX can infer it at its first build)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, weight_init=None, bias_init=None,
                 w_regularizer=None, b_regularizer=None, name=None,
                 generator=None):
        super().__init__(name)
        if input_size is None:
            raise ValueError("Linear: input_size is required (the port "
                             "builds the weight at construction)")
        self.input_size = int(input_size)
        self.output_size = int(output_size)
        self.with_bias = bool(with_bias)
        self.set_regularizer(w_regularizer, b_regularizer)
        fans = (self.input_size, self.output_size)
        self.weight = torch.nn.Parameter((weight_init or Xavier()).init(
            generator, (self.output_size, self.input_size), *fans))
        if self.with_bias:
            self.bias = torch.nn.Parameter((bias_init or Zeros()).init(
                generator, (self.output_size,), *fans))
        else:
            self.bias = None

    def forward(self, x):
        if "weight_q" in self._parameters:
            # the int8 twin (nn/quantized.quantize_model): exact int32
            # contraction, bias added in fp32, cast like the float path
            y = int8_matmul(x, self.weight_q, self.scale)
            if self.bias is not None:
                y = y + self.bias
            return y.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))
