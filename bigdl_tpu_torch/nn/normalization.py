"""Layer norm (counterpart of ``bigdl_tpu/nn/normalization.py``
``LayerNorm`` :112).

The statistics follow the JAX layer exactly (:127-139): fp32 mean and
mean of squares, variance ``E[x^2] - mean^2`` clamped at 0, eps 1e-6.
That is not ``F.layer_norm`` (eps 1e-5, a two-pass variance).
"""

import torch

from bigdl_tpu_torch.nn.module import Module


class LayerNorm(Module):
    def __init__(self, n_output: int, eps: float = 1e-6):
        super().__init__()
        self.n_output = int(n_output)
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(self.n_output))
        self.bias = torch.nn.Parameter(torch.zeros(self.n_output))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        sq = xf.square().mean(dim=-1, keepdim=True)
        var = (sq - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + self.eps)
        dt = x.dtype
        y = (x - mean.to(dt)) * inv.to(dt)
        return y * self.weight.to(dt) + self.bias.to(dt)
