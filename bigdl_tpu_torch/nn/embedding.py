"""Embedding lookup (counterpart of ``bigdl_tpu/nn/embedding.py``
``LookupTable`` :14).

Three rules of the JAX layer that ``F.embedding`` does not keep:

- ``max_norm`` renormalises the rows FUNCTIONALLY, in the forward:
  ``F.embedding(max_norm=)`` rewrites the weight in place;
- indices are clipped into ``[0, n_index)``;
- rows whose index equals ``padding_value`` give a zero OUTPUT, where
  ``F.embedding(padding_idx=)`` returns the row and zeroes its gradient.
"""

import torch

from bigdl_tpu_torch.nn.module import Module


class LookupTable(Module):
    """``input``: integer indices (0-based), any shape; the output gains
    a trailing ``n_output`` axis.  The weight ``(n_index, n_output)`` is
    drawn from N(0, 1) (the JAX layer's ``RandomNormal(0, 1)``) with
    ``generator``."""

    def __init__(self, n_index, n_output, padding_value=None, max_norm=None,
                 norm_type=2.0, generator=None, name=None):
        super().__init__(name)
        self.n_index = int(n_index)
        self.n_output = int(n_output)
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.weight = torch.nn.Parameter(torch.randn(
            (self.n_index, self.n_output), generator=generator))

    def forward(self, input):
        w = self.weight
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=-1,
                                             keepdim=True)
            one = torch.ones((), dtype=w.dtype, device=w.device)
            floor = torch.full((), 1e-12, dtype=w.dtype, device=w.device)
            # jnp.minimum / jnp.maximum: a tie splits the gradient
            w = w * torch.minimum(one, self.max_norm
                                  / torch.maximum(norms, floor))
        idx = input.long()
        y = w[idx.clamp(0, self.n_index - 1)]
        if self.padding_value is not None:
            y = torch.where((idx == self.padding_value)[..., None],
                            torch.zeros_like(y), y)
        return y
