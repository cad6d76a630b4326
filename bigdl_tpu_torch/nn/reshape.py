"""Shape layers (counterpart of ``bigdl_tpu/nn/reshape.py:14-187``).
Dimensions are 0-based and the batch axis is 0."""

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


class Reshape(Module):
    """The non-batch dims to ``size``; with ``batch_mode=False`` the whole
    tensor, batch included."""

    def __init__(self, size, batch_mode=None, name=None):
        super().__init__(name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode is False:
            return x.reshape(self.size)
        return x.reshape((x.shape[0],) + self.size)


class View(Reshape):
    """``Reshape`` (a -1 entry is inferred)."""


class InferReshape(Module):
    """Reshape with -1 (inferred) and 0 (the input's dim there)."""

    def __init__(self, size, batch_mode=False, name=None):
        super().__init__(name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = [in_shape[i] if s == 0 else s for i, s in enumerate(self.size)]
        if self.batch_mode:
            out = [x.shape[0]] + out
        return x.reshape(tuple(out))


class Flatten(Module):
    """All non-batch dims into one."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Squeeze(Module):
    def __init__(self, dim=None, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return x.squeeze() if self.dim is None else x.squeeze(self.dim)


class Unsqueeze(Module):
    def __init__(self, dim, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return x.unsqueeze(self.dim)


class Transpose(Module):
    """Swap the listed axis pairs, in order."""

    def __init__(self, permutations, name=None):
        super().__init__(name)
        self.permutations = permutations

    def forward(self, x):
        for a, b in self.permutations:
            x = x.transpose(a, b)
        return x


class Permute(Module):
    """A full axis permutation."""

    def __init__(self, dims, name=None):
        super().__init__(name)
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute(self.dims)


class Select(Module):
    """Index ``index`` along ``dim`` (the dim is dropped)."""

    def __init__(self, dim, index, name=None):
        super().__init__(name)
        self.dim = dim
        self.index = index

    def forward(self, x):
        return x.select(self.dim, self.index)


class Narrow(Module):
    """``length`` elements from ``offset`` along ``dim`` (a negative length
    counts back from the end)."""

    def __init__(self, dim, offset, length, name=None):
        super().__init__(name)
        self.dim = dim
        self.offset = offset
        self.length = length

    def forward(self, x):
        length = self.length
        if length < 0:
            length = x.shape[self.dim] - self.offset + 1 + length
        return x.narrow(self.dim, self.offset, length)


class Contiguous(Module):
    """The input unchanged (JAX arrays have no strides to fix)."""

    def forward(self, x):
        return x


class Padding(Module):
    """``|pad|`` entries of ``value`` along ``dim``: before when ``pad`` is
    negative, after when positive."""

    def __init__(self, dim, pad, value=0.0, name=None):
        super().__init__(name)
        self.dim = dim
        self.pad = pad
        self.value = value

    def forward(self, x):
        cfg = [0, 0] * x.dim()
        at = 2 * (x.dim() - 1 - (self.dim % x.dim()))
        cfg[at:at + 2] = [-self.pad, 0] if self.pad < 0 else [0, self.pad]
        return F.pad(x, cfg, value=self.value)


class Replicate(Module):
    """``n_features`` copies along a new axis ``dim``."""

    def __init__(self, n_features, dim=0, name=None):
        super().__init__(name)
        self.n_features = n_features
        self.dim = dim

    def forward(self, x):
        x = x.unsqueeze(self.dim)
        reps = [1] * x.dim()
        reps[self.dim] = self.n_features
        return x.repeat(reps)


class Tile(Module):
    """The input ``copies`` times along ``dim`` (``copies`` >= 2)."""

    def __init__(self, dim=0, copies=2, name=None):
        super().__init__(name)
        if copies < 2:
            raise ValueError("copies should be at least 2")
        self.dim = int(dim)
        self.copies = int(copies)

    def forward(self, x):
        reps = [1] * x.dim()
        reps[self.dim] = self.copies
        return x.repeat(reps)
