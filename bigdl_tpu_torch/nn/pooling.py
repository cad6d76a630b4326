"""Pooling layers (counterpart of ``bigdl_tpu/nn/pooling.py``).

JAX pools with ``lax.reduce_window`` over explicit ``(lo, hi)`` pads
from ``_pool_pads`` (:16-27), whose high side is ``max(..., p)``: in ceil
mode, and whenever the last window would stop short, the high pad
differs from the low one.  With ``count_include_pad`` JAX divides every
window by ``kh * kw``, the windows that reach into that extra high pad
included (:92-93).  PyTorch's ``ceil_mode`` clips such windows instead,
so here the pads are applied explicitly (-inf for max, 0 for average)
and the pooling runs unpadded, dividing as JAX does.
"""

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


def _pool_pads(in_size, k, s, p, ceil_mode):
    """``(lo, hi)`` padding of one spatial dim (floor or ceil mode)."""
    if ceil_mode:
        out = int(math.ceil((in_size + 2 * p - k) / s)) + 1
        # the last window must start inside the (left-)padded input
        if (out - 1) * s >= in_size + p:
            out -= 1
    else:
        out = int(math.floor((in_size + 2 * p - k) / s)) + 1
    hi = max((out - 1) * s + k - in_size - p, p)
    return p, hi


class _SpatialPool(Module):
    def __init__(self, kernel_w, kernel_h, stride_w=None, stride_h=None,
                 pad_w=0, pad_h=0, ceil_mode=False, data_format="NHWC",
                 name=None):
        super().__init__(name)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h or kernel_h, stride_w or kernel_w)
        self.pad = (pad_h, pad_w)
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def ceil(self):
        self.ceil_mode = True
        return self

    def _padded(self, x, value):
        """The NHWC batch padded as JAX pads it, as an NCHW view."""
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.pad
        h0, h1 = _pool_pads(x.shape[1], kh, sh, ph, self.ceil_mode)
        w0, w1 = _pool_pads(x.shape[2], kw, sw, pw, self.ceil_mode)
        if h0 or h1 or w0 or w1:
            x = F.pad(x, (0, 0, w0, w1, h0, h1), value=value)
        return x.permute(0, 3, 1, 2)

    def forward(self, x):
        if self.data_format == "NCHW":
            x = x.permute(0, 2, 3, 1)
        y = self._pool(x).permute(0, 2, 3, 1)
        if self.data_format == "NCHW":
            y = y.permute(0, 3, 1, 2)
        return y


class SpatialMaxPooling(_SpatialPool):
    """Max pooling, floor mode by default (``.ceil()`` switches)."""

    def _pool(self, x):
        low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
        return F.max_pool2d(self._padded(x, low), self.kernel, self.stride)


class SpatialAveragePooling(_SpatialPool):
    """Average pooling: ``count_include_pad=True`` (the reference's
    default) divides by the kernel's size, else by the window's valid
    elements."""

    def __init__(self, *args, count_include_pad=True, **kw):
        super().__init__(*args, **kw)
        self.count_include_pad = count_include_pad

    def _pool(self, x):
        y = F.avg_pool2d(self._padded(x, 0.0), self.kernel, self.stride)
        if self.count_include_pad:
            return y
        ones = torch.ones((1, x.shape[1], x.shape[2], 1), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(self._padded(ones, 0.0), self.kernel,
                              self.stride)
        return y / counts


class GlobalAveragePooling2D(Module):
    """Mean over the spatial dims."""

    def __init__(self, data_format="NHWC", name=None):
        super().__init__(name)
        self.data_format = data_format

    def forward(self, x):
        return x.mean(dim=(1, 2) if self.data_format == "NHWC" else (2, 3))


class GlobalMaxPooling2D(Module):
    """Max over the spatial dims."""

    def __init__(self, data_format="NHWC", name=None):
        super().__init__(name)
        self.data_format = data_format

    def forward(self, x):
        return x.amax(dim=(1, 2) if self.data_format == "NHWC" else (2, 3))
