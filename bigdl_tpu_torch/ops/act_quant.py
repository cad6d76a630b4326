"""Per-tensor int8 activation quantization: one hand-written CUDA source
(K6q, ``csrc/act_quant.cu``, three routes) and its plain PyTorch version.

Counterpart of ``bigdl_tpu/nn/quantized.py:88`` ``_quantize_activation``
(pure JAX, no ``pallas_call``), which every ``int8_conv`` and
``int8_matmul`` runs on its input:

    act_quant(x) -> (x_q, x_scale)
        x_scale = max(max |x|, 1e-8) / 127          fp32, 0-d, on x's device
        x_q     = clamp(round(x / x_scale), -127, 127).to(int8)

for fp32 or bf16 ``x`` of any shape (the scale over EVERY element).  Both
quotients are IEEE divisions, ``round`` is half to even, and a NaN in
``x`` makes the scale NaN.  The plain version divides by a tensor on
``x``'s own device: PyTorch's CUDA division by a Python scalar multiplies
by its reciprocal (one rounding more), its CPU division does not, and the
JAX package's eager ``/ 127.0`` is the IEEE quotient.

``act_quant`` picks one of three routes by what it is given and by the
input's size (``select_route``), never because something failed:

- ``act_quant_given``: ``x`` is the very tensor K7 (``ops/bn_act.py``)
  wrote, at the version it wrote (``hand_off``: kept on the tensor object
  with its ``_version``, so an in-place change, a view, a slice or a copy
  is not given), and K7 left ``max |x|`` in a 4-byte scratch: one
  quantize pass reads ``x`` once;
- ``act_quant_small``: ``x`` of at most ``SMALL_LIMIT`` elements: one
  launch of one thread-block cluster, no memset;
- ``act_quant``: a memset of a 4-byte scratch, the absmax pass and the
  quantize pass.

The wrapper sends a CPU tensor to the plain version of its route (the
given route's plain version reads the absmax K7's plain version left), so
the routes' choice runs, and is tested, on the CPU too; a CUDA tensor goes
to the kernel, on the current stream (a CUDA graph replays every node), or
the call raises (no fallback).  ``LAUNCHES[route]`` counts one a
quantization on the card, through ``flash_attention``'s ``count_launch``,
so CUDA graph replays add them.

Inside ``quantize_once()`` each tensor version is quantized once: the
fused eval plan (``nn/fused.py``) runs a residual block's two branches in
it, so a downsampling block's ``conv1`` and its shortcut convolution share
the quantization of the block's input.
"""

import contextlib
import threading

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.flash_attention import (_raise_on, _stream,
                                                  count_launch,
                                                  register_launch_table,
                                                  sm_count)

ROUTES = ("act_quant", "act_quant_given", "act_quant_small")

#: kernel launches since the last ``reset_launch_counts()``, by route
LAUNCHES = dict.fromkeys(ROUTES, 0)

register_launch_table("act_quant", LAUNCHES)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the small route's largest input, in elements: up to it one cluster's
#: launch beats the three-node route on the card at every size measured,
#: fp32 and bf16 (``tools/torch_act_quant_limit.py``; PERF.md)
SMALL_LIMIT = 98304
#: elements a block of the small route takes (1024 threads, two 16-byte
#: vectors each in fp32), and its most blocks (the portable cluster size)
SMALL_BLOCK_ELEMENTS = 8192
SMALL_MAX_BLOCKS = 8

_HAND_OFF = "_k6q_absmax"
_scope = threading.local()


def reset_launch_counts():
    for route in ROUTES:
        LAUNCHES[route] = 0


def _version(t):
    """``t._version``, or None for an inference tensor, which keeps none
    (an in-place change would not show)."""
    return None if t.is_inference() else t._version


def hand_off(y, absmax_bits):
    """Record on ``y`` that ``absmax_bits`` (one int32 element: the bits of
    ``max |y|``, written on ``y``'s stream ahead of any later use) holds
    ``y``'s absmax at ``y``'s current version (K7 calls this)."""
    version = _version(y)
    if version is not None:
        y.__dict__[_HAND_OFF] = (version, absmax_bits)


def handed_off_absmax(x):
    """The absmax bits handed off with ``x`` if ``x`` is still at the
    version its producer wrote, else None."""
    entry = x.__dict__.get(_HAND_OFF)
    if entry is None or entry[0] != _version(x):
        return None
    return entry[1]


def select_route(x):
    """``(route, absmax_bits or None)`` for ``x`` (module docstring)."""
    absmax = handed_off_absmax(x)
    if absmax is not None:
        return "act_quant_given", absmax
    if x.numel() <= SMALL_LIMIT:
        return "act_quant_small", None
    return "act_quant", None


@contextlib.contextmanager
def quantize_once():
    """Within the block ``act_quant`` quantizes each tensor version once
    and hands the same ``(x_q, x_scale)`` to every later call on it (the
    whole block's calls are one capture or one eager run: nothing is kept
    past it)."""
    outer = getattr(_scope, "done", None)
    if outer is None:
        _scope.done = {}
    try:
        yield
    finally:
        if outer is None:
            _scope.done = None


def _quantize_plain(x32, absmax):
    absmax = absmax.clamp_min(1e-8)
    scale = absmax / absmax.new_full((), 127.0)
    x_q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return x_q, scale


def act_quant_reference(x):
    """The plain version: the same roundings on the CPU and the card."""
    x32 = x.to(torch.float32)
    return _quantize_plain(x32, x32.abs().amax())


def act_quant_given_reference(x, absmax_bits):
    """The given route's plain version: the absmax read from the bits
    ``x``'s producer left (exact, so the result is the plain version's)."""
    absmax = absmax_bits.reshape(()).view(torch.float32)
    return _quantize_plain(x.to(torch.float32), absmax)


def _on_cpu(x):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"act_quant: x must lie on the CPU (plain version) "
                         f"or a CUDA device (kernel), got {x.device}")
    return False


def _check(x):
    if x.dtype not in _DTYPES:
        raise TypeError(f"act_quant: x must be float32 or bfloat16 on the "
                        f"card, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError("act_quant: x is empty (no absmax to scale by)")


def _outputs(x):
    return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
            torch.empty((), dtype=torch.float32, device=x.device))


def small_blocks(n):
    """The small route's blocks (one cluster) for ``n`` elements."""
    return max(1, min(SMALL_MAX_BLOCKS, -(-n // SMALL_BLOCK_ELEMENTS)))


def _launch(x, route, absmax):
    _check(x)
    x = x.contiguous()
    x_q, x_scale = _outputs(x)
    lib = _build.load()
    if route == "act_quant_given":
        if absmax.device != x.device or absmax.dtype != torch.int32 or \
                absmax.numel() != 1:
            raise ValueError(f"act_quant: the absmax handed off must be one "
                             f"int32 on {x.device}, got {absmax.dtype} "
                             f"{tuple(absmax.shape)} on {absmax.device}")
        rc = lib.bigdl_act_quant_given(
            x.data_ptr(), x.numel(), _DTYPES[x.dtype], absmax.data_ptr(),
            x_q.data_ptr(), x_scale.data_ptr(), sm_count(x.device),
            _stream())
    elif route == "act_quant_small":
        rc = lib.bigdl_act_quant_small(
            x.data_ptr(), x.numel(), _DTYPES[x.dtype], x_q.data_ptr(),
            x_scale.data_ptr(), small_blocks(x.numel()), _stream())
    else:
        scratch = torch.empty(1, dtype=torch.int32, device=x.device)
        rc = lib.bigdl_act_quant(
            x.data_ptr(), x.numel(), _DTYPES[x.dtype], scratch.data_ptr(),
            x_q.data_ptr(), x_scale.data_ptr(), sm_count(x.device),
            _stream())
    _raise_on(rc, route)
    count_launch("act_quant", route)
    return x_q, x_scale


def quantize_route(x, route, absmax=None):
    """``(x_q, x_scale)`` of ``x`` through ``route`` (one of ``ROUTES``;
    ``absmax``: the bits the given route reads): the plain version on the
    CPU, the route's kernel on the card."""
    if route not in ROUTES:
        raise ValueError(f"act_quant: unknown route {route!r}")
    if _on_cpu(x):
        if route == "act_quant_given":
            return act_quant_given_reference(x, absmax)
        return act_quant_reference(x)
    return _launch(x, route, absmax)


def act_quant(x):
    """K6q (module docstring): ``(x_q int8 of x's shape, x_scale fp32
    0-d)`` through ``select_route(x)``'s route."""
    done = getattr(_scope, "done", None)
    version = _version(x) if done is not None else None
    if version is not None:
        hit = done.get(id(x))
        if hit is not None and hit[0] is x and hit[1] == version:
            return hit[2]
    out = quantize_route(x, *select_route(x))
    if version is not None:
        done[id(x)] = (x, version, out)
    return out
