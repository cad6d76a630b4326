"""Per-tensor int8 activation quantization: one hand-written CUDA kernel
pair (K6q, ``csrc/act_quant.cu``) and its plain PyTorch version.

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

The wrapper sends a CPU tensor to the plain version and a CUDA tensor to
the kernel (a memset of its 4-byte scratch, the absmax pass, the
quantize pass, all on the current stream, so a CUDA graph replays all
three); it raises on anything the kernel does not take (no fallback).
``LAUNCHES["act_quant"]`` counts one a quantization, through
``flash_attention``'s ``count_launch``, so CUDA graph replays add them.
"""

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.flash_attention import (_raise_on, _stream,
                                                  count_launch,
                                                  register_launch_table,
                                                  sm_count)

#: kernel launches since the last ``reset_launch_counts()``
LAUNCHES = {"act_quant": 0}

register_launch_table("act_quant", LAUNCHES)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    LAUNCHES["act_quant"] = 0


def act_quant_reference(x):
    """The plain version: the same roundings on the CPU and the card."""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax().clamp_min(1e-8)
    scale = absmax / absmax.new_full((), 127.0)
    x_q = torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)
    return x_q, scale


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


def act_quant(x):
    """K6q (module docstring): ``(x_q int8 of x's shape, x_scale fp32
    0-d)``."""
    if _on_cpu(x):
        return act_quant_reference(x)
    _check(x)
    x = x.contiguous()
    x_q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    x_scale = torch.empty((), dtype=torch.float32, device=x.device)
    scratch = torch.empty(1, dtype=torch.int32, device=x.device)
    rc = _build.load().bigdl_act_quant(
        x.data_ptr(), x.numel(), _DTYPES[x.dtype], scratch.data_ptr(),
        x_q.data_ptr(), x_scale.data_ptr(), sm_count(x.device), _stream())
    _raise_on(rc, "act_quant")
    count_launch("act_quant", "act_quant")
    return x_q, x_scale
