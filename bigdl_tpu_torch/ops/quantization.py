"""Blockwise int8 quantization (counterpart of
``bigdl_tpu/ops/quantization.py`` ``_scale_for`` :240,
``quantize_blockwise`` :265 and ``dequantize_blockwise`` :306).

The int8 KV pool stores every K/V ``head_dim`` vector in this format: an
int8 payload plus one absmax scale per block of ``block_size`` values
(the quantization block is the head_dim vector).  Nearest rounding only,
half to even as ``jnp.round`` (``torch.round`` does the same); stochastic
rounding and the quantized gradient reduction belong to the distributed
path, which the port does not have yet.
"""

import torch

_SCALE_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _scale_for(xb, scale_dtype):
    """Per-block scale = absmax / 127, rounded UP in ``scale_dtype``.

    A narrower scale is multiplied by ``1 + 2^-8`` (one bf16 ulp) before
    the cast, so ``|x| / scale <= 127`` holds exactly and the int8 clip
    never engages.  A zero block keeps scale 0.  A non-finite absmax (a
    NaN or Inf element) also gives scale 0, so the whole block
    dequantizes to exactly 0 instead of spreading the bad value."""
    scale = xb.abs().amax(dim=-1) / 127.0
    scale = torch.where(torch.isfinite(scale), scale,
                        torch.zeros_like(scale))
    if scale_dtype != torch.float32:
        scale = (scale * (1.0 + 2.0 ** -8)).to(scale_dtype)
    return scale


def quantize_blockwise(x, block_size, scale_dtype=None):
    """1-D float vector -> ``(int8 payload, per-block scales)``.

    ``x.numel()`` must be a multiple of ``block_size``.  ``scale_dtype``
    is ``torch.bfloat16`` (the default, as in the JAX package),
    ``torch.float32`` or its short name ``"bf16"`` / ``"fp32"``.  The
    round trip errs by at most half the block's stored scale per element.

    As in the JAX package, a block whose scale is 0 because it holds a
    non-finite value divides by 1: its finite elements keep their
    clipped, rounded values in the payload (a NaN becomes 0, as XLA
    converts it), and the scale 0 zeroes the whole block on
    dequantization."""
    if scale_dtype is None:
        scale_dtype = torch.bfloat16
    elif isinstance(scale_dtype, str):
        scale_dtype = _SCALE_DTYPES[scale_dtype]
    if x.dim() != 1 or x.numel() % block_size:
        raise ValueError(f"quantize_blockwise takes a 1-D vector whose size "
                         f"is a multiple of block_size {block_size}, got "
                         f"shape {tuple(x.shape)}")
    xb = x.to(torch.float32).reshape(-1, block_size)
    scale = _scale_for(xb, scale_dtype)
    s32 = scale.to(torch.float32)
    safe = torch.where(s32 > 0, s32, torch.ones_like(s32))
    y = torch.round(xb / safe[:, None]).clamp(-127, 127)
    q = torch.nan_to_num(y, nan=0.0).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_blockwise(q, scales, block_size):
    """``(int8 payload, scales)`` -> fp32, the inverse layout of
    ``quantize_blockwise``; ``q`` may carry leading batch dims as long as
    its last extent is a multiple of ``block_size``."""
    lead = q.shape[:-1]
    body = (q.reshape(*lead, -1, block_size).to(torch.float32)
            * scales.to(torch.float32).reshape(*lead, -1, 1))
    return body.reshape(q.shape)
