"""Blockwise int8 quantization and the data-parallel wire formats
(counterpart of ``bigdl_tpu/ops/quantization.py``: ``CompressionSpec``
:64-224, ``uncompressed_wire_summary`` :226, ``_scale_for`` :240,
``quantize_blockwise`` :265, ``dequantize_blockwise`` :306 and
``quantized_reduce_chunks`` :318).

The int8 KV pool stores every K/V ``head_dim`` vector in this format: an
int8 payload plus one absmax scale per block of ``block_size`` values
(the quantization block is the head_dim vector).  Nearest rounding is
half to even, as ``jnp.round`` (``torch.round`` does the same).

The data-parallel step (``optim/distri_optimizer.py``) uses the same
format on its wire: ``CompressionSpec`` declares it (fp32, a bf16/fp16
cast, or blockwise int8 with optional stochastic rounding, error
feedback and a compressed weight gather) and counts its bytes;
``quantized_reduce_chunks`` is the int8 reduction and
``cast_reduce_chunks`` the cast one.  Stochastic rounding
draws its uniforms from a counter-based hash (``nn/dropout.py``'s) of a
key and each element's index, so a captured step draws new values at
every replay with no host involvement; the key comes from a
``torch.Generator`` (or is a 0-d int64 key tensor already).  It cannot
match JAX's threefry bits: it is held by determinism, bias and bounds.
"""

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

#: the wire-format vocabulary, narrowest last
WIRE_FORMATS = ("fp32", "bf16", "fp16", "int8")

#: alias spellings -> canonical wire name (the JAX package's set)
_WIRE_ALIASES = {
    "fp32": "fp32", "float32": "fp32", "f32": "fp32", "none": "fp32",
    "bf16": "bf16", "bfloat16": "bf16",
    "fp16": "fp16", "float16": "fp16", "f16": "fp16", "half": "fp16",
    "int8": "int8", "q8": "int8",
}

_SCALE_BYTES = {"bf16": 2, "fp32": 4}
_WIRE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "fp16": torch.float16, "int8": None}


@dataclass(frozen=True)
class CompressionSpec:
    """Declarative wire format of the data-parallel collectives.

    ``wire``: ``"fp32"`` (uncompressed), ``"bf16"`` / ``"fp16"`` (the
    gradient cast to that dtype for the reduction) or ``"int8"``
    (blockwise, per-block absmax scales).  ``block_size``: elements per
    int8 block; the ZeRO-1 chunk layout rounds to it
    (``parallel.zero.FlatParamSpace(block_size=)``).  ``stochastic``:
    unbiased stochastic rounding instead of nearest.
    ``error_feedback``: each rank keeps its accumulated quantization
    error and adds it to the next step's gradient (int8 only).
    ``scale_dtype``: ``"bf16"`` or ``"fp32"``.
    ``compress_weight_gather``: the weight gather carries the update's
    int8 delta, applied to the replicated fp32 masters (int8 only)."""

    wire: str = "fp32"
    block_size: int = 256
    stochastic: bool = False
    error_feedback: bool = False
    scale_dtype: str = "bf16"
    compress_weight_gather: bool = False

    def __post_init__(self):
        if self.wire not in WIRE_FORMATS:
            raise ValueError(
                f"unknown wire format {self.wire!r}; expected one of "
                f"{WIRE_FORMATS} (or an alias spelling via parse())")
        if int(self.block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.scale_dtype not in _SCALE_BYTES:
            raise ValueError(
                f"scale_dtype must be one of {tuple(_SCALE_BYTES)}, "
                f"got {self.scale_dtype!r}")
        if self.error_feedback and self.wire != "int8":
            raise ValueError(
                "error_feedback rides the quantized step only (fp32 has "
                "no error to feed back; the bf16/fp16 cast path carries "
                f"no residual plane): wire={self.wire!r} -- use "
                "wire='int8' or drop error_feedback")
        if self.compress_weight_gather and self.wire != "int8":
            raise ValueError(
                "compress_weight_gather rides the int8 block format; "
                f"wire={self.wire!r} has no blockwise payload to share")

    @classmethod
    def parse(cls, spec) -> Optional["CompressionSpec"]:
        """Any accepted ``grad_compression=`` spelling -> spec, or None
        for the plain fp32 reduction: None, a ``CompressionSpec``
        (``wire="fp32"`` gives None), a dict of its fields, a wire name
        or alias string, a torch dtype (``torch.bfloat16``), or a numpy
        dtype-like (``np.float16``, and JAX's ``jnp.bfloat16``)."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return None if spec.wire == "fp32" else spec
        if isinstance(spec, dict):
            return cls.parse(cls(**spec))
        if isinstance(spec, str):
            name = _WIRE_ALIASES.get(spec.lower())
            if name is None:
                raise ValueError(
                    f"unknown grad_compression {spec!r}; expected one of "
                    f"{sorted(set(_WIRE_ALIASES))} or a CompressionSpec")
            return cls.parse(cls(wire=name))
        if isinstance(spec, torch.dtype):
            name = str(spec).rpartition(".")[2]
        else:
            try:
                name = np.dtype(spec).name
            except TypeError:
                raise ValueError(
                    f"cannot interpret grad_compression={spec!r}; pass a "
                    f"CompressionSpec, a wire-format string or a dtype")
        return cls.parse(cls(wire=_WIRE_ALIASES.get(name, name)))

    def with_options(self, **kw) -> "CompressionSpec":
        return replace(self, **kw)

    @property
    def quantized(self) -> bool:
        return self.wire == "int8"

    @property
    def wire_dtype(self):
        """The torch dtype of the cast path (None for int8)."""
        return _WIRE_DTYPES[self.wire]

    @property
    def scale_bytes(self) -> int:
        return _SCALE_BYTES[self.scale_dtype]

    def n_blocks(self, n: int) -> int:
        assert n % self.block_size == 0, (n, self.block_size)
        return n // self.block_size

    def grad_wire_bytes(self, n: int) -> int:
        """Per-rank bytes of the gradient reduction over ``n`` padded
        elements (payload and scales for int8)."""
        if self.wire == "int8":
            return n + self.n_blocks(n) * self.scale_bytes
        return n * {"fp32": 4, "bf16": 2, "fp16": 2}[self.wire]

    def weight_wire_bytes(self, n: int) -> int:
        """Per-rank bytes of the weight gather (the int8 delta and its
        scales with ``compress_weight_gather``, fp32 otherwise)."""
        if self.compress_weight_gather:
            return n + self.n_blocks(n) * self.scale_bytes
        return n * 4

    def wire_summary(self, n: int) -> dict:
        """Per-step, per-rank wire bytes of both collectives and the
        compression ratio against fp32 both ways."""
        grad = self.grad_wire_bytes(n)
        weight = self.weight_wire_bytes(n)
        raw = 8 * n
        return {
            "wire_bytes": grad + weight,
            "grad_wire_bytes": grad,
            "weight_wire_bytes": weight,
            "compression_ratio": round(raw / max(grad + weight, 1), 4),
            "grad_compression_ratio": round(4 * n / max(grad, 1), 4),
        }


def uncompressed_wire_summary(n: int) -> dict:
    """The fp32 step's wire fields (ratio 1.0 by definition)."""
    return {
        "wire_bytes": 8 * n, "grad_wire_bytes": 4 * n,
        "weight_wire_bytes": 4 * n,
        "compression_ratio": 1.0, "grad_compression_ratio": 1.0,
    }

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


def uniform_from_key(key, n, device, salt=0):
    """``n`` fp32 values in [0, 1), 24 bits each of the counter-based
    hash of the 0-d int64 ``key``, ``salt`` and each index."""
    from bigdl_tpu_torch.nn.dropout import hash_bits

    bits = hash_bits(key, salt, n, device)
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _key_of(rng, device):
    if isinstance(rng, torch.Generator):
        seed = int(torch.randint(0, 2 ** 31, (), generator=rng))
        return torch.tensor(seed, dtype=torch.int64, device=device)
    return rng


def quantize_blockwise(x, block_size, scale_dtype=None, *, stochastic=False,
                       rng=None, salt=0):
    """1-D float vector -> ``(int8 payload, per-block scales)``.

    ``x.numel()`` must be a multiple of ``block_size``.  ``scale_dtype``
    is ``torch.bfloat16`` (the default, as in the JAX package),
    ``torch.float32`` or its short name ``"bf16"`` / ``"fp32"``.  The
    round trip errs by at most half the block's stored scale per element
    with nearest rounding.

    ``stochastic=True`` rounds ``floor(x / scale + U[0, 1))``: unbiased,
    within one stored scale per element.  ``rng`` is a ``torch.Generator``
    (one key is drawn from it) or a 0-d int64 key tensor; ``salt`` tells
    apart two draws from one key.  A fixed generator state gives the same
    payload.

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
    y = xb / safe[:, None]
    if stochastic:
        if rng is None:
            raise ValueError("stochastic rounding needs an rng (a "
                             "torch.Generator or a key tensor)")
        u = uniform_from_key(_key_of(rng, x.device), y.numel(), x.device,
                             salt)
        y = torch.floor(y + u.reshape(y.shape))
    else:
        y = torch.round(y)
    y = y.clamp(-127, 127)
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


def quantized_reduce_chunks(gflat, num_chunks, collectives, spec, rng=None):
    """The int8 wire of the data-parallel gradient reduction: quantize
    this rank's full flat gradient, ``all_to_all`` the payload and the
    scales chunk by chunk (chunk ``j`` of every rank lands on rank
    ``j``), dequantize each sender's view of this rank's chunk and sum
    them in fp32 in rank order.  Returns ``(chunk_sum, local_error)``:
    ``local_error`` is ``gflat - deq(q)`` over the full length, with
    non-finite values dropped, the residual error feedback carries.
    ``collectives`` is a ``parallel.collectives.Collectives``; ``rng``
    (stochastic rounding) a generator or key tensor."""
    chunk = gflat.numel() // num_chunks
    q, scales = quantize_blockwise(
        gflat, spec.block_size, spec.scale_dtype,
        stochastic=spec.stochastic, rng=rng, salt=0x5149)
    err = gflat - dequantize_blockwise(q, scales, spec.block_size)
    err = torch.where(torch.isfinite(err), err, torch.zeros_like(err))
    qt = collectives.all_to_all(q.reshape(num_chunks, chunk))
    st = collectives.all_to_all(
        scales.reshape(num_chunks, chunk // spec.block_size))
    contrib = dequantize_blockwise(qt, st, spec.block_size)
    total = contrib[0].clone()
    for j in range(1, num_chunks):
        total += contrib[j]
    return total, err


#: the dtype a cast wire's chunks are summed in: XLA's on its CPU mesh,
#: which widens bf16 to fp32 and sums fp16 as fp16
_CAST_ACCUMULATE = {torch.bfloat16: torch.float32,
                    torch.float16: torch.float16}


def cast_reduce_chunks(gflat, num_chunks, collectives, wire_dtype):
    """The cast wire of the data-parallel gradient reduction: this
    rank's flat gradient cast to ``wire_dtype``, ``all_to_all`` chunk by
    chunk, and the senders' chunks summed in rank order; returns this
    rank's chunk in fp32.  This is JAX's ``psum_scatter`` of the cast
    gradient as XLA computes it on its CPU mesh, bit for bit: bf16 is
    summed in fp32 and rounded once, fp16 is rounded after every
    addition.  The wire carries the bytes a reduce-scatter would."""
    chunk = gflat.numel() // num_chunks
    parts = collectives.all_to_all(
        gflat.to(wire_dtype).reshape(num_chunks, chunk))
    total = parts[0].to(_CAST_ACCUMULATE[wire_dtype], copy=True)
    for j in range(1, num_chunks):
        total += parts[j]
    return total.to(wire_dtype).to(torch.float32)
