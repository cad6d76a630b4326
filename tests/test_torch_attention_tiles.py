"""K1 / K1-bwd design choices, checked on the CPU
(``bigdl_tpu_torch/csrc/flash_attention.cu``, ``flash_attention_bwd.cu``).

(a) The wrapper's query tile size: 16 rows (one warp a block) where the
64-row grid would not fill the card's 132 SMs, else 64.

(b) The kernels' fp32 arithmetic: every product on the TF32 tensor cores
in the 3xTF32 split (x = hi + lo, each rounded to TF32 -- round to
nearest, ties away, 10-bit mantissa -- and a.b ~ lo.hi + hi.lo + hi.hi
with fp32 sums).  A plain-PyTorch emulation, TF32 rounding by bit
masking, runs the forward and the gradient's five products through that
split and is held within 1e-5 of the JAX package: the Pallas
``flash_attention`` in interpret mode, and ``jax.grad`` of
``dot_product_attention`` (``nn/attention.py:27``).  This is the evidence
that the scheme meets the port's fp32 tolerances (1e-4 on the card);
plain TF32 (one product) is shown to miss them.
"""

import math
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.flash_attention import flash_attention as jax_flash
from bigdl_tpu_torch.ops import flash_attention as fa

B, T, H, D = 2, 64, 2, 16
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,h,t,rows", [(1, 12, 200, 16), (2, 12, 1024, 64),
                                        (8, 12, 1024, 64), (1, 1, 1, 16),
                                        (11, 12, 1, 64), (1, 12, 640, 16),
                                        (1, 12, 700, 64), (8, 16, 1024, 64),
                                        (1, 16, 200, 16), (1, 16, 576, 64)])
def test_query_tile_rows(b, h, t, rows):
    """16 rows where b * h * ceil(t / 64) < 132 blocks, else 64."""
    assert fa.query_tile_rows(b, h, t) == rows


def tf32(x):
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: add half an ulp
    of the 10-bit mantissa to the magnitude bits, then drop the 13 low
    bits (ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm3(a, b):
    """``a @ b`` in 3xTF32: the three TF32 products, fp32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """``a @ b`` in plain TF32: one product."""
    return tf32(a) @ tf32(b)


def emulated_attention(q, k, v, dout, causal, mm=mm3):
    """Forward (out, lse) and gradient (dq, dk, dv) of attention with every
    product through ``mm``; (B, T, H, D) in and out, as the kernels."""
    q, k, v, dout = (x.transpose(1, 2) for x in (q, k, v, dout))
    scale = 1.0 / math.sqrt(q.shape[-1])
    t = q.shape[-2]
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~fa.causal_mask(t, t, q.device), float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = mm(p, v) / l
    lse = m + torch.log(l)
    p = torch.exp(s - lse)                       # the backward's rebuild
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (mm(dout, v.transpose(-1, -2)) - delta)
    dv = mm(p.transpose(-1, -2), dout)
    dk = mm(ds.transpose(-1, -2), q) * scale
    dq = mm(ds, k) * scale
    return [x.transpose(1, 2) for x in (out, dq, dk, dv)]


def _inputs(seed, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float32)
            for _ in range(4)]


def _jax_grads(q, k, v, dout, causal):
    return jax.grad(lambda a, b, c: jnp.sum(jax_dpa(a, b, c, causal=causal)
                                            * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("d", [D, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_forward_matches_pallas_interpret(causal, d):
    q, k, v, dout = _inputs(1, d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=32, block_k=32, interpret=True)
    out = emulated_attention(*map(torch.from_numpy, (q, k, v, dout)),
                             causal)[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [D, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_gradient_matches_jax_grad(causal, d):
    q, k, v, dout = _inputs(2, d)
    want = _jax_grads(q, k, v, dout, causal)
    got = emulated_attention(*map(torch.from_numpy, (q, k, v, dout)),
                             causal)[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_plain_tf32_misses_the_fp32_tolerance():
    """One TF32 product (what ``allow_tf32`` would give) is off by about
    1e-3: why the kernels pay three."""
    q, k, v, dout = _inputs(3)
    want = _jax_grads(q, k, v, dout, True)
    got = emulated_attention(*map(torch.from_numpy, (q, k, v, dout)), True,
                             mm=mm1)[1:]
    err = max(float(np.abs(g.numpy() - np.asarray(w)).max())
              for g, w in zip(got, want))
    assert err > 1e-4


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                      # representable in TF32
    x = torch.tensor([one, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, one, -one, 1.0, 3.0]


#: the opt-in shared memory of a block on the H100 (sm_90): 227 KB
SMEM_PER_BLOCK = 232448
SOURCES = pathlib.Path(fa.__file__).resolve().parent.parent / "csrc"


def _padded(elt, d):
    """``kPadded<T, D>`` (csrc/mma.cuh): rows padded by 16 bytes."""
    return d + 16 // elt


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("elt", [4, 2], ids=["fp32", "bf16"])
def test_head_dims_fit_the_k_steps_and_shared_memory(elt, d):
    """Every instantiated head_dim divides into the products' k-steps (8
    for 3xTF32, 16 for m16n8k16) and n-tiles (8), and K1's and K1-bwd's
    tiles fit a block's shared memory at it (D 96: 128,000 / 154,624
    bytes fp32); the formulas are read against the sources."""
    k_step = 8 if elt == 4 else 16
    assert d % k_step == 0 and d % 8 == 0
    fwd = SOURCES.joinpath("flash_attention.cu").read_text()
    bwd = SOURCES.joinpath("flash_attention_bwd.cu").read_text()
    assert "return (16 * NW + 4 * kBK) * kPadded<T, D>" in fwd
    assert "return 6 * kB * kPadded<T, D> * static_cast<int>(sizeof(T)) " \
        "+ 4 * kB * 4;" in bwd
    assert "constexpr int kPadded = D + 16 / static_cast<int>(sizeof(T));" \
        in SOURCES.joinpath("mma.cuh").read_text()
    for nw in (1, 4):
        assert (16 * nw + 4 * 64) * _padded(elt, d) * elt <= SMEM_PER_BLOCK
    bwd_bytes = 6 * 64 * _padded(elt, d) * elt + 4 * 64 * 4
    assert bwd_bytes <= SMEM_PER_BLOCK
    if d == 96:
        assert ((16 * 4 + 256) * _padded(elt, d) * elt, bwd_bytes) == (
            (128000, 154624) if elt == 4 else (66560, 80896))
    for case in (16, 32, 64, 96, 128):
        assert f"case {case}:" in fwd and f"case {case}:" in bwd
