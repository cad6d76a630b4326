"""K6q's plain version (``ops/act_quant.py``: the per-tensor int8
activation quantization) against the JAX package's
``bigdl_tpu/nn/quantized.py:88`` ``_quantize_activation``, on the CPU,
from numpy seeds; and the wrapper's card path through a stand-in library
(no card here).

Tolerance: none.  ``x_q`` and ``x_scale`` are held bit for bit: both
packages take the absmax exactly, divide it by 127 and every element by
the scale as IEEE quotients, and round half to even.  The plain version
divides by a tensor on ``x``'s own device, so on the card too it takes
the IEEE quotient (PyTorch's CUDA division by a Python scalar multiplies
by the reciprocal); ``test_the_scale_is_the_ieee_quotient`` holds it
against numpy's where the reciprocal's product differs.
"""

import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.nn import quantized as jq
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import act_quant as k6q


def _jax(x):
    q, s = jq._quantize_activation(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _assert_matches_jax(x):
    want_q, want_s = _jax(x)
    got_q, got_s = k6q.act_quant(torch.from_numpy(np.asarray(x)))
    assert got_q.dtype == torch.int8 and got_q.shape == want_q.shape
    assert got_s.dtype == torch.float32 and got_s.shape == ()
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert got_s.numpy().tobytes() == want_s.astype(np.float32).tobytes()


@pytest.mark.parametrize("shape", [(2, 15, 13, 3), (2, 8, 8, 16),
                                   (4, 7, 7, 64), (3, 5, 5, 1), (64, 512),
                                   (1000003,), (17,), (1,)])
@pytest.mark.parametrize("gain", [1e-3, 1.0, 40.0])
def test_plain_quantizer_matches_jax_bitwise(shape, gain):
    """Small NHWC batches, a head's rows, sizes off every 16-element
    boundary, at three magnitudes."""
    rng = np.random.default_rng(hash((shape, gain)) % 2**32)
    _assert_matches_jax((rng.standard_normal(shape) * gain)
                        .astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 6, 6, 16), (3, 1001)])
def test_plain_quantizer_matches_jax_on_bf16(shape):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    xb = x.to(torch.bfloat16)
    want_q, want_s = jq._quantize_activation(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    got_q, got_s = k6q.act_quant(xb)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert float(got_s) == float(want_s)


def test_all_zero_input_takes_the_floor_scale():
    x = np.zeros((2, 4, 4, 16), np.float32)
    _assert_matches_jax(x)
    _, s = k6q.act_quant(torch.from_numpy(x))
    assert s.numpy().tobytes() == (np.float32(1e-8) /
                                   np.float32(127)).tobytes()


@pytest.mark.parametrize("exp", [-6, 0, 5])
def test_half_way_quotients_round_to_even(exp):
    """absmax 127 * 2^exp makes the scale 2^exp exactly, so every x =
    (k + 0.5) * 2^exp lies half-way between two codes."""
    step = np.float32(2.0 ** exp)
    x = np.concatenate([(np.arange(-127, 127) + 0.5) * step,
                        [127 * step]]).astype(np.float32)
    _assert_matches_jax(x)
    q, s = k6q.act_quant(torch.from_numpy(x))
    assert float(s) == float(step)
    k = np.arange(-127, 127)
    np.testing.assert_array_equal(q.numpy()[:-1],
                                  np.round(k + 0.5).astype(np.int8))


def test_the_scale_is_the_ieee_quotient():
    """Absmaxes where ``a / 127`` and ``a * (1 / 127)`` differ in fp32:
    the plain version gives numpy's (and eager JAX's) quotient."""
    a = np.random.default_rng(3).uniform(0, 10, 20000).astype(np.float32)
    diff = a[a / np.float32(127) != a * (np.float32(1) / np.float32(127))]
    assert len(diff) > 100
    for v in diff[:50]:
        x = np.array([v, -v / 3, v / 4], np.float32)   # absmax v
        _, s = k6q.act_quant(torch.from_numpy(x))
        assert s.numpy().tobytes() == (v / np.float32(127)).tobytes()
        assert float(s) == float(_jax(x)[1])


def test_nan_makes_the_scale_nan():
    x = np.ones((4, 4), np.float32)
    x[2, 1] = np.nan
    _, s = k6q.act_quant(torch.from_numpy(x))
    assert np.isnan(float(s)) and np.isnan(float(_jax(x)[1]))


def test_the_layers_quantize_through_k6q(monkeypatch):
    """``int8_conv`` and ``int8_matmul`` quantize through ``act_quant``
    (K6q on the card)."""
    calls = []
    real = k6q.act_quant

    def spy(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(k6q, "act_quant", spy)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 16), np.float32))
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 16, 8), np.int8))
    tq.int8_conv(x, w_q, torch.ones(8), stride=(1, 1), padding="SAME",
                 dilation=(1, 1), groups=1)
    tq.int8_matmul(x.reshape(-1, 16), w_q[0, 0].t().contiguous(),
                   torch.ones(8))
    assert calls == [(2, 6, 6, 16), (72, 16)]


# --------------------------------------------------------------------------- #
# The card path, through a stand-in library
# --------------------------------------------------------------------------- #

@pytest.fixture
def card(monkeypatch):
    """The wrapper's card path on CPU tensors: every launch recorded."""
    seen = []

    def launch(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(k6q, "_on_cpu", lambda x: False)
    monkeypatch.setattr(k6q, "_stream", lambda: None)
    monkeypatch.setattr(k6q, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        bigdl_act_quant=launch))
    monkeypatch.setitem(k6q.LAUNCHES, "act_quant", 0)
    return seen


def test_the_wrapper_launches_k6q_once(card):
    x = torch.zeros((3, 5, 7, 16), dtype=torch.bfloat16)
    q, s = k6q.act_quant(x)
    assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == ()
    assert len(card) == 1 and k6q.LAUNCHES["act_quant"] == 1
    ptr, n, dtype, scratch, q_ptr, s_ptr, sms, stream = card[0]
    assert (n, dtype, sms) == (x.numel(), 1, 132)
    assert q_ptr == q.data_ptr() and s_ptr == s.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int8])
def test_the_wrapper_refuses_other_dtypes(card, dtype):
    with pytest.raises(TypeError):
        k6q.act_quant(torch.zeros((4, 4), dtype=dtype))
    assert not card


def test_the_wrapper_refuses_an_empty_tensor(card):
    with pytest.raises(ValueError):
        k6q.act_quant(torch.zeros((0, 16)))
    assert not card


def test_the_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        k6q.act_quant(torch.zeros((4, 4), device="meta"))


@pytest.mark.parametrize("name,source", [
    ("bigdl_act_quant", "act_quant.cu"),
    ("bigdl_int8_conv_wgmma", "int8_conv.cu"),
    ("bigdl_int8_conv", "int8_conv.cu")])
def test_ctypes_arity_of_the_int8_libraries(name, source):
    """Each binding of the two int8 libraries declares as many arguments
    as its C entry point takes, the stream last."""
    src = (_build.CSRC / source).read_text()
    params = re.search(rf"\bint {name}\(([^)]*)\)", src).group(1)

    class Library:
        def __getattr__(self, attr):
            fn = types.SimpleNamespace()
            setattr(self, attr, fn)
            return fn

    fn = getattr(_build._declare([Library()]), name)
    assert len(fn.argtypes) == len(params.split(","))
    assert params.split(",")[-1].split() == ["void*", "stream"]
    assert _build.CSRC / source in _build.SOURCES
