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
import torch.nn.functional as F

from bigdl_tpu.nn import quantized as jq
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import resnet as tres
from bigdl_tpu_torch.nn import fused
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import act_quant as k6q
from bigdl_tpu_torch.ops import bn_act as k7


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
# The routes: K7's hand-off and one quantization a tensor version
# --------------------------------------------------------------------------- #

def _k7_output(shape=(2, 6, 6, 16), seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    bn = nn.SpatialBatchNormalization(c)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(
            rng.standard_normal(c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.1, 2, c).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return k7.bn_act(x, bn.eval(), absmax=True)


def _quantized_like_the_plain_version(x):
    got_q, got_s = k6q.act_quant(x)
    want_q, want_s = k6q.act_quant_reference(x)
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)


def test_the_hand_off_is_taken_for_the_producers_own_tensor():
    y = _k7_output()
    route, absmax = k6q.select_route(y)
    assert route == "act_quant_given"
    assert absmax.view(torch.float32).item() == y.abs().amax().item()
    assert k6q.select_route(y.contiguous())[0] == "act_quant_given"
    _quantized_like_the_plain_version(y)


@pytest.mark.parametrize("change", [
    "in_place", "in_place_on_a_view", "slice", "permuted_view", "reshape",
    "padded_copy", "clone", "detach"])
def test_the_hand_off_is_not_taken_for_another_tensor(change):
    """An in-place change after K7 (the version moves), a view (a slice,
    the NCHW facade's permute, a reshape), or a copy (``Predictor``'s
    padding, a clone): the absmax K7 left may not be theirs, so another
    route quantizes them, from their own absmax."""
    y = _k7_output()
    if change == "in_place":
        x = y.mul_(3.0)
    elif change == "in_place_on_a_view":
        y[0].mul_(3.0)
        x = y
    elif change == "slice":
        x = y[1:]
    elif change == "permuted_view":
        x = y.permute(0, 3, 1, 2)
    elif change == "reshape":
        x = y.reshape(-1, 16)
    elif change == "padded_copy":
        x = F.pad(y, (0, 0, 0, 0, 0, 0, 0, 2))
    elif change == "clone":
        x = y.clone()
    else:
        x = y.detach()
    assert k6q.select_route(x)[0] != "act_quant_given"
    _quantized_like_the_plain_version(x)


def test_an_inference_tensor_takes_no_hand_off():
    with torch.inference_mode():
        y = _k7_output()
        assert k6q.handed_off_absmax(y) is None
        _quantized_like_the_plain_version(y)


def test_the_route_follows_the_size(monkeypatch):
    x = torch.ones(1000)
    assert k6q.select_route(x) == ("act_quant_small", None)
    monkeypatch.setattr(k6q, "SMALL_LIMIT", 999)
    assert k6q.select_route(x) == ("act_quant", None)


@pytest.fixture
def quantizations(monkeypatch):
    seen = []
    real = k6q.quantize_route

    def spy(x, route, absmax=None):
        seen.append((tuple(x.shape), route))
        return real(x, route, absmax)

    monkeypatch.setattr(k6q, "quantize_route", spy)
    return seen


def test_quantize_once_quantizes_a_tensor_version_once(quantizations):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 8), np.float32))
    with k6q.quantize_once():
        first = k6q.act_quant(x)
        with k6q.quantize_once():            # nested: the same scope
            assert k6q.act_quant(x) is first
        x.mul_(2.0)                           # a new version
        second = k6q.act_quant(x)
        assert second is not first and k6q.act_quant(x) is second
    assert k6q.act_quant(x) is not second     # nothing kept past the scope
    assert len(quantizations) == 3


def test_a_downsampling_block_quantizes_its_input_once(quantizations):
    """A bottleneck with a projection shortcut: its ``conv1`` and the
    shortcut's convolution share the quantization of the block's input
    in the fused twin; the unfused twin (JAX's order) quantizes it twice,
    with the same result."""
    g = torch.Generator().manual_seed(0)
    block = nn.Sequential().add(tres.bottleneck(16, 4, 2, generator=g))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16), np.float32))
    with torch.no_grad():
        block.train()(x)
    twin, _ = tq.quantize_model(block.eval())
    with torch.no_grad():
        got = twin(x)
        fused_q = list(quantizations)
        del quantizations[:]
        with fused.unfused():
            want = twin(x)
    assert torch.equal(got, want)
    assert [r for r in fused_q if r[0] == (2, 8, 8, 16)] == [
        ((2, 8, 8, 16), "act_quant_small")]
    assert [r for r in quantizations if r[0] == (2, 8, 8, 16)] == [
        ((2, 8, 8, 16), "act_quant_small")] * 2
    assert [r for _, r in fused_q].count("act_quant_given") == 2
    assert len(fused_q) == len(quantizations) - 1 == 3


# --------------------------------------------------------------------------- #
# The card path, through a stand-in library
# --------------------------------------------------------------------------- #

@pytest.fixture
def card(monkeypatch):
    """The wrapper's card path on CPU tensors: every launch recorded, by
    entry point."""
    seen = []

    def entry(name):
        def launch(*args):
            seen.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(k6q, "_on_cpu", lambda x: False)
    monkeypatch.setattr(k6q, "_stream", lambda: None)
    monkeypatch.setattr(k6q, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        **{name: entry(name) for name in (
            "bigdl_act_quant", "bigdl_act_quant_given",
            "bigdl_act_quant_small")}))
    for route in k6q.ROUTES:
        monkeypatch.setitem(k6q.LAUNCHES, route, 0)
    return seen


def test_the_wrapper_launches_k6q_once(card, monkeypatch):
    """The three-node route (an input past the small route's limit)."""
    monkeypatch.setattr(k6q, "SMALL_LIMIT", 0)
    x = torch.zeros((3, 5, 7, 16), dtype=torch.bfloat16)
    q, s = k6q.act_quant(x)
    assert q.shape == x.shape and q.dtype == torch.int8 and s.shape == ()
    assert len(card) == 1 and k6q.LAUNCHES["act_quant"] == 1
    name, (ptr, n, dtype, scratch, q_ptr, s_ptr, sms, stream) = card[0]
    assert name == "bigdl_act_quant"
    assert (n, dtype, sms) == (x.numel(), 1, 132)
    assert q_ptr == q.data_ptr() and s_ptr == s.data_ptr()


def test_each_route_launches_its_entry_point_once(card):
    x = torch.zeros((3, 5, 7, 16))
    q, s = k6q.act_quant(x)                      # 1680 elements: small
    name, (ptr, n, dtype, q_ptr, s_ptr, blocks, stream) = card[-1]
    assert name == "bigdl_act_quant_small" and blocks == 1
    assert (n, dtype, q_ptr, s_ptr) == (x.numel(), 0, q.data_ptr(),
                                        s.data_ptr())
    bits = torch.zeros(1, dtype=torch.int32)
    k6q.hand_off(x, bits)
    q, s = k6q.act_quant(x)
    name, (ptr, n, dtype, b_ptr, q_ptr, s_ptr, sms, stream) = card[-1]
    assert name == "bigdl_act_quant_given" and b_ptr == bits.data_ptr()
    assert (n, sms, q_ptr) == (x.numel(), 132, q.data_ptr())
    assert dict(k6q.LAUNCHES) == {"act_quant": 0, "act_quant_given": 1,
                                  "act_quant_small": 1}
    with pytest.raises(ValueError):              # the hand-off must be int32
        k6q.quantize_route(x, "act_quant_given", bits.float())
    assert len(card) == 2


@pytest.mark.parametrize("n,blocks", [(1, 1), (8192, 1), (8193, 2),
                                      (24576, 3), (65536, 8),
                                      (1 << 19, 8)])
def test_the_small_route_sizes_its_cluster(n, blocks):
    assert k6q.small_blocks(n) == blocks


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
    ("bigdl_act_quant_given", "act_quant.cu"),
    ("bigdl_act_quant_small", "act_quant.cu"),
    ("bigdl_bn_act", "bn_act.cu"),
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
