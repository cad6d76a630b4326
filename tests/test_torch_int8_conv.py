"""Int8 inference of the CNN zoo: the port's ``int8_conv`` (the plain
version of K6, ``ops/int8_conv.py``), ``QuantizedLinear``,
``QuantizedSpatialConvolution``, the legacy in-place ``quantize(model)``,
``Module.quantize()``, ``quantize_params`` / ``quantize_model`` over
convolutions and ``ServingEngine(quantize=True)`` on a CNN, against the
JAX package's ``bigdl_tpu/nn/quantized.py`` on the CPU, from numpy seeds.

Tolerances:

- the int32 sums of the convolution are held EXACT (JAX's
  ``lax.conv_general_dilated(..., preferred_element_type=int32)``
  against the port's float64 convolution over the int8 values), and the
  scaled outputs within 1 ulp (the same three fp32 roundings);
- int8 payloads bitwise, scales within 1 ulp;
- a whole quantized model's outputs within 1e-4 of the output's largest
  magnitude: the fp32 parts between the int8 layers (BatchNorm, pooling,
  the residual adds) sum in another order in the two packages, and a
  difference that moves an activation across a rounding boundary of its
  int8 code (1/127 of the layer's absmax) moves the output by up to a
  code's worth.  None flips at these seeds; a failure would say so.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import resnet as jres
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.optim.validation import AccuracyDeltaGate as JGate
from bigdl_tpu.serving import ServingEngine as JEngine
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import (load_jax_params, load_jax_state,
                                     to_jax_params)
from bigdl_tpu_torch.models import resnet as tres
from bigdl_tpu_torch.nn import fused
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import act_quant as k6q
from bigdl_tpu_torch.ops import bn_act as k7
from bigdl_tpu_torch.ops import int8_conv as k6
from bigdl_tpu_torch.serving import ServingEngine

ULP = np.finfo(np.float32).eps
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    """numpy leaves; JAX's empty ``()`` entries stay as they are."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif not isinstance(v, tuple):
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_match(got, want):
    """int8 payloads bitwise, fp32 leaves within 1 ulp, the same keys."""
    got, want = _flat(_np(got)), _flat(_np(want))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=ULP, atol=0, err_msg=key)


# --------------------------------------------------------------------------- #
# int8_conv over a grid of shapes
# --------------------------------------------------------------------------- #

GRID = [(k, s, p, d, cin, g)
        for k in (1, 3, 5, 7) for s in (1, 2) for p in (0, 1, "SAME")
        for d in (1, 2) for cin, g in ((3, 1), (16, 1), (16, 2))]


def _jax_padding(p):
    return "SAME" if p == "SAME" else ((p, p), (p, p))


@pytest.mark.parametrize("k,s,p,d,cin,groups", GRID)
def test_int8_conv_matches_jax(k, s, p, d, cin, groups):
    """The exact int32 sums bitwise and the scaled fp32 result within 1
    ulp, for kernel 1/3/5/7, stride 1/2, pad 0/1/SAME (asymmetric where
    the total is odd), dilation 1/2, groups 1/2, cin 3 and 16."""
    rng = np.random.default_rng(k * 1000 + s * 100 + d * 10 + cin + groups)
    cout = 8
    x = rng.standard_normal((2, 15, 13, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin // groups, cout)).astype(np.float32)
    w_q, scale = jq.quantize_channelwise(jnp.asarray(w), 3)
    jx_q, jx_scale = jq._quantize_activation(jnp.asarray(x))
    conv = dict(stride=(s, s), padding=_jax_padding(p), dilation=(d, d),
                groups=groups)
    want_acc = jax.lax.conv_general_dilated(
        jx_q, w_q, window_strides=(s, s), padding=conv["padding"],
        rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    want = jq.int8_conv(jnp.asarray(x), w_q, scale, **conv)

    tx = torch.from_numpy(x)
    tw_q = torch.from_numpy(np.array(w_q))
    tscale = torch.from_numpy(np.array(scale))
    x_q, x_scale = tq._quantize_activation(tx)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    pads = tq._conv_padding(conv["padding"], tx, (k, k), (s, s), (d, d))
    acc = k6.int8_conv_acc_reference(x_q, tw_q, (s, s), pads, (d, d), groups)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    got = tq.int8_conv(tx, tw_q, tscale, **conv)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)


@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_quantized_conv_layer_and_nchw_facade_match_jax(data_format):
    """``QuantizedSpatialConvolution`` from a float layer with bias (and
    the NCHW facade) against JAX's on the same weights: payload and scale
    trees, and the output within 1 ulp."""
    rng = np.random.default_rng(7)
    jconv = jnn.SpatialConvolution(6, 10, 3, 3, 2, 2, -1, -1, n_group=2,
                                   data_format=data_format)
    shape = (2, 9, 9, 6) if data_format == "NHWC" else (2, 6, 9, 9)
    x = rng.standard_normal(shape).astype(np.float32)
    jconv.build(jax.ShapeDtypeStruct(shape, jnp.float32),
                rng=jax.random.PRNGKey(3))
    jp = jconv.parameters()[0]
    jp = {**jp, "bias": jnp.asarray(rng.standard_normal(10), jnp.float32)}
    jqc = jq.QuantizedSpatialConvolution(jconv, jp)
    want, _ = jqc.apply(jqc._params, (), jnp.asarray(x))

    tconv = nn.SpatialConvolution(6, 10, 3, 3, 2, 2, -1, -1, n_group=2,
                                  data_format=data_format)
    load_jax_params(tconv, jax.tree.map(np.asarray, jp))
    tqc = tq.QuantizedSpatialConvolution(tconv)
    _assert_trees_match(tqc.parameters_tree(), jqc._params)
    assert not any(p.requires_grad for p in tqc.parameters())
    assert tqc.weight_q.dtype == torch.int8
    got = tqc(torch.from_numpy(x))
    np.testing.assert_array_max_ulp(got.detach().numpy(), np.asarray(want),
                                    maxulp=1)
    # the float layer holding the same tree (the twin's path) agrees
    twin, _ = tq.quantize_model(nn.Sequential().add(tconv))
    np.testing.assert_array_equal(twin(torch.from_numpy(x)).detach().numpy(),
                                  got.detach().numpy())


def test_quantized_linear_matches_jax_and_takes_prequantized_arrays():
    rng = np.random.default_rng(8)
    jlin = jnn.Linear(24, 12)
    jlin.build(jax.ShapeDtypeStruct((3, 24), jnp.float32),
               rng=jax.random.PRNGKey(1))
    jqlin = jq.QuantizedLinear(jlin, jlin.parameters()[0])
    x = rng.standard_normal((3, 5, 24)).astype(np.float32)
    want, _ = jqlin.apply(jqlin._params, (), jnp.asarray(x))
    tlin = nn.Linear(24, 12)
    load_jax_params(tlin, jax.tree.map(np.asarray, jlin.parameters()[0]))
    tqlin = tq.QuantizedLinear(tlin)
    _assert_trees_match(tqlin.parameters_tree(), jqlin._params)
    got = tqlin(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    # the deserialization path: pre-quantized arrays, on the CPU
    p = jax.tree.map(np.array, jqlin._params)
    again = tq.QuantizedLinear(output_size=12, weight_q=p["weight_q"],
                               scale=p["scale"], bias=p["bias"],
                               device="cpu")
    np.testing.assert_array_equal(again(torch.from_numpy(x)).numpy(),
                                  got.detach().numpy())


# --------------------------------------------------------------------------- #
# Whole models: quantize_params (the repair), quantize(), quantize_model
# --------------------------------------------------------------------------- #

def _grouped_stack(pkg):
    """An AlexNet-style stack: a strided conv, a grouped 5 x 5, a dilated
    conv, a SAME conv, pooling and a Linear head."""
    return (pkg.Sequential()
            .add(pkg.SpatialConvolution(3, 16, 5, 5, 2, 2, 0, 0))
            .add(pkg.ReLU())
            .add(pkg.SpatialConvolution(16, 32, 5, 5, 1, 1, 2, 2, n_group=2))
            .add(pkg.ReLU())
            .add(pkg.SpatialDilatedConvolution(32, 16, 3, 3, 1, 1, 2, 2, 2,
                                               2))
            .add(pkg.ReLU())
            .add(pkg.SpatialConvolution(16, 16, 3, 3, 2, 2, -1, -1))
            .add(pkg.GlobalAveragePooling2D())
            .add(pkg.Linear(16, 10)))


#: name -> (JAX constructor, port constructor, input shape)
MODELS = {
    "LeNet5": (lambda: jlenet.LeNet5(), lambda: tmodels.LeNet5(device="cpu"),
               (4, 28, 28)),
    "ResNetCifar8": (lambda: jres.ResNetCifar(8),
                     lambda: tmodels.ResNetCifar(8, device="cpu"),
                     (4, 32, 32, 3)),
    "grouped": (lambda: _grouped_stack(jnn),
                lambda: _grouped_stack(nn).to("cpu"), (4, 23, 23, 3)),
}


def _bottleneck_stack(pkg, **kw):
    """Two bottlenecks built by the package's ``models/resnet.py``: the
    first downsamples (a projection shortcut with its BatchNorm), the
    second keeps the identity shortcut."""
    res = jres if pkg is jnn else tres
    return (pkg.Sequential().add(res.bottleneck(16, 4, 2, **kw))
            .add(res.bottleneck(16, 4, **kw)))


#: the int8 twins held with their fused eval plan (``nn/fused.py``)
FUSED_MODELS = {
    "ResNetCifar8": MODELS["ResNetCifar8"],
    "ResNet18": (lambda: jres.ResNet(18, 10),
                 lambda: tmodels.ResNet(18, 10, device="cpu"),
                 (4, 32, 32, 3)),
    "bottleneck_stack": (
        lambda: _bottleneck_stack(jnn),
        lambda: _bottleneck_stack(
            nn, generator=torch.Generator().manual_seed(0)).to("cpu"),
        (4, 8, 8, 16)),
}


def _pair(name, seed=0, models=MODELS):
    """A built JAX model with non-trivial running statistics (one
    training apply) and the port's model on its weights and state, both
    in eval mode, and an eval batch."""
    jbuild, tbuild, shape = models[name]
    rng = np.random.default_rng(seed)
    x_train = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    jm = jbuild()
    jm.build(jax.ShapeDtypeStruct(shape, jnp.float32),
             rng=jax.random.PRNGKey(seed))
    _, js = jm.apply(jm.parameters()[0], jm.state(), jnp.asarray(x_train),
                     training=True)
    jm._state = js
    tm = tbuild()
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    load_jax_state(tm, jax.tree.map(np.asarray, js))
    return jm.evaluate(), tm.eval(), x


def _jax_out(jm, x):
    y, _ = jm.apply(jm.parameters()[0], jm.state(), jnp.asarray(x),
                    training=False)
    return np.asarray(y)


def _hold_model(got, want):
    """Outputs within ``MODEL_TOL`` of the largest magnitude; past it, an
    activation's int8 code flipped between the packages, and the message
    says so."""
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= MODEL_TOL, (
        f"quantized outputs {err:.2e} apart (above {MODEL_TOL}): an "
        f"activation's int8 code flipped between the packages")


@pytest.mark.parametrize("name", list(MODELS))
def test_quantize_params_of_cnns_matches_jax(name):
    """The repair: the port's walk now rewrites every convolution (HWIO,
    channel axis 3) as JAX's does -- the same keys, bitwise payloads,
    scales within 1 ulp."""
    jm, tm, _ = _pair(name)
    want = jq.quantize_params(jm)
    got = tq.quantize_params(tm)
    _assert_trees_match(got, want)
    n_conv = sum(type(m) in (nn.SpatialConvolution,
                             nn.SpatialDilatedConvolution)
                 for m in tm.modules())
    n_lin = sum(type(m) is nn.Linear for m in tm.modules())
    assert tq.quantized_leaf_count(got) == n_conv + n_lin == \
        jq.quantized_leaf_count(want)


@pytest.mark.parametrize("name", list(MODELS))
def test_quantize_in_place_matches_jax(name):
    """``quantize(model)`` in both packages from the same weights: the
    same swapped children, trees and outputs; the port's legacy rewrite
    and its ``quantize_model`` twin give bitwise-equal outputs."""
    jm, tm, x = _pair(name)
    twin, _ = tq.quantize_model(tm)
    jm = jq.quantize(jm)
    assert tq.quantize(tm) is tm and not tm.training
    for jc, tc in zip(jm.modules, tm._modules.values()):
        assert type(tc).__name__ == type(jc).__name__
    _assert_trees_match(to_jax_params(tm), jm.parameters()[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(twin(torch.from_numpy(x)).numpy(), got)
    _hold_model(got, _jax_out(jm, x))


@pytest.mark.parametrize("name", list(FUSED_MODELS))
def test_fused_twin_matches_the_unfused_twin_and_jax(name, monkeypatch):
    """The twin's fused eval plan (BatchNorm, the residual add and ReLU
    through K7's plain version here) against the same twin with its
    modules, bitwise, every site through K7 and every K7 output handed to
    the quantizer after it; then against JAX's ``quantize_model`` twin."""
    jm, tm, x = _pair(name, models=FUSED_MODELS)
    twin, _ = tq.quantize_model(tm)
    jtwin, _ = jq.quantize_model(jm)
    calls, routes = [], []
    real_k7, real_route = k7.bn_act, k6q.quantize_route

    def k7_spy(*a, **kw):
        calls.append(kw)
        return real_k7(*a, **kw)

    def route_spy(x, route, absmax=None):
        routes.append(route)
        return real_route(x, route, absmax)

    monkeypatch.setattr(k7, "bn_act", k7_spy)
    monkeypatch.setattr(k6q, "quantize_route", route_spy)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = twin(xt).numpy()
        fused_routes = list(routes)
        with fused.unfused():
            want = twin(xt).numpy()
    counts = fused.site_counts(twin)
    assert counts["unfused_sites"] == 0
    assert len(calls) == counts["fused_sites"] > 0
    assert all(kw["absmax"] for kw in calls)
    assert "act_quant_given" in fused_routes
    # a projection shortcut's convolution shares its block's input's
    # quantization with the block's conv1 in the plan, not unfused
    projections = sum(type(m) is nn.ConcatTable and
                      type(m._modules["1"]) is nn.Sequential
                      for m in twin.modules())
    assert len(routes) - 2 * len(fused_routes) == projections > 0
    np.testing.assert_array_equal(got, want)
    _hold_model(got, _jax_out(jtwin, x))


def test_module_quantize_returns_self_in_eval_mode():
    m = nn.Sequential().add(nn.Linear(6, 4)).add(nn.ReLU()).to("cpu")
    out = m.quantize()
    assert out is m and not m.training
    assert isinstance(m._modules["0"], tq.QuantizedLinear)


def test_jax_quantized_trees_load_into_the_port():
    """A JAX model rewritten by ``quantize()`` (and a ``quantize_model``
    twin's tree) loads by key into the port's ``quantize()``d model (and
    twin): int8 leaves into int8 parameters; the outputs agree."""
    jm, tm, x = _pair("ResNetCifar8", seed=1)
    jtwin, jqp = jq.quantize_model(jm)
    ttwin, _ = tq.quantize_model(
        tmodels.ResNetCifar(8, device="cpu", seed=5).eval())
    load_jax_params(ttwin, jax.tree.map(np.asarray, jqp))
    load_jax_state(ttwin, jax.tree.map(np.asarray, jm.state()))
    jm = jq.quantize(jm)
    other = tmodels.ResNetCifar(8, device="cpu", seed=9).quantize()
    load_jax_params(other, jax.tree.map(np.asarray, jm.parameters()[0]))
    load_jax_state(other, jax.tree.map(np.asarray, jm.state()))
    with torch.no_grad():
        got = other(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            ttwin(torch.from_numpy(x)).numpy(), got)
    assert other._modules["0"].weight_q.dtype == torch.int8
    _hold_model(got, _jax_out(jm, x))
    with pytest.raises(TypeError):    # an int8 payload never loads as fp32
        bad = jax.tree.map(np.asarray, jm.parameters()[0])
        bad["0"]["weight_q"] = bad["0"]["weight_q"].astype(np.float32)
        load_jax_params(other, bad)


def test_space_to_depth_stem_stays_fp32():
    """JAX ``tests/test_int8_serving.py:113``: the s2d stem reshapes its
    weight inside ``forward``, so the exact-type walk and ``quantize()``
    leave it fp32, and the twin still runs."""
    m = (nn.Sequential().add(nn.SpaceToDepthStem(3, 8, 7))
         .add(nn.SpatialConvolution(8, 4, 3, 3)).to("cpu"))
    qp = tq.quantize_params(m)
    assert "weight" in qp["0"] and "weight_q" in qp["1"]
    assert tq.quantized_leaf_count(qp) == 1
    twin, _ = tq.quantize_model(m)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, 16, 3)).astype(np.float32))
    assert twin(x).shape == (1, 6, 6, 4)
    m.quantize()
    assert type(m._modules["0"]) is nn.SpaceToDepthStem
    assert type(m._modules["1"]) is tq.QuantizedSpatialConvolution


class TestQuantizeIsAllOrNothing:
    """JAX ``tests/test_quantized.py:214-272``: a failure midway undoes
    every swap already made, in reverse, and leaves a nested container
    (and a container used on its own) as it was."""

    def _nested(self):
        inner = nn.Sequential().add(nn.Linear(8, 8)).add(nn.ReLU())
        outer = (nn.Sequential().add(nn.Linear(6, 8)).add(inner)
                 .add(nn.Linear(8, 4)))
        return outer.to("cpu"), inner

    def test_midwalk_failure_rolls_back_every_swap(self, monkeypatch):
        outer, inner = self._nested()
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (2, 6)).astype(np.float32))
        with torch.no_grad():
            ref = outer(x)
        children = [outer._modules[k] for k in ("0", "1", "2")]
        orig, calls = tq.QuantizedLinear, []

        class Boom(Exception):
            pass

        def failing(*a, **kw):
            calls.append(1)
            if len(calls) == 3:      # the last Linear: two swaps done
                raise Boom()
            return orig(*a, **kw)

        monkeypatch.setattr(tq, "QuantizedLinear", failing)
        with pytest.raises(Boom):
            tq.quantize(outer)
        assert [outer._modules[k] for k in ("0", "1", "2")] == children
        assert type(inner._modules["0"]) is nn.Linear
        assert "weight" in inner._modules["0"]._parameters
        with torch.no_grad():
            np.testing.assert_array_equal(ref.numpy(), outer(x).numpy())

    def test_a_container_built_on_its_own_is_rewritten_in_place(self):
        outer, inner = self._nested()
        tq.quantize(outer)
        assert outer._modules["1"] is inner
        assert isinstance(inner._modules["0"], tq.QuantizedLinear)
        assert inner._modules["0"].weight_q.dtype == torch.int8


# --------------------------------------------------------------------------- #
# Serving a quantized CNN
# --------------------------------------------------------------------------- #

def test_int8_serving_engine_on_lenet_matches_jax():
    """``ServingEngine(LeNet5, quantize=True, accuracy_gate=...)``: both
    gates pass, and each ``predict`` agrees with JAX's engine on the same
    weights (the int8 twin evaluated on the request padded to its rung,
    the activation scale taken over the padded batch, in both)."""
    jm, tm, _ = _pair("LeNet5", seed=2)
    xs = np.random.default_rng(3).standard_normal((16, 28, 28)) \
        .astype(np.float32)
    gate = {"features": xs[:8], "min_top1_agreement": 0.75}
    with JEngine(jm, max_batch_size=4, quantize=True,
                 accuracy_gate=JGate(**gate)) as je, \
            ServingEngine(tm, max_batch_size=4, quantize=True,
                          accuracy_gate=gate, device="cpu") as te:
        assert je.quantized and te.quantized
        for i in range(8, 12):
            want = np.asarray(je.predict(xs[i]))
            got = np.asarray(te.predict(xs[i]))
            assert got.shape == want.shape == (10,)
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= MODEL_TOL, (i, err)


# --------------------------------------------------------------------------- #
# K6's packed weight (the wgmma kernel's B operand) and the wrapper's card
# path, through a stand-in library (no card here)
# --------------------------------------------------------------------------- #

def _packed_acc(x_q, w_packed, kernel, cin_g, stride, pads, dilation,
                groups, cout):
    """The exact int32 sums from the PACKED weight (the wgmma kernel's B
    operand): unpacked back to HWIO, then ``int8_conv_acc_reference``."""
    kh, kw = kernel
    k = kh * kw * cin_g
    cout_pad = w_packed.shape[0] // groups
    w = w_packed.reshape(groups, cout_pad, -1)[:, :cout // groups, :k]
    w_q = w.permute(2, 0, 1).reshape(kh, kw, cin_g, cout)
    return k6.int8_conv_acc_reference(x_q, w_q, stride, pads, dilation,
                                      groups)


@pytest.mark.parametrize("k,s,p,d,cin,groups", GRID)
def test_packed_weight_gives_the_same_sums(k, s, p, d, cin, groups):
    """``pack_weight`` at every grid shape: K-contiguous rows, zero
    padding to the kernel's tiles, and the exact sums from the packed
    matrix equal to ``int8_conv_acc_reference`` over the HWIO weight."""
    rng = np.random.default_rng(k * 1000 + s * 100 + d * 10 + cin + groups
                                + 7)
    cout = 8
    x_q = torch.from_numpy(rng.integers(-127, 128, (2, 15, 13, cin),
                                        dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128,
                                        (k, k, cin // groups, cout),
                                        dtype=np.int8))
    packed = k6.pack_weight(w_q, groups)
    cin_g, cout_g = cin // groups, cout // groups
    kk = k * k * cin_g
    k_pad = -(-kk // k6.STAGE_K) * k6.STAGE_K
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (groups * 64, k_pad)
    blocks = packed.reshape(groups, 64, k_pad)
    assert not blocks[:, cout_g:].any() and not blocks[:, :, kk:].any()
    for g in range(groups):              # row o: channel g * cout_g + o
        want = w_q[..., g * cout_g:(g + 1) * cout_g].reshape(kk, cout_g)
        assert torch.equal(blocks[g, :cout_g, :kk], want.t())
    pads = tq._conv_padding(_jax_padding(p), x_q, (k, k), (s, s), (d, d))
    got = _packed_acc(x_q, packed, (k, k), cin_g, (s, s), pads, (d, d),
                      groups, cout)
    want = k6.int8_conv_acc_reference(x_q, w_q, (s, s), pads, (d, d),
                                      groups)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cout_g,tile", [(5, 64), (64, 64), (65, 128),
                                         (128, 128), (200, 128)])
def test_packed_weight_pads_to_the_kernel_tile(cout_g, tile):
    w_q = torch.ones((3, 3, 16, 2 * cout_g), dtype=torch.int8)
    packed = k6.pack_weight(w_q, 2)
    assert k6.tile_n(cout_g) == tile
    assert packed.shape == (2 * -(-cout_g // tile) * tile, 256)


def _quantized_conv(seed, cin=16, groups=1):
    rng = np.random.default_rng(seed)
    conv = nn.SpatialConvolution(cin, 32, 3, 3, 1, 1, 1, 1, n_group=groups)
    load_jax_params(conv, {
        "weight": rng.standard_normal((3, 3, cin // groups, 32))
        .astype(np.float32),
        "bias": rng.standard_normal(32).astype(np.float32)})
    return tq.QuantizedSpatialConvolution(conv)


def test_a_reloaded_weight_is_packed_anew():
    """The packed copy follows the weight: the same copy while the
    weight is unchanged; a new one after ``copy_`` of new values into
    ``weight_q`` (a load in place), whose sums are the freshly quantized
    twin's and not the old ones; off the parameter tree; dropped by a
    deep copy."""
    import copy

    layer, fresh = _quantized_conv(1), _quantized_conv(2)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, 8, 16), np.float32))
    x_q, _ = tq._quantize_activation(x)
    old = tq.packed_weight(layer)
    assert tq.packed_weight(layer) is old
    keys = set(layer.parameters_tree())
    with torch.no_grad():
        layer.weight_q.copy_(fresh.weight_q)
        layer.scale.copy_(fresh.scale)
        layer.bias.copy_(fresh.bias)
    new = tq.packed_weight(layer)
    assert new is not old and set(layer.parameters_tree()) == keys

    def sums(packed):
        return _packed_acc(x_q, packed, (3, 3), 16, (1, 1),
                           ((1, 1), (1, 1)), (1, 1), 1, 32)

    assert torch.equal(sums(new), sums(tq.packed_weight(fresh)))
    assert not torch.equal(sums(new), sums(old))
    assert torch.equal(layer(x), fresh(x))
    assert "_k6_packed" not in dict(layer.named_buffers())
    assert copy.deepcopy(layer).__dict__["_k6_packed"].packed is None


def test_a_rebound_weight_is_packed_anew():
    """``quantize_model``'s ``_bind`` installs new tensors: a twin's
    layer packs its own weight, never a packed copy of another's."""
    model = nn.Sequential().add(_quantized_conv(4))
    first = tq.packed_weight(model[0] if hasattr(model, "__getitem__")
                             else model._modules["0"])
    layer = model._modules["0"]
    tq._bind(layer, {k: v * 0 if v.dtype == torch.int8 else v
                     for k, v in layer.parameters_tree().items()})
    again = tq.packed_weight(layer)
    assert again is not first and not again.any()
    assert first.any()


def test_packed_weight_bytes_counts_the_cached_copies():
    """``packed_weight_bytes`` counts what the layers hold now (the CPU
    forward packs nothing), and ``model_bytes`` never counts it."""
    model = nn.Sequential().add(_quantized_conv(6)).add(
        _quantized_conv(7, cin=32)).add(_quantized_conv(8, cin=6, groups=2))
    layers = list(model._modules.values())
    params = tq.model_bytes(model.parameters_tree())
    for m, cin in zip(layers, (16, 32, 6)):
        m(torch.zeros((1, 5, 5, cin)))
    assert tq.packed_weight_bytes(model) == 0
    packed = [tq.packed_weight(m) for m in layers]
    assert packed[2] is None
    assert tq.packed_weight_bytes(model) == 64 * 256 + 64 * 384
    assert tq.model_bytes(model.parameters_tree()) == params


def test_the_gather_shapes_take_no_packed_weight():
    assert tq.packed_weight(_quantized_conv(5, cin=6, groups=2)) is None
    assert k6.uses_wgmma(16) and k6.uses_wgmma(48) and not k6.uses_wgmma(3)


@pytest.fixture
def card(monkeypatch):
    """The wrapper's card path on CPU tensors: every launch recorded by
    entry point."""
    seen = []

    def entry(name):
        def launch(*args):
            seen.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(k6, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(k6, "_stream", lambda: None)
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        bigdl_int8_conv=entry("gather"),
        bigdl_int8_conv_wgmma=entry("wgmma")))
    for key in k6.LAUNCHES:
        monkeypatch.setitem(k6.LAUNCHES, key, 0)
    return seen


def _conv_args(cin, cout, groups, k=3):
    rng = np.random.default_rng(cin + cout)
    x_q = torch.from_numpy(rng.integers(-127, 128, (2, 9, 9, cin),
                                        dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128,
                                        (k, k, cin // groups, cout),
                                        dtype=np.int8))
    return x_q, w_q, torch.ones(cout), torch.tensor(0.5)


@pytest.mark.parametrize("cin,cout,groups,path", [
    (16, 8, 1, "wgmma"), (64, 64, 1, "wgmma"), (96, 256, 2, "wgmma"),
    (3, 64, 1, "gather"), (6, 6, 1, "gather"), (32, 12, 4, "gather")])
def test_the_shape_picks_the_kernel(card, cin, cout, groups, path):
    x_q, w_q, scale, xs = _conv_args(cin, cout, groups)
    out = k6.int8_conv_nhwc(x_q, w_q, scale, xs, None, (1, 1),
                            ((1, 1), (1, 1)), (1, 1), groups)
    assert out.shape == (2, 9, 9, cout)
    assert [name for name, _ in card] == [path]
    key = "int8_conv" if path == "wgmma" else "int8_conv_gather"
    assert k6.LAUNCHES == {"int8_conv": key == "int8_conv",
                           "int8_conv_gather": key == "int8_conv_gather"}
    args = card[0][1]
    if path == "wgmma":                  # packed at the call: its pads
        cout_g = cout // groups
        k_pad, cout_pad = args[2], args[3]
        assert k_pad == -(-9 * cin // groups // 128) * 128
        assert cout_pad == -(-cout_g // k6.tile_n(cout_g)) * \
            k6.tile_n(cout_g)
    assert args[-1] is None and args[-2] == cout and args[-3] == groups


def test_the_wrapper_refuses_what_the_kernels_do_not_take(card):
    x_q, w_q, scale, xs = _conv_args(16, 8, 1)
    conv = ((1, 1), ((1, 1), (1, 1)), (1, 1), 1)
    with pytest.raises(TypeError):       # a float input
        k6.int8_conv_nhwc(x_q.float(), w_q, scale, xs, None, *conv)
    with pytest.raises(TypeError):       # fp16 out
        k6.int8_conv_nhwc(x_q, w_q, scale, xs, None, *conv,
                          out_dtype=torch.float16)
    with pytest.raises(ValueError):      # channels and groups disagree
        k6.int8_conv_nhwc(x_q, w_q, scale, xs, None, (1, 1),
                          ((1, 1), (1, 1)), (1, 1), 3)
    with pytest.raises(ValueError):      # a scale of the wrong shape
        k6.int8_conv_nhwc(x_q, w_q, scale[:4], xs, None, *conv)
    with pytest.raises(ValueError):      # a packed weight of another shape
        k6.int8_conv_nhwc(x_q, w_q, scale, xs, None, *conv,
                          w_packed=k6.pack_weight(w_q)[:, :64])
    with pytest.raises(ValueError):      # a packed weight of another layer
        k6.int8_conv_nhwc(x_q, w_q, scale, xs, None, *conv,
                          w_packed=k6.pack_weight(w_q[:1, :1]))
    assert not card


def test_the_wrapper_refuses_a_device_mix():
    x_q, w_q, scale, xs = _conv_args(16, 8, 1)
    with pytest.raises(ValueError):
        k6.int8_conv_nhwc(x_q, w_q.to("meta"), scale, xs)
