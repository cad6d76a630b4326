"""The CNN layers of the port (``bigdl_tpu_torch/nn/conv.py``,
``nn/pooling.py``, ``nn/normalization.py``, ``nn/activations.py``,
``nn/reshape.py``, ``nn/initialization.py``) against the JAX package's
(``bigdl_tpu/nn/...``), on the CPU.

Each layer is built in both packages, the port's loaded with JAX's
parameters and state by key, and run on numpy-seeded inputs: the output,
the gradient of ``sum(y * r)`` (``r`` a fixed random tensor) with respect
to the input and every parameter, and in training mode the new state,
within 1e-5 of JAX's (``jax.value_and_grad`` of ``apply``).  In bf16 (the
input and the rank >= 2 parameters cast, as the train step casts them)
within 3e-2 relative L2.

- convolutions: strides, explicit pads, SAME (-1, odd and even sizes,
  strided, so the high side takes the odd pixel), groups, dilation, no
  bias, NCHW; the transposed, temporal and connection-table ones; the
  space-to-depth stem against JAX's and against the plain stem (2e-4, as
  ``tests/test_conv.py`` holds it); the int8 branch refused;
- pooling: every ``(k, s, p, ceil)`` case of ``tests/test_conv.py:110-133``
  and the ceil-mode windows that run past the input (the asymmetric high
  pad), average with and without ``count_include_pad``, global pools;
- BatchNorm (N, C) and spatial, training and eval, fp32 and bf16, the
  running statistics after 3 steps, momentum, eps, no affine;
- LRN, Normalize, RMSNorm, Dropout, the 31 activations, the 14 reshapes
  and the initializers' shapes and statistics.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim.train_step import _cast_params as jcast
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import dropout as tdrop
from bigdl_tpu_torch.nn import initialization as tinit
from bigdl_tpu_torch.optim.train_step import _cast_params as tcast

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL_L2 = 3e-2


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    if not isinstance(tree, dict):
        return out
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif not (isinstance(v, tuple) and not v):
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def pair(name_or_jm, tm, shape, seed=0):
    """Build ``jm`` on ``shape`` and load its parameters and state into
    ``tm``; returns ``(jm, jp, js, x)``."""
    jm = name_or_jm
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    jm.build(jax.ShapeDtypeStruct(shape, jnp.float32),
             rng=jax.random.PRNGKey(seed + 3))
    jp, js = jm.parameters()[0], jm.state()
    if _flat(jp):
        tm.load_parameters_tree(_np(jp))
    tm.load_state_tree(_np(js))
    assert sorted(_flat(_np(jp))) == sorted(k for k, _ in
                                            tm.named_parameters())
    return jm, jp, js, x


def check(jm, tm, shape, training=False, seed=0, tol=TOL, steps=1):
    """Output, input and parameter gradients and (training) the state
    after ``steps`` applies, port against JAX."""
    jm, jp, js, x = pair(jm, tm, shape, seed)
    tm.train(training)
    for step in range(steps):
        xs = x + step
        jy0, _ = jm.apply(jp, js, jnp.asarray(xs), training=training)
        r = np.random.default_rng(seed + 100).standard_normal(
            np.shape(jy0)).astype(np.float32)

        def jloss(p, xin):
            y, s = jm.apply(p, js, xin, training=training)
            return jnp.sum(y * r), (y, s)

        (_, (jy, js)), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(xs))
        tm.zero_grad(set_to_none=True)
        tx = torch.from_numpy(xs.copy()).requires_grad_(True)
        ty = tm(tx)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   **tol)
        (ty * torch.from_numpy(r)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **tol)
        want = _flat(_np(jgp))
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[k], err_msg=k,
                                       **tol)
    got = {k: b.numpy() for k, b in tm.named_buffers()}
    for k, v in _flat(_np(js)).items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)
    return ty


def check_bf16(jm, tm, shape, training=False, seed=0):
    """bf16 input and rank >= 2 parameters in both packages: output and
    the input's and every parameter's fp32 gradient within 3e-2 relative
    L2 of JAX's, and the new state within 1e-5 (fp32 statistics)."""
    jm, jp, js, x = pair(jm, tm, shape, seed)
    tm.train(training)
    r = np.random.default_rng(seed + 100).standard_normal(
        np.shape(jm.apply(jp, js, jnp.asarray(x), training=training)[0])
    ).astype(np.float32)

    def jloss(p, xin):
        y, s = jm.apply(jcast(p, jnp.bfloat16), js,
                        xin.astype(jnp.bfloat16), training=training)
        y = y.astype(jnp.float32)
        return jnp.sum(y * r), (y, s)

    (_, (jy, js2)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    params = dict(tm.named_parameters())
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    ty = functional_call(tm, tcast(params, torch.bfloat16),
                         (tx.to(torch.bfloat16),)).float()
    assert rel_l2(ty.detach().numpy(), jy) < BF16_REL_L2
    (ty * torch.from_numpy(r)).sum().backward()
    assert rel_l2(tx.grad.numpy(), jgx) < BF16_REL_L2
    want = _flat(_np(jgp))
    for k, p in params.items():
        assert p.grad.dtype == torch.float32
        assert rel_l2(p.grad.numpy(), want[k]) < BF16_REL_L2, k
    for k, v in _flat(_np(js2)).items():
        np.testing.assert_allclose(dict(tm.named_buffers())[k].numpy(), v,
                                   err_msg=k, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# Convolutions
# --------------------------------------------------------------------------- #

#: name -> (constructor args and keywords, input shape)
CONV_CASES = {
    "k3_s1_p1": ((4, 6, 3, 3, 1, 1, 1, 1), {}, (2, 7, 7, 4)),
    "k3_s2_p1": ((4, 6, 3, 3, 2, 2, 1, 1), {}, (2, 8, 8, 4)),
    "rect_k": ((3, 5, 3, 5, 1, 2, 1, 2), {}, (2, 9, 8, 3)),
    "same_odd_s2": ((3, 4, 3, 3, 2, 2, -1, -1), {}, (2, 7, 9, 3)),
    "same_even_s2": ((3, 4, 3, 3, 2, 2, -1, -1), {}, (2, 8, 8, 3)),
    "same_k4_s1": ((3, 4, 4, 4, 1, 1, -1, -1), {}, (2, 6, 7, 3)),
    "same_dilated": ((3, 4, 3, 3, 1, 1, -1, -1),
                     dict(dilation_w=2, dilation_h=2), (2, 9, 9, 3)),
    "groups2": ((4, 6, 3, 3, 1, 1, 1, 1), dict(n_group=2), (2, 6, 6, 4)),
    "groups4_s2": ((8, 8, 3, 3, 2, 2, 0, 0), dict(n_group=4),
                   (2, 9, 9, 8)),
    "dilation2": ((3, 5, 3, 3, 1, 1, 0, 0),
                  dict(dilation_w=2, dilation_h=2), (1, 9, 9, 3)),
    "no_bias": ((3, 4, 1, 1, 1, 1, 0, 0), dict(with_bias=False),
                (2, 5, 5, 3)),
    "nchw": ((3, 5, 3, 3, 2, 2, 1, 1), dict(data_format="NCHW"),
             (2, 3, 8, 8)),
    "nchw_same": ((3, 5, 3, 3, 2, 2, -1, -1), dict(data_format="NCHW"),
                  (2, 3, 7, 7)),
    "stem7_s2_p3": ((3, 8, 7, 7, 2, 2, 3, 3), dict(with_bias=False),
                    (2, 16, 16, 3)),
}


@pytest.mark.parametrize("name", list(CONV_CASES))
def test_spatial_convolution_matches_jax(name):
    args, kw, shape = CONV_CASES[name]
    check(jnn.SpatialConvolution(*args, **kw),
          nn.SpatialConvolution(*args, **kw), shape)


def test_spatial_convolution_bf16_matches_jax():
    args = (4, 6, 3, 3, 2, 2, -1, -1)
    check_bf16(jnn.SpatialConvolution(*args), nn.SpatialConvolution(*args),
               (2, 9, 9, 4))


def test_dilated_convolution_matches_jax():
    args = (3, 4, 3, 3, 1, 1, 2, 2, 2, 2)
    check(jnn.SpatialDilatedConvolution(*args),
          nn.SpatialDilatedConvolution(*args), (2, 9, 9, 3))


@pytest.mark.parametrize("stride,pad,adj,fmt", [
    (2, 0, 0, "NHWC"), (2, 1, 1, "NHWC"), (1, 1, 0, "NHWC"),
    (3, 2, 2, "NHWC"), (2, 1, 1, "NCHW")])
def test_full_convolution_matches_jax(stride, pad, adj, fmt):
    args = (3, 4, 3, 3, stride, stride, pad, pad, adj, adj)
    shape = (2, 5, 5, 3) if fmt == "NHWC" else (2, 3, 5, 5)
    check(jnn.SpatialFullConvolution(*args, data_format=fmt),
          nn.SpatialFullConvolution(*args, data_format=fmt), shape)


def test_full_convolution_refuses_adj_at_stride():
    with pytest.raises(ValueError, match="below the stride"):
        nn.SpatialFullConvolution(3, 4, 3, 3, 2, 2, 0, 0, 2, 2)


@pytest.mark.parametrize("k,s,p", [(3, 1, 0), (3, 1, 1), (4, 2, -1),
                                   (3, 2, -1)])
def test_conv1d_matches_jax(k, s, p):
    check(jnn.Conv1D(6, 5, k, s, p), nn.Conv1D(6, 5, k, s, p), (2, 11, 6))


@pytest.mark.parametrize("pad", [0, -1])
def test_convolution_map_matches_jax(pad):
    table = [[0, 0], [1, 0], [1, 1], [2, 1], [0, 2], [2, 2], [2, 3]]
    check(jnn.SpatialConvolutionMap(table, 3, 3, 2, 2, pad, pad),
          nn.SpatialConvolutionMap(table, 3, 3, 2, 2, pad, pad),
          (2, 8, 7, 3))


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_space_to_depth_stem_matches_jax(fmt):
    shape = (2, 16, 12, 3) if fmt == "NHWC" else (2, 3, 16, 12)
    check(jnn.SpaceToDepthStem(3, 8, 7, data_format=fmt),
          nn.SpaceToDepthStem(3, 8, 7, data_format=fmt), shape)


def test_space_to_depth_stem_equals_plain_stem():
    """The same weights through the s2d stem and the plain 7x7/s2 pad 3
    convolution: outputs within 2e-4 (``tests/test_conv.py``'s bound)."""
    g = torch.Generator().manual_seed(0)
    plain = nn.SpatialConvolution(3, 16, 7, 7, 2, 2, 3, 3, with_bias=False,
                                  generator=g)
    s2d = nn.SpaceToDepthStem(3, 16, 7)
    s2d.load_parameters_tree(plain.parameters_tree())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    want = plain(x)
    got = s2d(x)
    assert got.shape == want.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_int8_convolution_is_refused_naming_the_roadmap():
    """The refusal this test held until ROADMAP A5's int8 half was ported
    is gone: a convolution holding ``weight_q`` / ``scale`` convolves in
    int8 (JAX ``nn/conv.py:91-99``; K6's plain version on the CPU), the
    bias in fp32 and the result in the input's dtype."""
    from bigdl_tpu_torch.nn import quantized as tq

    conv = nn.SpatialConvolution(3, 4, 3, 3, 1, 1, -1, -1)
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 5, 5, 3)).astype(np.float32))
    twin, qp = tq.quantize_model(nn.Sequential().add(conv))
    assert qp["0"]["weight_q"].dtype == torch.int8
    want = tq.int8_conv(x, qp["0"]["weight_q"], qp["0"]["scale"],
                        stride=(1, 1), padding="SAME", dilation=(1, 1),
                        groups=1, bias=qp["0"]["bias"])
    with torch.no_grad():
        np.testing.assert_array_equal(twin(x).numpy(), want.numpy())


# --------------------------------------------------------------------------- #
# Pooling
# --------------------------------------------------------------------------- #

#: (kernel, stride, pad, ceil, input side): tests/test_conv.py:110-133's
#: cases, then the ceil windows that run past the input (high pad > pad)
POOL_CASES = [
    (2, 2, 0, False, 8), (3, 2, 1, False, 8), (3, 1, 1, False, 8),
    (2, 2, 0, True, 7), (3, 2, 1, True, 7), (3, 2, 0, True, 7),
    (3, 2, 1, True, 8), (3, 2, 0, True, 8), (3, 1, 1, True, 7),
    (5, 3, 0, True, 14), (2, 2, 1, True, 6),
]


@pytest.mark.parametrize("k,s,p,ceil,n", POOL_CASES)
def test_max_pooling_matches_jax(k, s, p, ceil, n):
    jm = jnn.SpatialMaxPooling(k, k, s, s, p, p)
    tm = nn.SpatialMaxPooling(k, k, s, s, p, p)
    if ceil:
        jm, tm = jm.ceil(), tm.ceil()
    check(jm, tm, (2, n, n, 3))


@pytest.mark.parametrize("include_pad", [True, False])
@pytest.mark.parametrize("k,s,p,ceil,n", POOL_CASES)
def test_average_pooling_matches_jax(k, s, p, ceil, n, include_pad):
    jm = jnn.SpatialAveragePooling(k, k, s, s, p, p,
                                   count_include_pad=include_pad)
    tm = nn.SpatialAveragePooling(k, k, s, s, p, p,
                                  count_include_pad=include_pad)
    if ceil:
        jm, tm = jm.ceil(), tm.ceil()
    check(jm, tm, (2, n, n, 3))


def test_pooling_nchw_and_rectangular_match_jax():
    check(jnn.SpatialMaxPooling(3, 2, 2, 1, 1, 0, data_format="NCHW").ceil(),
          nn.SpatialMaxPooling(3, 2, 2, 1, 1, 0, data_format="NCHW").ceil(),
          (2, 3, 7, 8))
    check(jnn.SpatialAveragePooling(2, 3, 1, 2, 0, 1, data_format="NCHW"),
          nn.SpatialAveragePooling(2, 3, 1, 2, 0, 1, data_format="NCHW"),
          (2, 3, 7, 8))


def test_max_pooling_ties_send_the_gradient_where_jax_does():
    """All-zero windows (a ReLU before a pool) send the gradient to the
    first element, in both packages."""
    jm, tm = jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1), \
        nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1)
    jm.build(jax.ShapeDtypeStruct((1, 6, 6, 2), jnp.float32))
    x = np.maximum(np.random.default_rng(1).standard_normal(
        (1, 6, 6, 2)), 0).astype(np.float32)
    x[0, :3, :3] = 0.0
    jg = jax.grad(lambda v: jnp.sum(jm.apply((), (), v)[0]))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tm(tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("cls", ["GlobalAveragePooling2D",
                                 "GlobalMaxPooling2D"])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_global_pooling_matches_jax(cls, fmt):
    check(getattr(jnn, cls)(data_format=fmt),
          getattr(nn, cls)(data_format=fmt), (2, 5, 4, 3))


# --------------------------------------------------------------------------- #
# Normalization
# --------------------------------------------------------------------------- #

BN_CASES = {
    "bn_train": (lambda m: m.BatchNormalization(5), (8, 5), True),
    "bn_eval": (lambda m: m.BatchNormalization(5), (8, 5), False),
    "bn_momentum_eps": (lambda m: m.BatchNormalization(5, 1e-3, 0.3),
                        (6, 5), True),
    "bn_no_affine": (lambda m: m.BatchNormalization(5, affine=False),
                     (8, 5), True),
    "spatial_train": (lambda m: m.SpatialBatchNormalization(4),
                      (3, 5, 6, 4), True),
    "spatial_eval": (lambda m: m.SpatialBatchNormalization(4),
                     (3, 5, 6, 4), False),
    "spatial_eps": (lambda m: m.SpatialBatchNormalization(4, 1e-3),
                    (2, 4, 4, 4), True),
}


def _with_stats(jm, tm, shape):
    """Non-trivial running statistics in both packages (eval reads them)."""
    n = shape[-1]
    rng = np.random.default_rng(9)
    state = {"running_mean": rng.standard_normal(n).astype(np.float32),
             "running_var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
    jm.set_state_entries(state)
    return state


@pytest.mark.parametrize("name", list(BN_CASES))
def test_batchnorm_matches_jax(name):
    build, shape, training = BN_CASES[name]
    jm, tm = build(jnn), build(nn)
    _with_stats(jm, tm, shape)
    check(jm, tm, shape, training=training, steps=3 if training else 1)


@pytest.mark.parametrize("name", ["bn_train", "spatial_train",
                                  "spatial_eval"])
def test_batchnorm_bf16_matches_jax(name):
    build, shape, training = BN_CASES[name]
    jm, tm = build(jnn), build(nn)
    _with_stats(jm, tm, shape)
    check_bf16(jm, tm, shape, training=training)


def test_batchnorm_keys_and_state_tree():
    bn = nn.SpatialBatchNormalization(3)
    assert [k for k, _ in bn.named_parameters()] == ["weight", "bias"]
    assert sorted(bn.state_tree()) == ["running_mean", "running_var"]
    assert nn.BatchNormalization(3, affine=False).jax_empty_params == {}
    # SyncBN (ROADMAP A4, ported): inside the context a training-mode
    # BatchNorm pools its moments over the world -- here the world of one
    # the engine starts on gloo, where pooling is the identity but runs
    # through the group's all_reduce; worlds of 2 and 4 in
    # tests/test_torch_distri_optimizer.py
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import collectives
    from bigdl_tpu_torch.utils.engine import Engine

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 3, 3, 3)).astype(np.float32)).requires_grad_()
    plain = nn.SpatialBatchNormalization(3)
    synced = nn.SpatialBatchNormalization(3)
    calls = []
    real = dist.all_reduce
    try:
        Engine.init(device="cpu")
        dist.all_reduce = lambda t, **kw: (calls.append(t.shape),
                                           real(t, **kw))[1]
        with nn.normalization.sync_batchnorm("data") as coll:
            assert isinstance(coll, collectives.Collectives)
            assert (coll.world, coll.backend) == (1, "gloo")
            y = synced(x)
            y.square().sum().backward()
        g = x.grad.clone()
        x.grad = None
        y_plain = plain(x)
        y_plain.square().sum().backward()
        assert len(calls) == 4    # E[x] and E[x^2], forward and backward
        assert torch.equal(y, y_plain)
        assert torch.equal(g, x.grad)
        assert torch.equal(synced.running_var, plain.running_var)
    finally:
        dist.all_reduce = real
        Engine.reset()


@pytest.mark.parametrize("size,fmt", [(5, "NHWC"), (4, "NHWC"),
                                      (5, "NCHW"), (3, "NHWC")])
def test_lrn_matches_jax(size, fmt):
    shape = (2, 4, 5, 7) if fmt == "NHWC" else (2, 7, 4, 5)
    check(jnn.SpatialCrossMapLRN(size, 0.5, 0.75, 2.0, data_format=fmt),
          nn.SpatialCrossMapLRN(size, 0.5, 0.75, 2.0, data_format=fmt),
          shape)


@pytest.mark.parametrize("p", [2.0, 1.0, 3.0, float("inf")])
def test_normalize_matches_jax(p):
    check(jnn.Normalize(p), nn.Normalize(p), (4, 6))


def test_rmsnorm_matches_jax():
    check(jnn.RMSNorm(6), nn.RMSNorm(6), (3, 4, 6))


def test_dropout_rate_scale_and_eval():
    drop = nn.Dropout(0.3)
    x = torch.ones(20000)
    assert torch.equal(drop(x), x)          # no step key: no mask
    with tdrop.step_key(torch.tensor(7)):
        y = drop(x)
        assert torch.equal(drop(x), y)      # one key, one mask
    kept = (y > 0).float().mean().item()
    sigma = (0.3 * 0.7 / x.numel()) ** 0.5
    assert abs(kept - 0.7) < 5 * sigma
    np.testing.assert_allclose(y[y > 0].numpy(), 1 / 0.7, rtol=1e-6)
    drop.eval()
    with tdrop.step_key(torch.tensor(7)):
        assert torch.equal(drop(x), x)
    model = nn.Sequential().add(nn.Dropout(0.5)).add(nn.Dropout(0.5))
    tdrop.salt_by_path(model)
    salts = [m.dropout_salt for m in model._modules.values()]
    assert len(set(salts)) == 2 and tdrop.uses_dropout(model)


# --------------------------------------------------------------------------- #
# Activations and reshapes
# --------------------------------------------------------------------------- #

#: class name -> (constructor args, input made positive)
ACTIVATIONS = {
    "ReLU": ((), False), "Tanh": ((), False), "Sigmoid": ((), False),
    "SoftMax": ((), False), "SoftMin": ((), False),
    "LogSoftMax": ((), False), "HardTanh": ((-0.5, 0.7), False),
    "Clamp": ((-0.3, 0.4), False), "ReLU6": ((), False),
    "ELU": ((0.7,), False), "SoftPlus": ((2.0,), False),
    "SoftSign": ((), False), "LeakyReLU": ((0.1,), False),
    "Threshold": ((0.2, -1.0), False), "HardSigmoid": ((), False),
    "LogSigmoid": ((), False), "TanhShrink": ((), False),
    "SoftShrink": ((0.4,), False), "HardShrink": ((0.4,), False),
    "Power": ((1.5, 2.0, 0.5), True), "Square": ((), False),
    "Sqrt": ((), True), "Abs": ((), False), "Exp": ((), False),
    "Log": ((), True), "Negative": ((), False),
    "MulConstant": ((1.7,), False), "AddConstant": ((-0.6,), False),
    "GELU": ((), False), "SiLU": ((), False), "PReLU": ((4,), False),
}


@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_matches_jax(name):
    args, positive = ACTIVATIONS[name]
    jm, tm = getattr(jnn, name)(*args), getattr(nn, name)(*args)
    jm, jp, js, x = pair(jm, tm, (3, 5, 4))
    if positive:
        x = np.abs(x) + 0.1
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xin):
        y, _ = jm.apply(p, js, xin)
        return jnp.sum(y * r), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(jp,
                                                           jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    ty = tm(tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    (ty * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _flat(_np(jgp))[k], **TOL)


def test_elementwise_maps_a_table():
    a, b = torch.randn(3), torch.randn(2)
    out = nn.ReLU()((a, b))
    assert isinstance(out, tuple)
    assert torch.equal(out[0], a.relu()) and torch.equal(out[1], b.relu())


#: name -> (builder(module), input shape)
RESHAPES = {
    "Reshape": (lambda m: m.Reshape((4, 6)), (2, 3, 8)),
    "Reshape-no-batch": (lambda m: m.Reshape((6, 8), batch_mode=False),
                         (2, 3, 8)),
    "View": (lambda m: m.View((-1, 4)), (2, 3, 8)),
    "InferReshape": (lambda m: m.InferReshape((0, -1, 2)), (2, 3, 8)),
    "InferReshape-batch": (lambda m: m.InferReshape((0, -1), True),
                           (2, 3, 8)),
    "Flatten": (lambda m: m.Flatten(), (2, 3, 4, 2)),
    "Squeeze": (lambda m: m.Squeeze(1), (2, 1, 5)),
    "Squeeze-all": (lambda m: m.Squeeze(), (2, 1, 5, 1)),
    "Unsqueeze": (lambda m: m.Unsqueeze(2), (2, 3, 4)),
    "Transpose": (lambda m: m.Transpose([(1, 2), (0, 2)]), (2, 3, 4)),
    "Permute": (lambda m: m.Permute((2, 0, 1)), (2, 3, 4)),
    "Select": (lambda m: m.Select(1, 2), (2, 3, 4)),
    "Narrow": (lambda m: m.Narrow(2, 1, 2), (2, 3, 5)),
    "Narrow-negative": (lambda m: m.Narrow(2, 1, -2), (2, 3, 5)),
    "Contiguous": (lambda m: m.Contiguous(), (2, 3)),
    "Padding-after": (lambda m: m.Padding(1, 2, 0.5), (2, 3, 4)),
    "Padding-before": (lambda m: m.Padding(2, -3), (2, 3, 4)),
    "Replicate": (lambda m: m.Replicate(3, 1), (2, 4)),
    "Tile": (lambda m: m.Tile(1, 3), (2, 3, 2)),
}


@pytest.mark.parametrize("name", list(RESHAPES))
def test_reshape_matches_jax(name):
    build, shape = RESHAPES[name]
    check(build(jnn), build(nn), shape)


# --------------------------------------------------------------------------- #
# Initializers and Linear
# --------------------------------------------------------------------------- #


def test_initializers_draw_from_the_generator():
    g = lambda: torch.Generator().manual_seed(3)   # noqa: E731
    shape = (3, 3, 64, 128)
    fan_in, fan_out = 3 * 3 * 64, 3 * 3 * 128
    for init in (tinit.RandomUniform(), tinit.RandomUniform(-0.2, 0.3),
                 tinit.RandomNormal(0.5, 0.1), tinit.MsraFiller(),
                 tinit.MsraFiller(False), tinit.Xavier()):
        a = init.init(g(), shape, fan_in, fan_out)
        assert torch.equal(a, init.init(g(), shape, fan_in, fan_out))
        assert a.shape == shape and a.dtype == torch.float32
    msra = tinit.MsraFiller(False).init(g(), shape, fan_in, fan_out)
    assert abs(msra.std().item() / (2.0 / fan_in) ** 0.5 - 1) < 0.02
    uni = tinit.RandomUniform(-0.2, 0.3).init(g(), shape, fan_in, fan_out)
    assert uni.min() >= -0.2 and uni.max() < 0.3
    assert torch.equal(tinit.Ones().init(None, (2,), 1, 1), torch.ones(2))
    assert torch.equal(tinit.ConstInitMethod(0.5).init(None, (2,), 1, 1),
                       torch.full((2,), 0.5))


@pytest.mark.parametrize("shape", [(4, 4, 2, 3), (3, 3, 1, 1), (5, 5)])
def test_bilinear_filler_matches_jax(shape):
    want = jnn.initialization.BilinearFiller().init(None, shape, 1, 1)
    got = tinit.BilinearFiller().init(None, shape, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_linear_takes_the_jax_constructor():
    from bigdl_tpu_torch.optim.regularizer import L2Regularizer

    reg = L2Regularizer(0.1)
    lin = nn.Linear(4, 3, with_bias=False,
                    weight_init=tinit.ConstInitMethod(0.25),
                    w_regularizer=reg, name="fc1")
    assert lin.name == "fc1" and lin.w_regularizer is reg
    assert [k for k, _ in lin.named_parameters()] == ["weight"]
    assert torch.equal(lin(torch.ones(2, 4)), torch.ones(2, 3))
    check(jnn.Linear(6, 5, name="fc"), nn.Linear(6, 5, name="fc"), (3, 6))
    check(jnn.Linear(6, 5, with_bias=False), nn.Linear(6, 5,
                                                       with_bias=False),
          (3, 6))
    with pytest.raises(ValueError, match="input_size"):
        nn.Linear(None, 3)
