"""The port's int8 quantization against the JAX package's, on the CPU
(``bigdl_tpu_torch/ops/quantization.py`` and ``nn/quantized.py`` against
``bigdl_tpu/ops/quantization.py`` and ``bigdl_tpu/nn/quantized.py``).

Tolerances: the quantizers and the int8 product are held EXACT (payloads,
scales, the int32 sum and the fp32 result, whose scale products are
formed in the same order); a twin's logits are held to 1e-5 absolute
against JAX's twin on the same int8 tree (the fp32 parts of the network
sum in another order, which can move an activation across a rounding
boundary of its int8 code: one code is 1/127 of the step's absmax).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.ops import quantization as jops
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.interop.jax_params import to_port_tree
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.ops import quantization as tops

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 56, 32, 4, 2, 48


def _jax_lm(scan=False, key=0):
    m = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
              scan_layers=scan)
    m.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
            rng=jax.random.PRNGKey(key))
    return m


def _port_lm(jm):
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    return load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))


def _np(tree):
    """A nested dict of tensors / arrays -> numpy leaves."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return np.asarray(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _vector():
    """Eight blocks of 64: a NaN block, an Inf block, a zero block, values
    on .5 boundaries and ordinary normals."""
    x = np.random.default_rng(0).normal(size=512).astype(np.float32) * 3
    x[5] = np.nan
    x[70] = np.inf
    x[128:192] = 0.0
    x[200:204] = [0.5, 1.5, 2.5, -2.5]
    return x


@pytest.mark.parametrize("scale_dtype", ["fp32", "bf16"])
def test_quantize_blockwise_matches_jax(scale_dtype):
    x = _vector()
    want_q, want_s = jops.quantize_blockwise(jnp.asarray(x), 64,
                                             scale_dtype=scale_dtype)
    got_q, got_s = tops.quantize_blockwise(torch.from_numpy(x), 64,
                                           scale_dtype=scale_dtype)
    assert got_q.dtype == torch.int8
    assert got_s.dtype == {"fp32": torch.float32,
                           "bf16": torch.bfloat16}[scale_dtype]
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.float().numpy(),
                                  np.asarray(want_s, np.float32))
    # the non-finite blocks (0, 1) and the zero block (2) have scale 0 and
    # dequantize to exact zeros; the rest round trip within half a scale
    deq = tops.dequantize_blockwise(got_q, got_s, 64)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jops.dequantize_blockwise(want_q, want_s,
                                                          64)))
    assert not got_s[:3].float().any() and not deq[:192].any()
    err = (deq[192:] - torch.from_numpy(x[192:])).abs().reshape(-1, 64)
    assert (err <= got_s[3:].float()[:, None] / 2 * (1 + 1e-6)).all()


def test_quantize_blockwise_default_scale_is_bf16_and_refuses_bad_shapes():
    q, s = tops.quantize_blockwise(torch.ones(8), 4)
    assert s.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiple"):
        tops.quantize_blockwise(torch.ones(10), 4)


def test_channelwise_activation_and_int8_matmul_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 3072)).astype(np.float32)
    x = rng.normal(size=(3, 5, 3072)).astype(np.float32) * 4
    jw = jq.quantize_channelwise(jnp.asarray(w), 0)
    tw = tq.quantize_channelwise(torch.from_numpy(w), 0)
    for got, want in zip(tw, jw):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jpc = jq.quantize_weights_per_channel(jnp.asarray(w), 0)
    tpc = tq.quantize_weights_per_channel(torch.from_numpy(w), 0)
    for got, want in zip(tpc, jpc):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jx = jq._quantize_activation(jnp.asarray(x))
    tx = tq._quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(tx[0].numpy(), np.asarray(jx[0]))
    assert float(tx[1]) == float(jx[1])
    # the int32 sum is exact: codes near the rails over K = 3072 sum past
    # 2^24, where a sum of floats holding the codes rounds
    a8 = torch.from_numpy(rng.integers(100, 128, (7, 3072)).astype(np.int8))
    b8 = torch.from_numpy(rng.integers(100, 128, (40, 3072)).astype(np.int8))
    acc = tq._int_mm(a8, b8)
    exact = a8.numpy().astype(np.int64) @ b8.numpy().astype(np.int64).T
    assert acc.dtype == torch.int32 and exact.min() > 2 ** 24
    np.testing.assert_array_equal(acc.numpy(), exact)
    assert (torch.mm(a8.float(), b8.float().t()).double().numpy()
            != exact).any()
    got = tq.int8_matmul(torch.from_numpy(x), tw[0], tw[1])
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jw[0], jw[1]))
    assert got.shape == (3, 5, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("select", [None, "fc_only"])
def test_quantize_params_matches_jax(select):
    jm = _jax_lm()
    tm = _port_lm(jm)
    pred = None if select is None else (lambda path, m: "fc" in path)
    want = _flat(_np(jq.quantize_params(jm, select=pred)))
    got = _flat(_np(tq.quantize_params(tm, select=pred)))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:          # scales: within 1 ulp; fp32 leaves pass through
            np.testing.assert_allclose(g, w, rtol=np.finfo(np.float32).eps,
                                       atol=0, err_msg=key)
    n_sites = 2 * LAYERS if select else 4 * LAYERS
    assert sum(k.endswith("_q") for k in got) == n_sites


def test_quantize_model_leaves_the_fp32_model_alone_and_counts_match():
    jm = _jax_lm()
    tm = _port_lm(jm)
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, VOCAB, (2, 11)).astype(np.int32))
    with torch.no_grad():
        before = tm(x)
    fp_tree = {k: v.clone() for k, v in _flat(tm.parameters_tree()).items()}
    qm, qp = tq.quantize_model(tm)
    with torch.no_grad():
        after = tm(x)
        tq_logits = qm(x)
    assert torch.equal(before, after)
    for k, v in _flat(tm.parameters_tree()).items():
        assert torch.equal(v, fp_tree[k]), k
    # the twin owns its tensors: none shares storage with the fp32 model
    fp_ptrs = {p.data_ptr() for p in tm.parameters()}
    assert not fp_ptrs & {p.data_ptr() for p in qm.parameters()}
    assert not any(p.requires_grad for p in qm.parameters())
    assert "qkv_weight_q" in qm.block0.attn._parameters
    assert "weight" not in qm.block0.fc1._parameters
    assert tq_logits.shape == before.shape
    assert not torch.equal(tq_logits, before)
    jq_model, jq_params = jq.quantize_model(jm)
    assert tq.quantized_leaf_count(qp) == jq.quantized_leaf_count(jq_params)
    assert tq.quantized_leaf_count(tm.parameters_tree()) == 0
    assert tq.model_bytes(qp) == jq.model_bytes(jq_params)
    assert tq.model_bytes(tm.parameters_tree()) == \
        jq.model_bytes(jm.parameters()[0])


@pytest.mark.parametrize("scan", [False, True])
def test_jax_int8_tree_loads_into_the_twin_and_gives_its_logits(scan):
    jm = _jax_lm(scan=scan, key=3)
    jq_model, jq_params = jq.quantize_model(jm)
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu", seed=9)
    qm, _ = tq.quantize_model(tm)          # other weights: overwritten
    load_jax_params(qm, jax.tree.map(np.asarray, jq_params))
    assert qm.block1.attn.qkv_weight_q.dtype == torch.int8
    assert qm.block1.attn.qkv_scale.dtype == torch.float32
    x = np.random.default_rng(4).integers(0, VOCAB, (3, 13)).astype(np.int32)
    want, _ = jq_model.apply(jq_params, (), jnp.asarray(x))
    with torch.no_grad():
        got = qm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # an fp32 tree does not load into the twin, nor an int8 one into fp32
    with pytest.raises(KeyError):
        load_jax_params(qm, jax.tree.map(np.asarray, jm.parameters()[0]))
    bad = to_port_tree(jax.tree.map(np.asarray, jq_params))
    bad["block0"]["fc1"]["weight_q"] = bad["block0"]["fc1"][
        "weight_q"].astype(np.float32)
    with pytest.raises(TypeError, match="weight_q"):
        qm.load_parameters_tree(bad)
