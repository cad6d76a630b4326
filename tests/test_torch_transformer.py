"""The port's TransformerLM against the JAX package's on the same weights,
on the CPU (``bigdl_tpu_torch/nn`` vs ``bigdl_tpu/nn``).

Weights are made by the JAX model from a seed and cross through the
weight bridge (``interop/jax_params.py``) in both layouts: unrolled
``block{i}`` and scan-stacked ``blocks``.  Small model: vocab 512,
hidden 64, 4 heads, 2 layers, max_len 128.  Tolerance 1e-4 abs and rel
in fp32 (same math, sums in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.models.transformer import synthetic_corpus as jax_corpus
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.nn.normalization import LayerNorm as JaxLayerNorm
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm
from bigdl_tpu_torch.nn import LayerNorm, Linear, TransformerLM
from bigdl_tpu_torch.nn.attention import (stack_block_params,
                                          unstack_block_params)

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 512, 64, 4, 2, 128


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(scan=False, use_flash="auto", seed=0):
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
               scan_layers=scan)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(seed))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       use_flash=use_flash, device="cpu")
    load_jax_params(tm, _np_tree(jm.parameters()[0]))
    return jm, tm


def _tokens(n, t, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t)).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("use_flash", ["auto", "never"])
def test_full_forward_matches_jax(scan, use_flash):
    jm, tm = _pair(scan, use_flash)
    x = _tokens(2, 37)
    want, _ = jm.apply(jm.parameters()[0], (), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("scan", [False, True])
def test_cached_prefill_and_decode_match_jax(scan):
    jm, tm = _pair(scan)
    params = jm.parameters()[0]
    x = _tokens(3, 12, seed=1)
    jc = jm.init_cache(3, 32)
    want, jc = jm.apply(params, (), jnp.asarray(x), cache=jc)
    tc = tm.init_cache(3, 32)
    with torch.no_grad():
        got, tc = tm(torch.from_numpy(x), cache=tc)
        _close(got, want)
        pos = np.array([12, 5, 11], np.int32)       # ragged frontiers
        for step in range(3):
            tok = _tokens(3, 1, seed=10 + step)
            want, jc = jm.apply(params, (), jnp.asarray(tok), cache=jc,
                                pos=jnp.asarray(pos))
            got, tc = tm(torch.from_numpy(tok), cache=tc,
                         pos=torch.from_numpy(pos))
            _close(got, want)
            pos = pos + 1


@pytest.mark.parametrize("scan", [False, True])
def test_paged_chunk_prefill_and_decode_match_jax(scan):
    jm, tm = _pair(scan)
    params = jm.parameters()[0]
    bs, mb, nblocks = 4, 8, 20
    trash = nblocks
    rng = np.random.default_rng(2)
    tables = np.full((2, mb), trash, np.int32)
    tables[0, :5] = rng.permutation(nblocks)[:5]
    tables[1, :3] = [b for b in range(nblocks)
                     if b not in tables[0, :5]][:3]
    jp = jm.init_paged_cache(nblocks, bs)
    tp = tm.init_paged_cache(nblocks, bs)
    # two chunks of 8 for row 0 (15 real tokens), one partial chunk row 1
    prompt = _tokens(2, 16, seed=3)
    starts = [np.array([0, 0], np.int32), np.array([8, 6], np.int32)]
    lens = [np.array([8, 6], np.int32), np.array([7, 0], np.int32)]
    with torch.no_grad():
        for start, ln in zip(starts, lens):
            chunk = np.stack([prompt[0, start[0]:start[0] + 8],
                              np.pad(prompt[1, start[1]:start[1] + 8],
                                     (0, 8 - len(prompt[1, start[1]:
                                                        start[1] + 8])))])
            want, jp = jm.apply_paged(params, jnp.asarray(chunk), jp,
                                      jnp.asarray(tables),
                                      pos=jnp.asarray(start),
                                      lengths=jnp.asarray(ln))
            got, tp = tm.apply_paged(torch.from_numpy(chunk), tp,
                                     torch.from_numpy(tables),
                                     pos=torch.from_numpy(start),
                                     lengths=torch.from_numpy(ln))
            # padding positions are garbage on both sides; compare the
            # real ones
            for r in range(2):
                _close(got[r, :ln[r]], want[r, :ln[r]])
        pos = np.array([15, 6], np.int32)
        for step in range(3):
            tok = _tokens(2, 1, seed=20 + step)
            want, jp = jm.apply_paged(params, jnp.asarray(tok), jp,
                                      jnp.asarray(tables),
                                      pos=jnp.asarray(pos))
            got, tp = tm.apply_paged(torch.from_numpy(tok), tp,
                                     torch.from_numpy(tables),
                                     pos=torch.from_numpy(pos))
            _close(got, want)
            pos = pos + 1


def test_bridge_layouts_and_keys():
    jm_u, tm = _pair(scan=False)
    jm_s, _ = _pair(scan=True)
    ju = _np_tree(jm_u.parameters()[0])
    js = _np_tree(jm_s.parameters()[0])
    # one seed gives bit-identical weights in both JAX layouts
    restacked = stack_block_params(unstack_block_params(js))
    np.testing.assert_array_equal(restacked["blocks"]["attn"]["qkv_weight"],
                                  js["blocks"]["attn"]["qkv_weight"])
    tree = tm.parameters_tree()
    assert set(tree) == set(ju)
    flat_j = jax.tree_util.tree_flatten_with_path(ju)[0]
    for path, leaf in flat_j:
        node = tree
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


def test_bridge_refuses_a_mismatched_tree():
    _jm, tm = _pair()
    tree = {k: v for k, v in tm.parameters_tree().items() if k != "wpe"}
    with pytest.raises(KeyError, match="wpe"):
        tm.load_parameters_tree(tree)
    tree = tm.parameters_tree()
    tree["head"] = np.zeros((VOCAB, HIDDEN + 1), np.float32)
    with pytest.raises(ValueError, match="head"):
        tm.load_parameters_tree(tree)


def test_layernorm_and_linear_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(64).astype(np.float32), \
        rng.standard_normal(64).astype(np.float32)
    jln = JaxLayerNorm(64)
    want, _ = jln.apply({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                        (), jnp.asarray(x))
    ln = LayerNorm(64)
    assert ln.eps == 1e-6
    ln.load_parameters_tree({"weight": w, "bias": b})
    with torch.no_grad():
        _close(ln(torch.from_numpy(x)), want)
    lin = Linear(64, 8, generator=torch.Generator().manual_seed(0))
    assert tuple(lin.weight.shape) == (8, 64)
    with torch.no_grad():
        want = x @ lin.weight.numpy().T + lin.bias.numpy()
        np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(), want,
                                   **TOL)


def test_synthetic_corpus_matches_jax_and_configs():
    for a, b in zip(synthetic_corpus(3, 20, 100, seed=5),
                    jax_corpus(3, 20, 100, seed=5)):
        np.testing.assert_array_equal(a, b)
    m = transformer_lm("tiny", vocab_size=64, max_len=32, device="cpu")
    assert sum(1 for _ in m.blocks) == 4 and m.hidden_size == 256
    m2 = transformer_lm("tiny", vocab_size=64, max_len=32, device="cpu")
    assert torch.equal(m.block0.attn.qkv_weight, m2.block0.attn.qkv_weight)


def test_device_none_means_the_card():
    """Entry points default to CUDA and raise clearly without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_lm("tiny", vocab_size=64, max_len=32)


def test_tf32_matmul_is_switched_off():
    """The port computes in fp32 like the JAX reference: a caller's TF32
    setting is switched off, with a warning."""
    from bigdl_tpu_torch.utils.device import require_fp32_matmul

    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.warns(RuntimeWarning, match="TF32"):
            require_fp32_matmul()
        assert torch.get_float32_matmul_precision() == "highest"
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)
