"""The port's int8 twin serving, accuracy gate and speculative decoding
against the JAX package's, on the CPU (``bigdl_tpu_torch/optim/
validation.py`` and ``serving/`` against ``bigdl_tpu/optim/validation.py``
and ``bigdl_tpu/serving/``).

- ``AccuracyDeltaGate.compare``/``check`` give JAX's detail dict on the
  same logits (exact: both are numpy over the same arrays);
- a gate no quantizer can clear (``max_logit_rmse=0.0``) refuses the
  engine at construction, in both packages;
- greedy streams are held EXACTLY: the ``quantize=True`` engine against
  JAX's, the speculative engines against the port's verifier-only
  engine and JAX's speculative engine, and ``stats()["speculative"]``
  against JAX's.  Requests go one at a time: the twin quantizes its
  activations per tensor over the whole step, so which requests share a
  tick changes the drafts (never the verified stream).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.optim.validation import AccuracyDeltaGate as JaxGate
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.optim import AccuracyDeltaGate
from bigdl_tpu_torch.serving import ServingEngine

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 50, 32, 4, 2, 64
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11], [4] * 9, list(range(5, 23))]
KW = dict(decode_slots=3, decode_max_len=48, kv_block_size=4)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(0))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _features(n=8, t=16):
    return np.random.default_rng(0).integers(0, VOCAB, (n, t)).astype(
        np.int32)


def _serve(eng, prompts, n_new=6, **kw):
    """One request at a time (see the module docstring)."""
    return [eng.generate(p, max_new_tokens=n_new, **kw).result(120)
            for p in prompts]


def test_gate_compare_and_check_match_jax():
    rng = np.random.default_rng(3)
    ref = rng.normal(size=(6, 5, 7)).astype(np.float32)
    cand = ref + rng.normal(scale=0.3, size=ref.shape).astype(np.float32)
    labels = rng.integers(0, 35, 6)
    assert AccuracyDeltaGate.compare(ref, cand, labels) == \
        JaxGate.compare(ref, cand, labels)
    assert AccuracyDeltaGate.compare(ref, cand) == JaxGate.compare(ref, cand)
    for kw in ({"min_top1_agreement": 0.99},
               {"min_top1_agreement": 0.0, "max_logit_rmse": 0.1},
               {"min_top1_agreement": None, "max_logit_rmse": 1.0},
               {"min_top1_agreement": 0.0, "max_top1_accuracy_drop": -1.0}):
        for lab in (None, labels):
            got = AccuracyDeltaGate(ref, lab, **kw).check(
                lambda x: x, lambda x: cand)
            want = JaxGate(ref, lab, **kw).check(lambda x: x,
                                                 lambda x: cand)
            assert got == want, (kw, lab is None)
    with pytest.raises(ValueError, match="gates nothing"):
        AccuracyDeltaGate(ref, min_top1_agreement=None)


def test_gate_refuses_the_engine_at_construction(models):
    jm, tm = models
    gate = {"features": _features(), "min_top1_agreement": None,
            "max_logit_rmse": 0.0}
    with pytest.raises(ValueError, match="accuracy gate refused"):
        JaxEngine(jm, quantize=True, accuracy_gate=gate, **KW)
    for extra in ({"quantize": True}, {"speculative": 2}):
        with pytest.raises(ValueError, match="accuracy gate refused"):
            ServingEngine(tm, accuracy_gate=gate, device="cpu", **KW,
                          **extra)
    with pytest.raises(ValueError, match="accuracy_gate"):
        ServingEngine(tm, accuracy_gate=gate, device="cpu", **KW)


def test_quantized_engine_stream_and_gate_match_jax(models):
    jm, tm = models
    gate = {"features": _features(), "min_top1_agreement": 0.0}
    with JaxEngine(jm, quantize=True, accuracy_gate=gate, **KW) as eng:
        want = _serve(eng, PROMPTS)
        want_detail = eng._gate_detail
        want_bytes = eng.serving_model_bytes()
    with ServingEngine(tm, quantize=True, accuracy_gate=gate, device="cpu",
                       **KW) as eng:
        assert eng.quantized
        assert "qkv_weight_q" in eng._qmodel.block0.attn._parameters
        got = _serve(eng, PROMPTS)
        detail = eng._gate_detail
        assert eng.serving_model_bytes() == want_bytes
    assert got == want
    assert detail["ok"] and detail["batch"] == want_detail["batch"]
    assert detail["top1_agreement"] == want_detail["top1_agreement"]
    # JAX's engine gates through its jitted eval steps, whose fused fp32
    # arithmetic moves some int8 activation codes against JAX's own eager
    # apply (logits 2e-3 apart); the port is held to the eager twin
    jq_model, jq_params = jq.quantize_model(jm)
    _, eager = JaxGate(**gate).check(
        lambda x: jm.apply(jm.parameters()[0], (), jnp.asarray(x))[0],
        lambda x: jq_model.apply(jq_params, (), jnp.asarray(x))[0])
    assert detail["top1_agreement"] == eager["top1_agreement"]
    for key in ("logit_rmse", "logit_max_abs_delta"):
        assert detail[key] == pytest.approx(eager[key], rel=1e-4), key


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_speculative_streams_and_stats_match(models, kv):
    jm, tm = models
    with JaxEngine(jm, kv_cache_dtype=kv, speculative=2, **KW) as eng:
        want = _serve(eng, PROMPTS)
        want_spec = eng._gen.stats()["speculative"]
    with ServingEngine(tm, kv_cache_dtype=kv, device="cpu", **KW) as eng:
        plain = _serve(eng, PROMPTS)
    with ServingEngine(tm, kv_cache_dtype=kv, speculative=2, device="cpu",
                       **KW) as eng:
        assert eng._qmodel is not None and not eng.quantized
        got = _serve(eng, PROMPTS)
        st = eng._gen.stats()
    assert got == plain == want
    assert st["speculative"] == want_spec
    assert st["speculative"]["rounds"] > 0
    assert st["served"] == len(PROMPTS)
    assert st["kv"]["kv_dtype"] == kv


def test_speculative_seeded_sampling_replays_and_matches_plain(models):
    _jm, tm = models
    kw = dict(temperature=0.8, top_k=10, seed=11)
    with ServingEngine(tm, speculative=3, device="cpu", **KW) as eng:
        a = _serve(eng, [[1, 2, 3]], **kw)
        b = _serve(eng, [[1, 2, 3]], **kw)
    with ServingEngine(tm, device="cpu", **KW) as eng:
        c = _serve(eng, [[1, 2, 3]], **kw)
    assert a == b == c


def test_speculative_refusals(models):
    _jm, tm = models
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(tm, kv_cache="contiguous", speculative=2,
                      device="cpu", **KW)
    with pytest.raises(ValueError, match="speculative"):
        ServingEngine(tm, speculative=-1, device="cpu", **KW)
