"""``validate``, ``evaluate``, ``Predictor`` and ``Module.predict`` of the
port (``bigdl_tpu_torch/optim/predictor.py``, ``local_optimizer.validate``)
against the JAX package's, and the compiled eval step's CPU path
(``validation.CompiledEvalStep``), on the "tiny" TransformerLM (vocab 256,
seq 64) with JAX's weights.

- ``validate`` and ``evaluate`` with ``Loss``, ``Top1Accuracy`` and
  ``Top5Accuracy`` over 11 held-out sequences at batch 4 (a ragged tail
  of 3): the results against JAX's (Loss 1e-5 relative, counts exact);
  in bf16 against JAX's bf16 (1e-3).
- ``Predictor.predict`` / ``predict_class`` and ``Module.predict`` over
  arrays, Samples and a dataset: every output row against JAX's (1e-5),
  the classes exactly; the ragged tail padded to the run's batch, so one
  built step serves the run, or to a ``BucketLadder`` rung (the caller's
  ladder left as it was).
- The compiled eval step on the CPU: one per (model, dtype), cached on
  the model and not carried by a copy of it; one build per input shape;
  ``precompile`` counting what it built; the bound's warning; a
  validated model's ``Predictor`` reusing validation's steps.
"""

import copy
import logging

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm
from bigdl_tpu_torch.serving import BucketLadder

VOCAB, SEQ, N, BATCH = 256, 64, 11, 4


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads a test: workers running these tests side by side
    would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.nn.attention import TransformerLM as JaxLM
    from bigdl_tpu_torch.interop import load_jax_params

    jm = JaxLM(VOCAB, 256, 4, 4, max_len=SEQ)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32),
             rng=jax.random.PRNGKey(0))
    tm = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu", seed=4)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _held_out():
    return synthetic_corpus(N, SEQ, VOCAB, seed=7)


def _val(dataset_pkg):
    x, y = _held_out()
    return dataset_pkg.array_dataset(x, y, shuffle_on_epoch=False) >> \
        dataset_pkg.SampleToMiniBatch(BATCH, drop_remainder=False)


def _methods(o, m):
    return [o.Loss(m.TimeDistributedCriterion(
        m.FusedSoftmaxCrossEntropyCriterion())), o.Top1Accuracy(),
        o.Top5Accuracy()]


def _check_results(got, want, rtol):
    assert [r.fmt for r in got] == [r.fmt for r in want]
    for g, w in zip(got, want):
        assert g.denominator == w.denominator
        if g.fmt == "Loss":
            np.testing.assert_allclose(g.numerator, w.numerator, rtol=rtol)
        else:
            assert g.numerator == w.numerator, g.fmt


@pytest.mark.parametrize("entry", ["validate", "evaluate"])
def test_validate_and_evaluate_match_jax(pair, entry):
    from bigdl_tpu import dataset as jds
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu_torch import dataset as tds

    jm, tm = pair
    if entry == "validate":
        want = joptim.validate(jm, jm.parameters()[0], jm.state(), _val(jds),
                               _methods(joptim, jnn))
        got = optim.validate(tm, _val(tds), _methods(optim, nn))
    else:
        want = joptim.evaluate(jm, _val(jds), _methods(joptim, jnn))
        got = optim.evaluate(tm, _val(tds), _methods(optim, nn))
    _check_results(got, want, 1e-5)
    assert got[0].denominator == N          # the ragged tail counted


def test_validate_bf16_matches_jax(pair):
    import jax.numpy as jnp

    from bigdl_tpu import dataset as jds
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu_torch import dataset as tds

    jm, tm = pair
    want = joptim.validate(jm, jm.parameters()[0], jm.state(), _val(jds),
                           _methods(joptim, jnn)[:1], jnp.bfloat16)
    got = optim.validate(tm, _val(tds), _methods(optim, nn)[:1],
                         torch.bfloat16)
    np.testing.assert_allclose(got[0].numerator, want[0].numerator,
                               rtol=1e-3)


@pytest.mark.parametrize("form", ["arrays", "samples", "dataset"])
def test_predictor_matches_jax(pair, form):
    from bigdl_tpu import dataset as jds
    from bigdl_tpu.dataset import Sample as JSample
    from bigdl_tpu.optim import Predictor as JPredictor
    from bigdl_tpu_torch import dataset as tds

    jm, tm = pair
    x, _ = _held_out()
    if form == "arrays":
        jdata, tdata = list(x), list(x)
    elif form == "samples":
        jdata = [JSample(r) for r in x]
        tdata = [Sample(r) for r in x]
    else:
        jdata, tdata = _val(jds), _val(tds)
    want = JPredictor(jm, BATCH).predict(jdata)
    model = copy.deepcopy(tm)                # without tm's built steps
    got = optim.Predictor(model, BATCH).predict(tdata)
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    # the tail of 3 padded to 4: one built step served the run
    assert [k[0] for k in optim.compiled_eval_step(model).stats()["keys"]] \
        == [(BATCH, SEQ)]


def test_module_predict_matches_jax(pair):
    jm, tm = pair
    x, _ = _held_out()
    rows = list(x[:5])
    want = jm.predict(rows, batch_size=2)
    got = tm.predict(rows, batch_size=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    # the argmax over the last axis, at every position
    want_cls = [np.argmax(np.asarray(w), axis=-1) for w in want]
    got_cls = [np.argmax(g, axis=-1) for g in got]
    for g, w in zip(got_cls, want_cls):
        np.testing.assert_array_equal(g, w)


def test_predict_class_of_vector_outputs():
    """``predict_class`` on a model with one output vector a sample: the
    argmax class of each, equal to JAX's rule (argmax over the last
    axis)."""
    class Head(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(6, 5))

        def forward(self, x):
            return x @ self.w

    head = Head()
    rng = np.random.default_rng(2)
    rows = list(rng.standard_normal((7, 6)).astype(np.float32))
    with torch.no_grad():
        want = np.argmax(np.stack(rows) @ head.w.numpy(), axis=-1)
    assert head.predict_class(rows, batch_size=3) == [int(c) for c in want]


def test_predictor_pads_to_the_ladder(pair):
    _, tm = pair
    x, _ = _held_out()
    ladder = BucketLadder(8, min_size=2)
    rungs = list(ladder)
    model = copy.deepcopy(tm)
    pred = optim.Predictor(model, batch_size=3, ladder=ladder)
    out = pred.predict(list(x[:7]) + list(x[:3]))   # batches 3, 3, 3, 1
    assert len(out) == 10
    shapes = sorted(k[0][0] for k in optim.compiled_eval_step(
        model).stats()["keys"])
    assert shapes == [2, 4]                  # 3 -> 4, 1 -> 2
    assert list(ladder) == rungs
    big = optim.Predictor(model, batch_size=9, ladder=ladder)
    big.predict(list(x[:9]))                 # past the top rung: one added
    assert 9 in list(big.ladder) and 9 not in list(ladder)


def test_eval_step_cached_per_model_and_dtype(pair, caplog):
    _, tm = pair
    model = copy.deepcopy(tm)
    fp32 = optim.compiled_eval_step(model)
    assert optim.compiled_eval_step(model) is fp32
    bf16 = optim.compiled_eval_step(model, torch.bfloat16)
    assert bf16 is not fp32 and bf16.compute_dtype == torch.bfloat16
    # a copy of the model starts without the cache
    twin = copy.deepcopy(model)
    assert optim.compiled_eval_step(twin) is not fp32
    spec = np.zeros(SEQ, np.int32)
    assert fp32.precompile(spec, [1, 2, 4]) == 3
    assert fp32.precompile(spec, [1, 2, 4]) == 0
    assert fp32.executables() == 3
    # validation's steps serve a Predictor of the same model
    x, _ = _held_out()
    optim.Predictor(model, BATCH).predict(list(x[:8]))
    assert fp32.executables() == 3
    fp32.max_executables = 3
    with caplog.at_level(logging.WARNING, "bigdl_tpu_torch.optim"):
        fp32(torch.zeros(5, SEQ, dtype=torch.int32))
        fp32(torch.zeros(5, SEQ, dtype=torch.int32))
    assert len([r for r in caplog.records if "bound 3" in r.message]) == 1
    assert fp32.executables() == 4
