"""The port's serving engine against the JAX package's on the CPU: the
length ladder, ``precompile``'s counts and bound, ``predict_at``,
``predict_many`` and the refusals (``bigdl_tpu_torch/serving/engine.py``
and ``buckets.py`` vs ``bigdl_tpu/serving/engine.py`` :336-904 and
``buckets.py`` :137-198).

Tolerances: the bucket helpers and the shape counts are exact; within
the port a request is bitwise the same request in a tick of its rung
(fp32 eval rows are independent); against JAX, logits within 1e-4 (fp32,
sums in another order), 1e-5 for a Linear.
"""

import logging
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.minibatch import PaddingParam as JaxPadding
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving.buckets import BucketLadder as JaxLadder
from bigdl_tpu.serving.buckets import pad_length_axis as jax_pad_length
from bigdl_tpu.serving.buckets import slice_batch_axis as jax_slice
from bigdl_tpu.serving.buckets import walk_length_leaves as jax_walk
from bigdl_tpu.utils.random_generator import RNG as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.minibatch import PaddingParam, Sample
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.serving import BucketLadder, ServingEngine
from bigdl_tpu_torch.serving.buckets import (pad_length_axis,
                                             slice_batch_axis,
                                             walk_length_leaves)
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 128, 32, 2, 2, 64


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _linears(seed=23):
    """A JAX ``Linear(16, 4)`` over (B, T, 16) and the port's with the
    same weights."""
    JaxRNG.set_seed(seed)
    jm = jnn.Linear(16, 4)
    jm.build(jax.ShapeDtypeStruct((2, 8, 16), jnp.float32))
    tm = nn.Linear(16, 4)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


@pytest.fixture(scope="module")
def lms():
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(5))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _port(model, **kw):
    return ServingEngine(model, device="cpu", **kw)


# --------------------------------------------------------------------------- #
# The bucket helpers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("select", [None, "second", "wide"])
def test_pad_length_axis_matches_jax(select):
    rng = np.random.default_rng(0)
    tree = (rng.standard_normal((3, 5, 4)).astype(np.float32),
            rng.integers(0, 9, (3, 7)).astype(np.int32),
            rng.standard_normal((3,)).astype(np.float32),
            [rng.standard_normal((3, 11, 2)).astype(np.float32)])
    sel = {None: None, "second": lambda i, a: i == 1,
           "wide": lambda i, a: a.shape[-1] != 4}[select]
    lad, jlad = BucketLadder(8), JaxLadder(8)
    got = pad_length_axis(tree, lad, sel)
    want = jax_pad_length(tree, jlad, sel)
    flat_got = jax.tree.leaves(got)
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # an over-max length (11) grows the ladder by that rung, in both
    assert lad.rungs == jlad.rungs
    assert type(got) is tuple and type(got[3]) is list


def test_walk_length_leaves_matches_jax_at_both_ranks():
    spec = (np.zeros((6, 4), np.float32), np.zeros((6,), np.int32),
            np.zeros((), np.float32))
    seen, jseen = [], []

    def sel(out):
        def f(i, a):
            out.append((i, a.shape))
            return i != 1
        return f

    for batched in (False, True):
        x = spec if not batched else tuple(a[None] for a in spec)
        got = walk_length_leaves(x, sel(seen),
                                 lambda a: np.ones((9,) + a.shape[1:],
                                                   a.dtype), batched)
        want = jax_walk(x, sel(jseen),
                        lambda a: np.ones((9,) + a.shape[1:], a.dtype),
                        batched)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert seen == jseen


def test_slice_batch_axis_matches_jax():
    tree = (np.arange(12).reshape(6, 2), [np.arange(6)])
    got, want = slice_batch_axis(tree, 4), jax_slice(tree, 4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1][0])


# --------------------------------------------------------------------------- #
# precompile
# --------------------------------------------------------------------------- #


def test_length_ladder_precompile_warms_all_rungs():
    """JAX's ``test_length_ladder_precompile_warms_all_rungs``: every
    (batch rung x length rung) is built by ``precompile``, so mixed
    lengths build nothing after it; both packages count the same."""
    jm, tm = _linears()
    rng = np.random.default_rng(1)
    example = rng.standard_normal((3, 16)).astype(np.float32)
    lengths = (3, 5, 2, 7, 8, 1)
    feats = [rng.standard_normal((n, 16)).astype(np.float32)
             for n in lengths]
    with JaxEngine(jm, max_batch_size=4, max_wait_ms=200.0,
                   length_ladder=JaxLadder(8)) as jeng:
        jbuilt = jeng.precompile(example_feature=example)
        jexec = jeng._executables()
        want = [jeng.predict_many([f], timeout=60)[0] for f in feats]
        assert jeng._executables() == jexec
    with _port(tm, max_batch_size=4, max_wait_ms=200.0,
               length_ladder=BucketLadder(8)) as eng:
        built = eng.precompile(example_feature=example)
        execs = eng._executables()
        got = [eng.predict_many([f], timeout=60)[0] for f in feats]
        assert eng._executables() == execs
        assert eng.executables() == execs       # no generation here
    assert built == jbuilt == 3 * 4            # batch rungs x length rungs
    rungs = {1: 1, 2: 2, 3: 4, 5: 8, 7: 8, 8: 8}
    for n, g, w in zip(lengths, got, want):
        assert g.shape == w.shape == (rungs[n], 4)  # the rung's length
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_executable_bound_fits_warmed_ladder(caplog):
    """JAX's ``test_executable_bound_fits_warmed_ladder``: a closed shape
    set past the default bound does not log the shape-leak warning; an
    explicit ``max_executables`` is the caller's."""
    _jm, tm = _linears(27)
    with _port(tm, max_batch_size=64, max_wait_ms=50.0,
               length_ladder=BucketLadder(256)) as eng:
        combos = len(eng.ladder) * len(eng.length_ladder)
        assert combos > 32
        assert eng._backend.step.max_executables >= combos
        with caplog.at_level("WARNING", logger="bigdl_tpu_torch.optim"):
            built = eng.precompile(
                example_feature=np.zeros((3, 16), np.float32))
        assert built == combos
        assert not [r for r in caplog.records if "leaking" in r.message]
    with _port(tm, max_batch_size=64, max_wait_ms=50.0,
               length_ladder=BucketLadder(256), max_executables=5) as eng2:
        assert eng2._backend.step.max_executables == 5


def test_precompile_takes_buckets_first():
    """JAX's signature, ``precompile(buckets=None, example_feature=
    None)``: a positional bucket list warms exactly those rungs; without
    a feature (the port's models record no input spec) it raises before
    building, and ``precompile()`` alone builds nothing for predict."""
    _jm, tm = _linears(3)
    x = np.random.default_rng(2).standard_normal((16,)).astype(np.float32)
    with _port(tm, max_batch_size=8) as eng:
        assert eng.precompile() == 0
        with pytest.raises(ValueError, match="example_feature="):
            eng.precompile([1, 2, 4])
        assert eng._executables() == 0
        assert eng.precompile([1, 2, 4], x) == 3
        keys = eng._backend.step.stats()["keys"]
        assert sorted(k[0][0] for k in keys) == [1, 2, 4]
        # the recorded feature serves later calls
        assert eng.precompile([8]) == 1
        assert eng.precompile() == 0              # all four rungs warm
        with pytest.raises(ValueError, match="buckets"):
            eng.precompile([0], x)
        # traffic at a warmed rung builds nothing
        eng.predict(x, timeout=60)
        assert eng._executables() == 4


def test_precompile_counts_generation_too(lms):
    _jm, tm = lms
    tokens = np.arange(1, 9, dtype=np.int32)
    with _port(tm, max_batch_size=2, decode_slots=2, decode_max_len=32,
               kv_block_size=4, length_ladder=BucketLadder(16, 8)) as eng:
        built = eng.precompile(example_feature=tokens)
        gen = eng.stats()["generate"]["graphs"]["captured"]
        assert gen > 0
        assert built == gen + 2 * 2               # batch x length rungs
        assert eng.executables() == built


# --------------------------------------------------------------------------- #
# predict_at, predict_many, features
# --------------------------------------------------------------------------- #


def test_predict_at_is_bitwise_a_coalesced_tick_and_matches_jax(lms):
    jm, tm = lms
    rng = np.random.default_rng(4)
    # one length rung (16): a tick stacks its requests to the longest,
    # then to that rung, which predict_at reaches from each alone
    xs = [rng.integers(1, VOCAB, n).astype(np.int32) for n in (9, 13, 16)]
    kw = dict(max_batch_size=4, max_wait_ms=300.0, decode_slots=0)
    with _port(tm, length_ladder=BucketLadder(32, 8), **kw) as eng:
        eng.precompile(example_feature=xs[0])
        execs = eng._executables()
        futs = [eng.submit(x) for x in xs]
        ys = [f.result(60) for f in futs]
        buckets = {f.bucket for f in futs}
        ats = [eng.predict_at(x, f.bucket) for x, f in zip(xs, futs)]
        assert eng._executables() == execs
    assert buckets == {4}                           # one tick held all
    for y, at in zip(ys, ats):
        assert y.shape == (16, VOCAB)               # the length rung
        np.testing.assert_array_equal(y, at)
    with JaxEngine(jm, length_ladder=JaxLadder(32, 8), **kw) as jeng:
        want = [np.asarray(jeng.predict_at(x, 4)) for x in xs]
    for y, w in zip(ys, want):
        np.testing.assert_allclose(y, w, atol=1e-4, rtol=1e-4)


def _hold_dispatcher(eng, gate):
    """A shadow observer that blocks the dispatcher after its first tick
    until ``gate`` is set."""
    def observer(*_):
        gate.wait(30)
    eng.set_shadow(observer, 1.0)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_predict_many_shares_one_timeout_budget(package):
    """``timeout`` bounds the whole burst: with the dispatcher held, a
    burst of five times out once, near its budget, and cancels every
    request it queued (the queue is empty after)."""
    jm, tm = _linears(8)
    x = np.zeros((4, 16), np.float32)
    eng = _port(tm, max_batch_size=1, max_wait_ms=1.0) if package == "port" \
        else JaxEngine(jm, max_batch_size=1, max_wait_ms=1.0)
    gate = threading.Event()
    try:
        _hold_dispatcher(eng, gate)
        eng.predict(x, timeout=60)               # its tick then blocks
        t0 = time.perf_counter()
        with pytest.raises(FutureTimeoutError):
            eng.predict_many([x] * 5, timeout=0.4)
        waited = time.perf_counter() - t0
        assert 0.3 < waited < 3.0
        assert eng.stats()["pending"] == 0
    finally:
        gate.set()
        eng.close()


def test_feature_padding_and_samples_match_jax():
    """``feature_padding`` stacks requests of different lengths (a
    ``Sample`` or a bare array), then the length ladder rounds the
    stack."""
    jm, tm = _linears(12)
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((n, 16)).astype(np.float32)
             for n in (2, 6, 3)]
    kw = dict(max_batch_size=4, max_wait_ms=300.0)
    with JaxEngine(jm, feature_padding=JaxPadding(0.0),
                   length_ladder=JaxLadder(8), **kw) as jeng:
        want = jeng.predict_many(feats, timeout=60)
    with _port(tm, feature_padding=PaddingParam(0.0),
               length_ladder=BucketLadder(8), **kw) as eng:
        got = eng.predict_many([Sample(feats[0])] + feats[1:], timeout=60)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (8, 4)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_tick_telemetry_events_carry_jax_fields():
    """The ``kind: "inference"`` event and the serving header through a
    duck-typed telemetry, field for field against JAX's."""
    class Recorder:
        def __init__(self):
            self.events, self.info = [], []

        def record(self, kind, **fields):
            self.events.append((kind, fields))
            return fields

        def set_serving_info(self, info):
            self.info.append(info)

        def span(self, name, **kw):           # JAX's span seam
            import contextlib
            return contextlib.nullcontext()

    jm, tm = _linears(14)
    x = np.zeros((4, 16), np.float32)
    recs = {}
    for package in ("jax", "port"):
        rec = recs[package] = Recorder()
        eng = JaxEngine(jm, max_batch_size=2, telemetry=rec) \
            if package == "jax" else _port(tm, max_batch_size=2,
                                           telemetry=rec)
        with eng:
            eng.predict(x, timeout=60)
    for package, rec in recs.items():
        assert [k for k, _ in rec.events] == ["inference"], package
    assert set(recs["port"].events[0][1]) == set(recs["jax"].events[0][1])
    assert recs["port"].info == recs["jax"].info


def test_draining_and_undrain_match_jax():
    jm, tm = _linears(15)
    x = np.zeros((4, 16), np.float32)
    for eng in (JaxEngine(jm, max_batch_size=2), _port(tm, max_batch_size=2)):
        with eng:
            assert not eng.draining
            assert eng.drain(timeout=30) and eng.draining
            with pytest.raises(RuntimeError, match="draining"):
                eng.submit(x)
            assert eng.undrain() is eng and not eng.draining
            assert eng.predict(x, timeout=60).shape == (4, 4)


# --------------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------------- #


def test_refusals_name_their_roadmap_items(tmp_path, lms):
    _jm, tm = _linears(16)
    x = np.zeros((4, 16), np.float32)

    class Mesh:
        shape = {"data": 2}

    with pytest.raises(UnsupportedFeatureError, match="A6"):
        _port(tm, mesh=Mesh())
    with _port(tm, max_batch_size=2) as eng:
        with pytest.raises(UnsupportedFeatureError, match="A8"):
            eng.submit(x, trace=object())
        with pytest.raises(UnsupportedFeatureError, match="A8"):
            eng.predict(x, trace=object())
        # src_layout= is ported (no refusal): a tree saved under another
        # layout is redistributed onto the model's first -- a tp tree
        # is the model's own -- and a layout without an incoming tree is
        # JAX's ValueError
        params = tm.parameters_tree()
        tp = {"kind": "tp", "mesh_axes": {"model": 2}}
        handle = eng.stage_weights(params, src_layout=tp)
        assert set(handle["params"]) == set(params)
        with pytest.raises(ValueError, match="pass params="):
            eng.refresh_params(src_layout={"kind": "dp"})
        (tmp_path / "snap_3").mkdir()
        with pytest.raises(UnsupportedFeatureError, match="A4"):
            eng.refresh_from_snapshot(str(tmp_path / "snap_3"))
        with pytest.raises(UnsupportedFeatureError, match="A4"):
            eng.refresh_from_snapshot(str(tmp_path))
    _jm, lm = lms
    with _port(lm, decode_slots=1, decode_max_len=16) as eng:
        with pytest.raises(UnsupportedFeatureError, match="A8"):
            eng.generate([1, 2, 3], trace=object())
    # a one-device mesh is the local layout, as in JAX
    with _port(tm, mesh=type("M", (), {"shape": {"data": 1}})()) as eng:
        assert eng._backend.kind == "local"
