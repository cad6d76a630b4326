"""``PredictionService`` of the port (``bigdl_tpu_torch/optim/
predictor.py``) against JAX's (``bigdl_tpu/optim/predictor.py:189``) on
the CPU: the semaphore path over the compiled eval step, the permit
released on a failing payload, ``coalesce=True`` over the serving engine,
``predict_bytes``, ``precompile`` and the refusal of engine options
without coalescing.

Tolerances: against JAX 1e-5 (fp32, an MLP); within the port bitwise (a
request is the engine's ``predict_at`` at the rung it rode).
"""

import io
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.optim import PredictionService as JaxService
from bigdl_tpu.utils.random_generator import RNG as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.optim import PredictionService


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mlps(seed=0):
    JaxRNG.set_seed(seed)
    jm = (jnn.Sequential().add(jnn.Linear(16, 32)).add(jnn.ReLU())
          .add(jnn.Linear(32, 10)))
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.float32))
    tm = (nn.Sequential().add(nn.Linear(16, 32)).add(nn.ReLU())
          .add(nn.Linear(32, 10)))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm.eval()


def _xs(n=8, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 16)).astype(np.float32)


def _run_threads(fn, items, n_threads=8, timeout=60):
    """``fn(item)`` over ``items`` from ``n_threads`` threads; returns the
    results (or exceptions) in order, every thread joined."""
    out = [None] * len(items)

    def worker(k):
        for i in range(k, len(items), n_threads):
            try:
                out[i] = fn(items[i])
            except Exception as e:       # the caller inspects it
                out[i] = e

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)
    return out


def test_semaphore_path_matches_jax_and_the_engine_bitwise():
    jm, tm = _mlps()
    xs = _xs()
    jsvc = JaxService(jm, num_threads=4)
    want = [np.asarray(jsvc.predict(x)) for x in xs]
    with PredictionService(tm, num_threads=4) as svc:
        got = _run_threads(svc.predict, list(xs))
        assert svc.precompile() == 0
    with PredictionService(tm, coalesce=True, max_batch_size=4,
                           device="cpu") as svc2:
        at = [svc2.engine.predict_at(x, 1) for x in xs]
    for g, w, a in zip(got, want, at):
        assert g.shape == (10,)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g, a)     # one graph, one shape


def test_the_step_lock_under_many_threads():
    """More threads than cores on one shared step, the interpreter
    switching threads every microsecond: every output is its own input's
    (a lost lock would hand a thread another's static output)."""
    _jm, tm = _mlps(3)
    xs = _xs(64, seed=3)
    with PredictionService(tm, num_threads=16) as svc:
        want = [svc.predict(x) for x in xs]
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            got = _run_threads(svc.predict, list(xs), n_threads=16)
        finally:
            sys.setswitchinterval(old)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_failing_payload_releases_its_permit(package):
    """``num_threads`` failures in a row do not exhaust the semaphore:
    each raises to its caller and the next good request is served."""
    jm, tm = _mlps(1)
    svc = PredictionService(tm, num_threads=2) if package == "port" \
        else JaxService(jm, num_threads=2)
    bad = np.zeros((5,), np.float32)
    results = _run_threads(svc.predict, [bad] * 6, n_threads=3)
    assert all(isinstance(r, Exception) for r in results)
    assert svc._sem.acquire(timeout=5) and svc._sem.acquire(timeout=5)
    svc._sem.release()
    svc._sem.release()
    assert np.asarray(svc.predict(_xs(1)[0])).shape == (10,)


def test_coalesced_path_is_the_engine_at_each_rung():
    jm, tm = _mlps(2)
    xs = _xs(16, seed=2)
    ticks = []
    with PredictionService(tm, coalesce=True, max_batch_size=4,
                           max_wait_ms=20.0, device="cpu") as svc:
        assert svc.precompile(example_feature=xs[0]) == 3   # rungs 1, 2, 4
        svc.engine.set_shadow(
            lambda x, y, bucket, n, tick: ticks.append(bucket), 1.0)
        got = _run_threads(svc.predict, list(xs))
        execs = svc.engine._executables()
        rungs = set(ticks)
        ats = {b: [svc.engine.predict_at(x, b) for x in xs] for b in rungs}
        assert svc.engine._executables() == execs == 3
    for i, g in enumerate(got):
        assert any(np.array_equal(g, ats[b][i]) for b in rungs), i
    with JaxService(jm, coalesce=True, max_batch_size=4) as jsvc:
        want = [np.asarray(jsvc.predict(x)) for x in xs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_predict_bytes_round_trip_matches_jax():
    jm, tm = _mlps(4)
    x = _xs(1, seed=4)[0]
    buf = io.BytesIO()
    np.savez(buf, x=x)
    payload = buf.getvalue()
    with PredictionService(tm) as svc:
        out = np.load(io.BytesIO(svc.predict_bytes(payload)))
        assert out.files == ["out0"]
        got = out["out0"]
        with pytest.raises(Exception):
            svc.predict_bytes(b"not an npz")
        assert svc.predict(x).shape == (10,)       # the permit came back
    want = np.load(io.BytesIO(JaxService(jm).predict_bytes(payload)))["out0"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_engine_options_need_coalescing():
    jm, tm = _mlps()
    for cls, model in ((PredictionService, tm), (JaxService, jm)):
        with pytest.raises(TypeError, match="coalesce=True"):
            cls(model, max_executables=4)
