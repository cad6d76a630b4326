"""The port's replica worker (``bigdl_tpu_torch/serving/worker.py``)
against the JAX package's (``bigdl_tpu/serving/worker.py``) on the CPU,
over the binary wire across packages.

The model is the fleet drill's TransformerLM (vocab 48, d 32, 4 heads, 2
layers, seq 16; ``tools/serve_live.py``) from the JAX package's seed 0,
carried into the port through ``interop/jax_params.py``; features and
prompts are seeded numpy.

Tolerances: a prediction over the wire within 1e-5 (absolute, logits of
order 1) of the other package's ``ServingEngine.predict`` on the same
weights; greedy streams exact; probe digests of two port workers on the
same weights equal bit for bit; after ``stage_tree`` on the int8 weight
wire and ``commit``, predictions within 1e-5 of a JAX worker staged the
same way.  Error envelopes carry the same ``error_type`` names.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.serving import transport as jt
from bigdl_tpu.serving import worker as jw
from bigdl_tpu.utils.random_generator import RNG as JaxRNG
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.serving import ServingEngine
from bigdl_tpu_torch.serving import transport as tt
from bigdl_tpu_torch.serving import worker as tw

VOCAB, SEQ = 48, 16
TOL = 1e-5
HOST = "127.0.0.1"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lm():
    """JAX's drill LM (seed 0), its numpy parameters, a candidate (the
    weights times 1.01) and seeded token features."""
    JaxRNG.set_seed(0)
    jm = JaxLM(VOCAB, 32, 4, num_layers=2, max_len=SEQ)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32))
    params = _np(jm.parameters()[0])
    x = np.random.default_rng(0).integers(0, VOCAB, (8, SEQ)) \
        .astype(np.int32)
    cand = jax.tree.map(lambda a: a * np.float32(1.01), params)
    return jm, params, cand, x


def _port_engine(params):
    tm = TransformerLM(VOCAB, 32, 4, num_layers=2, max_len=SEQ,
                       device="cpu")
    load_jax_params(tm, params)
    return ServingEngine(tm, max_batch_size=4, max_wait_ms=1.0,
                         device="cpu")


def _jax_engine(jm):
    return JaxEngine(jm, max_batch_size=4, max_wait_ms=1.0)


class _Servers:
    """Worker servers of either package on 127.0.0.1:0, closed (with
    their engines) at the end of the test."""

    def __init__(self):
        self.items = []

    def port(self, params, **kw):
        eng = _port_engine(params)
        srv = tw.ReplicaServer(eng, port=0, **kw).start()
        self.items.append((srv, eng))
        return srv, eng

    def jax(self, jm, **kw):
        eng = _jax_engine(jm)
        srv = jw.ReplicaServer(eng, port=0, **kw).start()
        self.items.append((srv, eng))
        return srv, eng

    def close(self):
        for srv, eng in self.items:
            srv.close()
            eng.close()


@pytest.fixture
def servers():
    s = _Servers()
    yield s
    s.close()


def test_jax_client_predicts_on_a_port_worker(lm, servers):
    jm, params, _, x = lm
    srv, eng = servers.port(params, probe_features=x[:4], probe_bucket=4)
    jeng = _jax_engine(jm)
    try:
        for row in x[:3]:
            got = jw.call(HOST, srv.port, "predict", feature=row,
                          timeout=20.0, rpc_timeout=30.0)
            want = np.asarray(jeng.predict(row, timeout=20.0))
            assert isinstance(got, np.ndarray) and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
            # within the port, the wire answer is the engine's own
            np.testing.assert_array_equal(got, eng.predict_at(row, 1))
    finally:
        jeng.close()


def test_port_client_predicts_on_a_jax_worker(lm, servers):
    jm, params, _, x = lm
    srv, _ = servers.jax(jm)
    eng = _port_engine(params)
    try:
        got = tw.call(HOST, srv.port, "predict", feature=x[4],
                      timeout=20.0, rpc_timeout=30.0)
        np.testing.assert_allclose(got, eng.predict(x[4], timeout=20.0),
                                   rtol=0, atol=TOL)
    finally:
        eng.close()


def test_generate_streams_equal_jax(lm, servers):
    jm, params, _, x = lm
    srv, _ = servers.port(params)
    jeng = _jax_engine(jm)
    try:
        for n, row in ((5, x[0]), (3, x[1]), (8, x[2])):
            prompt = [int(t) for t in row[:n]]
            got = jw.call(HOST, srv.port, "generate", prompt=prompt,
                          max_new_tokens=6, timeout=30.0, rpc_timeout=40.0)
            want = jeng.generate(np.asarray(prompt, np.int32),
                                 max_new_tokens=6).result(60.0)
            assert got == [int(t) for t in want]
    finally:
        jeng.close()


def test_two_port_workers_share_a_probe_digest(lm, servers):
    jm, params, _, x = lm
    a, eng_a = servers.port(params, probe_features=x[:4], probe_bucket=4)
    b, _ = servers.port(params, probe_features=x[:4], probe_bucket=4)
    da = jw.call(HOST, a.port, "probe")
    assert da == tw.call(HOST, b.port, "probe")
    assert da == tw.probe_digest(eng_a, x[:4], 4)
    # another version serves another digest
    other = servers.port(jax.tree.map(lambda v: v * np.float32(0.5),
                                      params),
                         probe_features=x[:4], probe_bucket=4)[0]
    assert tw.call(HOST, other.port, "probe") != da


def test_int8_stage_tree_commit_matches_jax(lm, servers):
    """The candidate crosses as blockwise int8 (the same bytes from
    either package's quantizer), is gated, committed, and served: the
    port worker's predictions stay within 1e-5 of a JAX worker's staged
    the same way, and ``release`` / a rollback by ``capture`` hold."""
    jm, params, cand, x = lm
    psrv, peng = servers.port(params, probe_features=x[:4],
                              probe_bucket=4)
    jsrv, _ = servers.jax(jm, probe_features=x[:4], probe_bucket=4)
    before = tw.call(HOST, psrv.port, "predict", feature=x[0],
                     timeout=20.0)
    live = tw.call(HOST, psrv.port, "capture")
    for srv, mod, wire in ((psrv, tw, tt), (jsrv, jw, jt)):
        q = wire.quantize_tree_for_wire(cand)
        tok = mod.call(HOST, srv.port, "stage_tree", params=q,
                       weight_wire="int8",
                       wire_bytes=wire.tree_wire_bytes(q), rpc_timeout=60.0)
        ok, reason = mod.call(HOST, srv.port, "gate", token=tok)
        assert ok, reason
        mod.call(HOST, srv.port, "commit", token=tok, version=2)
    for row in x[:3]:
        got = tw.call(HOST, psrv.port, "predict", feature=row, timeout=20.0)
        want = jw.call(HOST, jsrv.port, "predict", feature=row,
                       timeout=20.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert not np.array_equal(
        before, tw.call(HOST, psrv.port, "predict", feature=x[0],
                        timeout=20.0))
    h = tw.call(HOST, psrv.port, "health")
    assert h["version"] == {"version": 2, "digest": None}
    tw.call(HOST, psrv.port, "commit", token=live, version=1)
    np.testing.assert_array_equal(
        before, tw.call(HOST, psrv.port, "predict", feature=x[0],
                        timeout=20.0))


def _error_types(port, mod):
    out = []
    for op, kw in (("bogus", {}), ("commit", {"token": "nope"}),
                   ("probe", {}), ("gate", {"token": "h999"})):
        with pytest.raises(mod.ReplicaCallError) as e:
            mod.call(HOST, port, op, **kw)
        out.append(e.value.error_type)
    return out


def test_errors_cross_the_wire_typed(lm, servers):
    jm, params, _, x = lm
    psrv, _ = servers.port(params)
    jsrv, _ = servers.jax(jm)
    want = _error_types(jsrv.port, jw)
    assert want == ["ValueError", "KeyError", "ValueError", "KeyError"]
    assert _error_types(psrv.port, tw) == want
    # a staged tree from another layout is refused as JAX's worker
    # refuses it: resharding snapshots cross as a path (the stage op)
    errors = []
    for mod, srv in ((tw, psrv), (jw, jsrv)):
        with pytest.raises(mod.ReplicaCallError,
                           match="resharding snapshots cross as a PATH") \
                as e:
            mod.call(HOST, srv.port, "stage_tree", params=params,
                     src_layout={"kind": "tp"})
        errors.append(e.value.error_type)
    assert errors == ["ValueError", "ValueError"]


def test_health_is_plain_python(lm, servers):
    """``health`` answers plain Python (no tensor, no numpy): JAX's client
    decodes it with no pickle fallback and no tensor frame."""
    jm, params, _, x = lm
    srv, _ = servers.port(params)
    tw.call(HOST, srv.port, "predict", feature=x[0], timeout=20.0)
    tw.call(HOST, srv.port, "generate", prompt=[1, 2, 3], max_new_tokens=2,
            timeout=20.0)
    cli = jt.WireClient(HOST, srv.port)
    try:
        h, _, nbytes = cli.request_ex("health")
        assert cli.pickle_fallbacks == 0
    finally:
        cli.close()
    assert h["status"] == "ok" and h["draining"] is False
    assert h["stats"]["served"] >= 1 and "generate" in h["stats"]

    def plain(v):
        if isinstance(v, dict):
            return all(isinstance(k, str) and plain(w) for k, w in v.items())
        if isinstance(v, (list, tuple)):
            return all(plain(w) for w in v)
        return v is None or isinstance(v, (bool, int, float, str))

    assert plain(h), h
    # drain and undrain over the wire
    assert tw.call(HOST, srv.port, "drain", timeout=5.0) is True
    assert tw.call(HOST, srv.port, "health")["status"] == "draining"
    tw.call(HOST, srv.port, "undrain")
    assert tw.call(HOST, srv.port, "health")["status"] == "ok"


def test_handle_store_is_bounded(lm, servers):
    jm, params, _, x = lm
    srv, eng = servers.port(params, max_handles=2)
    toks = [tw.call(HOST, srv.port, "capture") for _ in range(4)]
    assert len(srv._handles) == 2 and set(srv._handles) == set(toks[2:])
    with pytest.raises(tt.ReplicaCallError, match="token") as e:
        tw.call(HOST, srv.port, "commit", token=toks[0])
    assert e.value.error_type == "KeyError"
    tw.call(HOST, srv.port, "commit", token=toks[-1], version=3)
    tw.call(HOST, srv.port, "release", token=toks[-1])
    assert list(srv._handles) == [toks[2]]


def test_pickle_wire_predicts_too(lm, servers):
    """``transport="pickle"``: the one-shot pickle wire answers what the
    binary wire answers."""
    jm, params, _, x = lm
    eng = _port_engine(params)
    srv = tw.ReplicaServer(eng, port=0, transport="pickle").start()
    servers.items.append((srv, eng))
    got = tw.call(HOST, srv.port, "predict", transport="pickle",
                  feature=x[1], timeout=20.0)
    np.testing.assert_array_equal(got, eng.predict_at(x[1], 1))
