"""Weight staging, canary, shadow and refresh of the port's serving engine
against the JAX package's on the CPU (``bigdl_tpu_torch/serving/
engine.py`` vs ``bigdl_tpu/serving/engine.py`` :1189-1705; JAX's own cases
are ``tests/test_deploy.py::TestEngineStaging``).

Models: an MLP (fp32, and bf16 ``compute_dtype``), an MLP with a
BatchNorm (model state), ``ResNetCifar(8)`` served as its int8 twin, and a
small TransformerLM for the prefix cache.  Both packages hold the same
weights (``interop/jax_params.py``); inputs are seeded numpy.

Tolerances: within the port, stage / commit / capture / rollback are
bitwise (the committed weights are the staged ones, copied in place);
against JAX, fp32 outputs within 1e-5, the int8 twin's within 1e-4 of the
largest output (an activation's int8 code may flip between the packages),
greedy streams exact.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
from bigdl_tpu.dataset import array_dataset as jarray_dataset
from bigdl_tpu.models import resnet as jres
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu.utils.random_generator import RNG as JaxRNG
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_params, load_jax_state
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.optim.train_step import compute_copy, make_eval_step
from bigdl_tpu_torch.serving import ServingEngine

MODEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mlps(seed=0, bn=False):
    """JAX's ``tests/test_deploy.py`` MLP (``bn``: Linear, BatchNorm,
    Linear) and the port's on its weights and state."""
    JaxRNG.set_seed(seed)
    if bn:
        jm = (jnn.Sequential().add(jnn.Linear(8, 16))
              .add(jnn.BatchNormalization(16)).add(jnn.Linear(16, 4)))
        tm = (nn.Sequential().add(nn.Linear(8, 16))
              .add(nn.BatchNormalization(16)).add(nn.Linear(16, 4)))
        jm.build(jax.ShapeDtypeStruct((2, 8), jnp.float32))
    else:
        jm = (jnn.Sequential().add(jnn.Linear(16, 32)).add(jnn.ReLU())
              .add(jnn.Linear(32, 10)))
        tm = (nn.Sequential().add(nn.Linear(16, 32)).add(nn.ReLU())
              .add(nn.Linear(32, 10)))
        jm.build(jax.ShapeDtypeStruct((2, 16), jnp.float32))
    load_jax_params(tm, _np(jm.parameters()[0]))
    load_jax_state(tm, _np(jm.state()))
    return jm, tm.eval()


def _xs(n=4, width=16, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, width)).astype(np.float32)


def _resnets(seed=0):
    """``ResNetCifar(8)`` in both packages with non-trivial running
    statistics (one training apply in JAX), in eval mode."""
    rng = np.random.default_rng(seed)
    x_train = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jm = jres.ResNetCifar(8)
    jm.build(jax.ShapeDtypeStruct((4, 32, 32, 3), jnp.float32),
             rng=jax.random.PRNGKey(seed))
    _, js = jm.apply(jm.parameters()[0], jm.state(), jnp.asarray(x_train),
                     training=True)
    jm._state = js
    tm = tmodels.ResNetCifar(8, device="cpu")
    load_jax_params(tm, _np(jm.parameters()[0]))
    load_jax_state(tm, _np(js))
    return jm.evaluate(), tm.eval()


def _images(n, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _port(model, **kw):
    return ServingEngine(model, device="cpu", **kw)


def _held(got, want, tol=MODEL_TOL):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"{err:.2e} of the largest output apart"


class Recorder:
    """A duck-typed telemetry: ``record`` and ``set_serving_info``."""

    def __init__(self):
        self.events, self.info = [], []

    def record(self, kind, **fields):
        self.events.append(dict(fields, kind=kind))
        return fields

    def set_serving_info(self, info):
        self.info.append(info)

    def span(self, name, **kw):            # JAX's span seam
        import contextlib
        return contextlib.nullcontext()

    def of(self, kind):
        return [e for e in self.events if e["kind"] == kind]


# --------------------------------------------------------------------------- #
# Stage, commit, capture, rollback
# --------------------------------------------------------------------------- #


def test_stage_commit_capture_rollback_bit_identical():
    """JAX's ``test_stage_commit_capture_rollback_bit_identical``, both
    packages: staging commits nothing; the staged eval is the candidate's;
    a commit serves it; committing the captured handle restores the old
    outputs bit for bit."""
    jm, tm = _mlps()
    xs = _xs()
    cand = jax.tree.map(lambda a: a * 0.5, _np(jm.parameters()[0]))
    batch = np.repeat(xs[:1], 4, 0)
    outs = {}
    for package in ("jax", "port"):
        eng = JaxEngine(jm, max_batch_size=4, max_wait_ms=1.0) \
            if package == "jax" else _port(tm, max_batch_size=4,
                                           max_wait_ms=1.0)
        with eng:
            eng.precompile(example_feature=xs[0])
            y0 = np.asarray(eng.predict_at(xs[0], 4))
            live = eng.capture_staged()
            h = eng.stage_weights(cand)
            np.testing.assert_array_equal(
                y0, np.asarray(eng.predict_at(xs[0], 4)))
            yc = np.asarray(eng.eval_staged(h, batch))
            eng.commit_staged(h, version=2)
            y1 = np.asarray(eng.predict_at(xs[0], 4))
            eng.commit_staged(live, version=1)
            y2 = np.asarray(eng.predict_at(xs[0], 4))
            if package == "port":
                # bitwise within the port, every step
                np.testing.assert_array_equal(y1, yc[0])
            else:
                np.testing.assert_allclose(y1, yc[0], rtol=1e-6)
            np.testing.assert_array_equal(y0, y2)
            outs[package] = (y0, yc, y1)
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_staging_captures_nothing_on_the_live_step_and_keeps_addresses():
    """The candidate has its own step, built at the live step's shapes
    (zero builds on the live step); a commit writes into the tensors the
    live step reads, at their addresses."""
    _jm, tm = _mlps(1)
    xs = _xs()
    with _port(tm, max_batch_size=4) as eng:
        eng.precompile(example_feature=xs[0])
        live_execs = eng._executables()
        ptrs = [p.data_ptr() for p in tm.parameters()]
        h = eng.stage_weights({k: {n: v * 0.9 for n, v in d.items()}
                               if isinstance(d, dict) else d
                               for k, d in tm.parameters_tree().items()})
        step = h["staged"].step
        assert step is not eng._backend.step
        assert step.executables() == live_execs      # warmed at staging
        eng.eval_staged(h, np.repeat(xs[:1], 2, 0))
        assert step.executables() == live_execs      # no new build
        eng.commit_staged(h)
        assert [p.data_ptr() for p in tm.parameters()] == ptrs
        assert eng._executables() == live_execs


def test_a_rollback_handle_builds_its_step_only_when_evaluated():
    """``capture_staged`` builds no graphs (a commit only copies
    tensors); its step is built when the handle is first evaluated, and
    its bytes then include that step's."""
    _jm, tm = _mlps(1)
    xs = _xs()
    with _port(tm, max_batch_size=4) as eng:
        eng.precompile(example_feature=xs[0])
        y0 = eng.predict_at(xs[0], 2)
        back = eng.capture_staged()
        staged = back["staged"]
        assert staged._step is None
        cold = staged.nbytes()
        eng.commit_staged(back)
        assert staged._step is None
        np.testing.assert_array_equal(y0, eng.predict_at(xs[0], 2))
        np.testing.assert_array_equal(
            y0, eng.eval_staged(back, np.repeat(xs[:1], 2, 0))[0])
        assert staged.step.executables() == 1
        assert staged.nbytes() >= cold


def test_int8_twin_stage_commit_rollback_and_jax():
    """A quantized engine on ResNetCifar(8): the candidate is quantized
    once at staging; after a commit the live twin serves bitwise the
    candidate twin's eager eval; the captured handle rolls back bitwise;
    the outputs hold JAX's engine on the same weights."""
    jm, tm = _resnets(0)
    jc, tc = _resnets(1)
    xs = _images(6)
    cand = _np(jc.parameters()[0])
    cand_state = _np(jc.state())
    with JaxEngine(jm, max_batch_size=4, quantize=True) as jeng:
        jy0 = np.asarray(jeng.predict_at(xs[0], 4))
        jh = jeng.stage_weights(cand, mstate=cand_state)
        jeng.commit_staged(jh)
        jy1 = np.asarray(jeng.predict_at(xs[0], 4))
    with _port(tm, max_batch_size=4, quantize=True) as eng:
        eng.precompile(example_feature=xs[0])
        y0 = eng.predict_at(xs[0], 4)
        live = eng.capture_staged()
        assert live["quantized"] and live["qparams"] is not None
        h = eng.stage_weights(cand, mstate=cand_state)
        assert tq.quantized_leaf_count(h["qparams"]) > 0
        np.testing.assert_array_equal(y0, eng.predict_at(xs[0], 4))
        eng.commit_staged(h, version=2)
        y1 = eng.predict_at(xs[0], 4)
        twin = tq.quantize_model(tc)[0]
        batch = torch.from_numpy(np.concatenate([xs[:1], np.zeros(
            (3, 32, 32, 3), np.float32)]))
        with torch.no_grad():
            want = twin(batch)[0].numpy()
        np.testing.assert_array_equal(y1, want)
        eng.commit_staged(live, version=1)
        np.testing.assert_array_equal(y0, eng.predict_at(xs[0], 4))
    _held(y0, jy0)
    _held(y1, jy1)


def test_commit_repacks_k6_and_recasts_the_compute_copy_in_place():
    """The caches a graph reads outside the parameters: K6's packed weight
    (made here by ``packed_weight``, as the card's forward makes it) is
    re-packed into the same buffer from the committed payload, and a bf16
    engine's compute copy is re-cast into its own tensors."""
    _jm, tm = _resnets(2)
    _jc, tc = _resnets(3)
    with _port(tm, max_batch_size=2, quantize=True) as eng:
        layers = [m for m in eng._qmodel.modules()
                  if "weight_q" in m._parameters and m.weight_q.dim() == 4
                  and tq.packed_weight(m) is not None]
        assert layers
        bufs = [m.__dict__["_k6_packed"].packed for m in layers]
        ptrs = [b.data_ptr() for b in bufs]
        eng.commit_staged(eng.stage_weights(tc.parameters_tree(),
                                            tc.state_tree()))
        from bigdl_tpu_torch.ops.int8_conv import pack_weight
        for m, b, p in zip(layers, bufs, ptrs):
            cache = m.__dict__["_k6_packed"]
            assert cache.packed is b and b.data_ptr() == p
            torch.testing.assert_close(
                b, pack_weight(m.weight_q, m.n_group), rtol=0, atol=0)
            # the eager path finds its key current: it packs nothing new
            assert tq.packed_weight(m) is b
    _jm, fm = _mlps(4)
    _jm2, fc = _mlps(5)
    xs = _xs()
    with _port(fm, max_batch_size=4, compute_dtype=torch.bfloat16) as eng:
        copy_params = list(eng._backend.eval_model.parameters())
        ptrs = [p.data_ptr() for p in copy_params]
        eng.commit_staged(eng.stage_weights(fc.parameters_tree()))
        assert [p.data_ptr() for p in copy_params] == ptrs
        got = eng.predict_at(xs[0], 4)
        ref = compute_copy(fc, torch.bfloat16)
        batch = torch.from_numpy(np.concatenate(
            [xs[:1], np.zeros((3, 16), np.float32)]))
        want = make_eval_step(ref, torch.bfloat16)(batch)[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_stage_weights_rejects_before_staging():
    """JAX's case: a half-written tree raises before anything is staged,
    naming the leaf; the ledger retains no staged weight set."""
    jm, tm = _mlps()
    bad = dict(_np(jm.parameters()[0]))
    bad["0"] = {"weight": np.zeros((3, 3), np.float32),
                "bias": bad["0"]["bias"]}
    with JaxEngine(jm, max_batch_size=4) as jeng:
        with pytest.raises(ValueError, match="stage_weights rejected"):
            jeng.stage_weights(bad)
    with _port(tm, max_batch_size=4) as eng:
        with pytest.raises(ValueError,
                           match=r"stage_weights rejected.*0\.weight"):
            eng.stage_weights(bad)
        missing = {k: v for k, v in bad.items() if k != "2"}
        with pytest.raises(ValueError, match="missing"):
            eng.stage_weights(missing)
        assert eng.memory_ledger().snapshot()["subsystems"]["staged"][
            "handles"] == 0


def test_commit_refuses_cross_precision_handle():
    _jm, tm = _mlps()
    with _port(tm, max_batch_size=4) as eng:
        h = eng.capture_staged()
        h = type(h)({**h, "quantized": True})
        with pytest.raises(ValueError, match="precision"):
            eng.commit_staged(h)


def test_stateful_rollback_restores_model_state():
    """JAX's case: the captured handle carries the state too, so a
    rollback after a candidate with shifted running statistics restores
    the outputs bit for bit."""
    jm, tm = _mlps(2, bn=True)
    xs = _xs(width=8)
    cand_state = jax.tree.map(lambda a: np.asarray(a) + 1.0, jm.state())
    for eng in (JaxEngine(jm, max_batch_size=4, max_wait_ms=1.0),
                _port(tm, max_batch_size=4, max_wait_ms=1.0)):
        with eng:
            y0 = np.asarray(eng.predict_at(xs[0], 4))
            live = eng.capture_staged()
            assert live["mstate"] is not None
            h = eng.stage_weights(_np(jm.parameters()[0]),
                                  mstate=cand_state)
            eng.commit_staged(h, version=2)
            assert not np.array_equal(y0, np.asarray(
                eng.predict_at(xs[0], 4)))
            eng.commit_staged(live, version=1)
            np.testing.assert_array_equal(
                y0, np.asarray(eng.predict_at(xs[0], 4)))


# --------------------------------------------------------------------------- #
# Canary and shadow
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fraction,want", [(0.5, 4), (0.25, 2)])
def test_canary_fraction_routes_and_stamps_ticks(fraction, want):
    """Error diffusion: ``fraction`` of 8 ticks ride the candidate, their
    events say so, and two weight sets really served -- as in JAX."""
    jm, tm = _mlps()
    xs = _xs()
    cand = jax.tree.map(lambda a: a * 0.5, _np(jm.parameters()[0]))
    for package in ("jax", "port"):
        rec = Recorder()
        eng = JaxEngine(jm, max_batch_size=1, max_wait_ms=0.5,
                        telemetry=rec) if package == "jax" else \
            _port(tm, max_batch_size=1, max_wait_ms=0.5, telemetry=rec)
        with eng:
            h = eng.stage_weights(cand)
            eng.set_canary(h, fraction, version=7)
            outs = [np.asarray(eng.predict(xs[0])) for _ in range(8)]
            stats = eng.canary_stats()
        ticks = rec.of("inference")
        canaried = [e for e in ticks if e.get("canary")]
        assert len(ticks) == 8 and len(canaried) == want, package
        assert all(e["canary_version"] == 7 for e in canaried)
        assert stats == {"ticks": want, "rows": want, "failures": 0}
        assert len({o.tobytes() for o in outs}) == 2


def test_canary_failures_count_only_when_the_eval_was_reached():
    _jm, tm = _mlps()
    xs = _xs()
    with _port(tm, max_batch_size=1, max_wait_ms=0.5) as eng:
        h = eng.stage_weights(tm.parameters_tree())
        eng.set_canary(h, 1.0)
        with pytest.raises(Exception):
            eng.predict(np.zeros((3,), np.float32), timeout=30)  # bad shape
        assert eng.canary_stats()["failures"] == 1      # reached the eval
        with pytest.raises(Exception):
            eng.predict((xs[0], np.zeros((2, 2))), timeout=30)
        before = eng.canary_stats()["failures"]

        class Broken:
            def host(self, x):
                raise RuntimeError("candidate eval fails")

        h["staged"]._step = Broken()
        with pytest.raises(RuntimeError, match="candidate"):
            eng.predict(xs[0], timeout=30)
        assert eng.canary_stats()["failures"] == before + 1
        with pytest.raises(ValueError, match="fraction"):
            eng.set_canary(h, 1.5)
        with pytest.raises(ValueError, match="fraction"):
            eng.set_shadow(lambda *a: None, 0.0)
        eng.set_canary(None)
        assert eng.predict(xs[0], timeout=30).shape == (10,)


def test_shadow_mirrors_after_results_and_swallows_errors():
    """JAX's case, both packages: the observer sees the padded batch
    after the result is delivered; its exception is swallowed."""
    jm, tm = _mlps()
    xs = _xs()
    for eng in (JaxEngine(jm, max_batch_size=4, max_wait_ms=0.5),
                _port(tm, max_batch_size=4, max_wait_ms=0.5)):
        seen = []
        with eng:
            fut_done = []

            def observer(x, y, bucket, n, tick):
                fut_done.append(fut.done())
                seen.append((np.asarray(x).shape, n, bucket))
                raise RuntimeError("observer bug")

            eng.set_shadow(observer, 1.0)
            fut = eng.submit(xs[0])
            assert fut.result(30) is not None
            eng.set_shadow(None)
            eng.predict(xs[1], timeout=30)
        assert len(seen) == 1 and fut_done == [True]
        shape, n, bucket = seen[0]
        assert n == 1 and shape[0] == bucket


# --------------------------------------------------------------------------- #
# Refresh
# --------------------------------------------------------------------------- #


def test_refresh_rejected_by_the_gate_and_by_a_half_written_tree():
    """An int8 engine with a gate: a truncated tree and a candidate the
    gate refuses both raise, with a rejected audit event, and the engine
    keeps serving its weights bit for bit -- JAX refuses the same two;
    a good refresh then serves the candidate."""
    jm, tm = _resnets(4)
    xs = _images(12, seed=5)
    # the twin of weights scaled by -3 keeps most top-1s but its logits
    # sit 1e5 from the fp32 model's: the RMSE bound refuses it
    gate = {"features": xs[:8], "min_top1_agreement": 0.75,
            "max_logit_rmse": 1.0}
    params = _np(jm.parameters()[0])
    truncated = {k: v for k, v in params.items() if k != list(params)[-1]}
    broken = jax.tree.map(lambda a: np.asarray(a) * -3.0, params)
    better = jax.tree.map(lambda a: np.asarray(a) * 1.001, params)
    from bigdl_tpu.optim.validation import AccuracyDeltaGate as JGate
    with JaxEngine(jm, max_batch_size=4, quantize=True,
                   accuracy_gate=JGate(**gate)) as jeng:
        with pytest.raises(ValueError, match="rejected"):
            jeng.refresh_params(truncated)
        with pytest.raises(ValueError, match="accuracy gate"):
            jeng.refresh_params(broken)
    rec = Recorder()
    with _port(tm, max_batch_size=4, quantize=True, accuracy_gate=gate,
               telemetry=rec) as eng:
        y0 = eng.predict_at(xs[8], 4)
        with pytest.raises(ValueError, match="keeps serving"):
            eng.refresh_params(truncated)
        np.testing.assert_array_equal(y0, eng.predict_at(xs[8], 4))
        with pytest.raises(ValueError, match="accuracy gate"):
            eng.refresh_params(broken)
        np.testing.assert_array_equal(y0, eng.predict_at(xs[8], 4))
        outcomes = [e["outcome"] for e in rec.of("param_refresh")]
        assert outcomes == ["rejected", "rejected"]
        assert "missing" in rec.of("param_refresh")[0]["reason"]
        assert "accuracy_gate" in rec.of("param_refresh")[1]
        eng.refresh_params(better)
        assert rec.of("param_refresh")[-1]["outcome"] == "ok"
        assert not np.array_equal(y0, eng.predict_at(xs[8], 4))
        ref = tmodels.ResNetCifar(8, device="cpu")
        load_jax_params(ref, better)
        ref.load_state_tree(tm.state_tree())
        twin = tq.quantize_model(ref.eval())[0]
        batch = torch.from_numpy(np.concatenate(
            [xs[8:9], np.zeros((3, 32, 32, 3), np.float32)]))
        with torch.no_grad():
            np.testing.assert_array_equal(eng.predict_at(xs[8], 4),
                                          twin(batch)[0].numpy())


def test_refresh_without_arguments_rederives_the_twin():
    """The no-argument spelling: the caller changed the fp32 model in
    place; the twin is re-quantized from it."""
    _jm, tm = _resnets(6)
    xs = _images(2, seed=9)
    with _port(tm, max_batch_size=2, quantize=True) as eng:
        y0 = eng.predict_at(xs[0], 2)
        with torch.no_grad():
            for p in tm.parameters():
                p.mul_(1.01)
        np.testing.assert_array_equal(y0, eng.predict_at(xs[0], 2))
        eng.refresh_params()
        twin = tq.quantize_model(tm)[0]
        batch = torch.from_numpy(np.concatenate(
            [xs[:1], np.zeros((1, 32, 32, 3), np.float32)]))
        with torch.no_grad():
            np.testing.assert_array_equal(eng.predict_at(xs[0], 2),
                                          twin(batch)[0].numpy())


def _train_jax(jm, ckpt):
    """Two SGD steps of JAX's ``LocalOptimizer`` on the MLP with a
    BatchNorm, checkpointing at the second."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    opt = joptim.LocalOptimizer(
        jm, jarray_dataset(x, y) >> JaxToMiniBatch(4), jnn.MSECriterion(),
        joptim.SGD(learning_rate=0.1))
    opt.set_end_when(joptim.Trigger.max_iteration(2))
    opt.set_checkpoint(str(ckpt), joptim.Trigger.several_iteration(2))
    opt.optimize()
    return opt


def test_refresh_from_snapshot_of_a_jax_written_snapshot(tmp_path):
    """A snapshot JAX's ``LocalOptimizer`` wrote (parameters and the
    BatchNorm's statistics): the port's engine takes it from the
    directory and serves the trained model, within 1e-5 of JAX's engine
    refreshed from the same snapshot."""
    jm, _tm = _mlps(7, bn=True)
    _train_jax(jm, tmp_path)
    assert os.path.exists(tmp_path / "checkpoint.2.pkl")
    _jo, tm = _mlps(8, bn=True)                   # other weights
    jfresh, _ = _mlps(9, bn=True)
    xs = _xs(width=8, seed=4)
    with JaxEngine(jfresh, max_batch_size=4) as jeng:
        jeng.refresh_from_snapshot(str(tmp_path))
        want = np.asarray(jeng.predict_at(xs[0], 4))
    with _port(tm, max_batch_size=4) as eng:
        before = eng.predict_at(xs[0], 4)
        eng.refresh_from_snapshot(str(tmp_path))
        got = eng.predict_at(xs[0], 4)
        # the file itself, too
        eng.refresh_from_snapshot(str(tmp_path / "checkpoint.2.pkl"))
        np.testing.assert_array_equal(got, eng.predict_at(xs[0], 4))
    assert not np.allclose(before, want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    os.makedirs(tmp_path / "empty")
    with _port(tm, max_batch_size=4) as eng:
        with pytest.raises(ValueError, match="no intact snapshot"):
            eng.refresh_from_snapshot(str(tmp_path / "empty"))


def test_refresh_from_snapshot_of_a_port_written_snapshot(tmp_path):
    """The port's own ``LocalOptimizer`` checkpoint refreshes its engine:
    the served outputs are the trained model's."""
    _jm, tm = _mlps(10, bn=True)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    y = rng.standard_normal((8, 4)).astype(np.float32)
    trained = _mlps(10, bn=True)[1]
    opt = optim.Optimizer(trained, array_dataset(x, y) >> SampleToMiniBatch(4),
                          nn.MSECriterion(), optim.SGD(learning_rate=0.1),
                          device="cpu")
    # the checkpoint after the second step (neval 3), the run's last
    opt.set_end_when(optim.Trigger.max_iteration(2))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(3))
    opt.optimize()
    assert os.path.exists(tmp_path / "checkpoint.3.pkl")
    trained.eval()
    xs = _xs(width=8, seed=5)
    with _port(tm, max_batch_size=4) as eng:
        eng.refresh_from_snapshot(str(tmp_path))
        got = eng.predict_at(xs[0], 4)
    batch = torch.from_numpy(np.concatenate(
        [xs[:1], np.zeros((3, 8), np.float32)]))
    with torch.no_grad():
        want = trained(batch)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# The prefix cache on a swap
# --------------------------------------------------------------------------- #


VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 128, 32, 2, 2, 64


def test_commit_flushes_the_prefix_cache_and_serves_the_candidate():
    """A shared prefix leaves cached blocks; a commit flushes them (as
    JAX's ``flush_prefix_cache`` does), and the next greedy stream is a
    fresh engine's on the candidate weights."""
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(3))
    jc = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN)
    jc.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(4))
    tm = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                       device="cpu")
    load_jax_params(tm, _np(jm.parameters()[0]))
    cand = _np(jc.parameters()[0])
    prefix = list(range(1, 13))
    prompts = [prefix + [20], prefix + [30]]
    kw = dict(decode_slots=2, decode_max_len=48, kv_block_size=4)
    with JaxEngine(jm, **kw) as jeng:
        jeng.generate(prompts[0], max_new_tokens=4).result(120)
        assert jeng.stats()["generate"]["kv"]["blocks_cached"] > 0
        jeng.commit_staged(jeng.stage_weights(cand))
        jcached = jeng.stats()["generate"]["kv"]["blocks_cached"]
        jstream = jeng.generate(prompts[1], max_new_tokens=6).result(120)
    with _port(tm, **kw) as eng:
        eng.generate(prompts[0], max_new_tokens=4).result(60)
        assert eng.stats()["generate"]["kv"]["blocks_cached"] > 0
        hits = eng.stats()["generate"]["kv"]["prefix_hits"]
        eng.commit_staged(eng.stage_weights(cand))
        assert eng.stats()["generate"]["kv"]["blocks_cached"] == jcached == 0
        stream = eng.generate(prompts[1], max_new_tokens=6).result(60)
        assert eng.stats()["generate"]["kv"]["prefix_hits"] == hits
    fresh = TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=MAX_LEN,
                          device="cpu")
    load_jax_params(fresh, cand)
    with _port(fresh, **kw) as eng:
        want = eng.generate(prompts[1], max_new_tokens=6).result(60)
    assert stream == want == jstream
