"""Checkpoints, resume and the retry loop of the port
(``bigdl_tpu_torch/utils/file_io.py``, ``LocalOptimizer.set_checkpoint``,
``resume_from_checkpoint``, ``optimize()``'s retries, the datasets'
``position_state``) against the JAX package's, on the CPU.

- Snapshot integrity, the cases of JAX ``tests/test_recovery.py:104-233``
  on snapshots written by either package: the manifest verifies, a
  truncated or bit-flipped snapshot is quarantined and resolution falls
  back, a temp orphan is invisible, a manifest-less snapshot is accepted
  and garbage quarantined, write retries, an empty directory is a fresh
  start and an all-corrupt one raises; sharded snapshots are refused.
- The dataset position cases (:253-355): a round trip, a size mismatch,
  the transformed dataset delegating, a position state crossing between
  the packages, a source without one resuming with a warning.
- A port checkpoint's payload has the JAX checkpoint's layout: keys,
  leaf types and shapes, the driver state's keys.
- Resume within the port: a run resumed mid-epoch from a fresh model
  equals the straight run (losses 1e-6 relative, parameters 1e-5
  relative L2: the CPU's GEMMs round two runs of the same step apart by
  about 1e-7, which 10 steps of SGD with momentum grow to 4e-7-7e-7).
- The retry loop restores once and finishes like the straight run; it
  does not retry a ``ConfigurationError``, and stops when out of
  retries.
- Across the packages, on the "tiny" TransformerLM (vocab 256, seq 64)
  with JAX's weights: a JAX ``LocalOptimizer`` checkpoint (Adam, and a
  ``CompositeOptimMethod``) resumes in the port, and a port checkpoint
  resumes in JAX; each continues 2 steps to parameters within 1e-5 of
  the other package's straight run.
"""

import logging
import os

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm
from bigdl_tpu_torch.optim import optim_method as tom
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.errors import (CheckpointCorruptionError,
                                          ConfigurationError,
                                          UnsupportedFeatureError)
from bigdl_tpu_torch.utils.random_generator import RNG

VOCAB, SEQ = 256, 64


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads a test: workers running these tests side by side
    would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _corpus(n=24, seed=3):
    return synthetic_corpus(n, SEQ, VOCAB, seed=seed)


def _crit(m=nn):
    return m.TimeDistributedCriterion(m.FusedSoftmaxCrossEntropyCriterion())


# --------------------------------------------------------------------------- #
# Snapshot integrity
# --------------------------------------------------------------------------- #

def _writer(pkg):
    if pkg == "jax":
        from bigdl_tpu.utils import file_io as jfile_io
        return jfile_io
    return file_io


def _snap(pkg, d, tag=2):
    return _writer(pkg).save_checkpoint(
        str(d), tag, {"w": np.arange(4.0)}, {}, {},
        {"neval": tag, "epoch": 1})


@pytest.mark.parametrize("writer", ["port", "jax"])
class TestSnapshotIntegrity:
    def test_save_writes_manifest_that_verifies(self, writer, tmp_path):
        p = _snap(writer, tmp_path)
        man = file_io.read_manifest(p)
        rec = man["files"][os.path.basename(p)]
        assert rec["bytes"] == os.path.getsize(p)
        assert file_io.verify_snapshot(p) is None
        assert file_io.latest_checkpoint(str(tmp_path)) == p
        assert file_io.load(p)["driver_state"]["neval"] == 2

    def test_truncated_snapshot_quarantined_falls_back(self, writer,
                                                       tmp_path):
        good = _snap(writer, tmp_path, tag=2)
        bad = _snap(writer, tmp_path, tag=4)
        with open(bad, "r+b") as f:
            f.truncate(os.path.getsize(bad) // 2)
        intact, quarantined = file_io.scan_checkpoints(str(tmp_path))
        assert intact == [good]
        assert any(p.endswith(".corrupt") for p in quarantined)
        assert not os.path.exists(bad)
        assert os.path.exists(bad + ".corrupt")

    def test_digest_flip_quarantined(self, writer, tmp_path):
        good = _snap(writer, tmp_path, tag=2)
        bad = _snap(writer, tmp_path, tag=4)
        with open(bad, "r+b") as f:
            f.seek(os.path.getsize(bad) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0xFF]))
        assert file_io.latest_checkpoint(str(tmp_path)) == good

    def test_kill_between_temp_write_and_rename(self, writer, tmp_path):
        good = _snap(writer, tmp_path, tag=2)
        orphan = os.path.join(str(tmp_path),
                              "checkpoint.4.pkl" + file_io.TMP_MARKER + "99")
        with open(orphan, "wb") as f:
            f.write(b"half a pickle")
        intact, quarantined = file_io.scan_checkpoints(str(tmp_path))
        assert intact == [good] and quarantined == []

    def test_manifestless_legacy_accepted_but_garbage_quarantined(
            self, writer, tmp_path):
        legacy = os.path.join(str(tmp_path), "checkpoint.2.pkl")
        _writer(writer).save({"model_params": {}, "model_state": {},
                              "opt_state": {}, "driver_state": {"neval": 2}},
                             legacy)
        garbage = os.path.join(str(tmp_path), "checkpoint.4.pkl")
        with open(garbage, "wb") as f:
            f.write(b"\x80\x04 not a pickle at all")
        intact, quarantined = file_io.scan_checkpoints(str(tmp_path))
        assert intact == [legacy]
        assert quarantined and quarantined[0].endswith(".corrupt")


def test_port_snapshots_verify_and_load_in_jax(tmp_path):
    """JAX's resolution verifies a port snapshot's manifest and loads the
    same payload; a truncated port snapshot is quarantined by it."""
    from bigdl_tpu.utils import file_io as jfile_io

    good = _snap("port", tmp_path, tag=2)
    bad = _snap("port", tmp_path, tag=4)
    with open(bad, "r+b") as f:
        f.truncate(10)
    assert jfile_io.latest_checkpoint(str(tmp_path)) == good
    got = jfile_io.load(good)
    np.testing.assert_array_equal(got["model_params"]["w"], np.arange(4.0))


def test_write_retries_transient_then_raise():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    slept = []
    assert file_io.with_write_retries(flaky, retries=3, backoff_s=0.01,
                                      sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2

    def dead_disk():
        raise OSError("dead disk")

    with pytest.raises(OSError):
        file_io.with_write_retries(dead_disk, retries=1, backoff_s=0.0,
                                   sleep=lambda s: None)

    def deterministic():
        raise TypeError("unpicklable payload")

    retried = []
    with pytest.raises(TypeError):
        file_io.with_write_retries(deterministic, retries=5,
                                   sleep=retried.append)
    assert retried == []


def test_write_retries_read_the_environment(monkeypatch):
    monkeypatch.setenv("BIGDL_CKPT_WRITE_RETRIES", "4")
    slept = []

    def dead_disk():
        raise OSError("dead disk")

    with pytest.raises(OSError):
        file_io.with_write_retries(dead_disk, backoff_s=0.0,
                                   sleep=slept.append)
    assert len(slept) == 4


def _port_opt(model=None, n=24, batch=4, dataset=None, method=None):
    RNG.set_seed(7)
    if model is None:
        model = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu")
    if dataset is None:
        x, y = _corpus(n)
        dataset = array_dataset(x, y) >> SampleToMiniBatch(batch)
    return optim.Optimizer(
        model, dataset, _crit(),
        method or optim.SGD(learning_rate=0.1, momentum=0.9,
                            dampening=0.0), device="cpu")


class TestResumeResolution:
    def test_fresh_start_when_dir_empty(self, tmp_path):
        opt = _port_opt()
        opt.set_checkpoint(str(tmp_path / "none"),
                           optim.Trigger.several_iteration(2))
        assert opt.resume_from_checkpoint() is opt
        assert opt._resume is None

    def test_all_corrupt_raises_listing_quarantined(self, tmp_path):
        bad = os.path.join(str(tmp_path), "checkpoint.3.pkl")
        with open(bad, "wb") as f:
            f.write(b"truncated nonsense")
        opt = _port_opt()
        opt.checkpoint_path = str(tmp_path)
        with pytest.raises(CheckpointCorruptionError) as ei:
            opt.resume_from_checkpoint()
        assert "checkpoint.3.pkl.corrupt" in str(ei.value)

    def test_verified_but_unloadable_snapshot_falls_back(self, tmp_path,
                                                         monkeypatch):
        good = _snap("port", tmp_path, tag=2)
        bad = _snap("port", tmp_path, tag=4)
        load = file_io.load
        monkeypatch.setattr(file_io, "load", lambda p: (_ for _ in ()).throw(
            ValueError("saver bug")) if p == bad else load(p))
        opt = _port_opt()
        opt.resume_from_checkpoint(str(tmp_path))
        assert opt._resume_path == good
        assert os.path.exists(bad + ".corrupt")

    def test_sharded_snapshots_are_refused(self, tmp_path):
        with pytest.raises(UnsupportedFeatureError):
            _port_opt().set_sharded_checkpoint(
                str(tmp_path), optim.Trigger.several_iteration(2))


# --------------------------------------------------------------------------- #
# Dataset position
# --------------------------------------------------------------------------- #

def _rows(n=12, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 5)).astype("float32"),
            rng.integers(0, 3, n).astype("int32"))


class TestDatasetPosition:
    def test_local_dataset_roundtrip(self):
        x, y = _rows()
        ds = array_dataset(x, y)
        ds.shuffle()
        state = ds.position_state()
        it = ds.data(train=True)
        first = [next(it) for _ in range(5)]
        ds.shuffle()
        ds.restore_position(state)
        it2 = ds.data(train=True)
        for a, b in zip(first, [next(it2) for _ in range(5)]):
            np.testing.assert_array_equal(a.feature, b.feature)
        ds.shuffle()                       # the restored stream reshuffles
        post = next(ds.data(train=True))
        ds.restore_position(state)
        ds.shuffle()
        np.testing.assert_array_equal(post.feature,
                                      next(ds.data(train=True)).feature)

    def test_position_state_size_mismatch_rejected(self):
        x, y = _rows()
        state = array_dataset(x, y).position_state()
        with pytest.raises(ValueError):
            array_dataset(x[:6], y[:6]).restore_position(state)

    def test_transformed_delegates(self):
        x, y = _rows(24)
        ds = array_dataset(x, y) >> SampleToMiniBatch(8)
        state = ds.position_state()
        assert state is not None and state["kind"] == "local"
        ds.restore_position(state)
        with pytest.raises(NotImplementedError):
            AbstractDataSet().restore_position(state)

    @pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
    def test_position_state_crosses_packages(self, direction):
        """A position taken in one package (after two shuffles), saved and
        loaded through a checkpoint pickle, restores the other package's
        dataset to the same order and the same next reshuffle."""
        from bigdl_tpu.dataset import array_dataset as jarray_dataset

        x, y = _rows(10)
        src, dst = (jarray_dataset(x, y), array_dataset(x, y))
        if direction == "port-to-jax":
            src, dst = dst, src
        src.shuffle()
        src.shuffle()
        state = file_io._to_numpy(src.position_state())
        dst.restore_position(state)
        order = [s.feature[0] for s in _take(src, 10)]
        assert order == [s.feature[0] for s in _take(dst, 10)]
        src.shuffle()
        dst.shuffle()
        assert [s.feature[0] for s in _take(src, 10)] == \
            [s.feature[0] for s in _take(dst, 10)]


def _take(ds, n):
    it = ds.data(train=True)
    return [next(it) for _ in range(n)]


def test_stream_dataset_without_position_resumes_with_warning(tmp_path,
                                                              caplog):
    """A source with no ``position_state``: resume restarts the epoch,
    with a warning, and the counters go on."""
    x, y = _corpus(16)
    inner = array_dataset(x, y) >> SampleToMiniBatch(4)

    class NoPos(AbstractDataSet):
        def data(self, train):
            return inner.data(train)

        def size(self):
            return inner.size()

        def shuffle(self):
            inner.shuffle()

    opt = _port_opt(dataset=NoPos())
    opt.set_end_when(optim.Trigger.max_iteration(3))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    opt.optimize()
    opt2 = _port_opt(dataset=NoPos())
    opt2.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(100))
    opt2.resume_from_checkpoint()
    opt2.set_end_when(optim.Trigger.max_iteration(5))
    with caplog.at_level(logging.WARNING, "bigdl_tpu_torch.optim"):
        opt2.optimize()
    assert any("position_state" in r.message for r in caplog.records)
    assert opt2.driver_state["neval"] == 6


# --------------------------------------------------------------------------- #
# The payload's layout, resume and the retry loop within the port
# --------------------------------------------------------------------------- #

def _shape_tree(tree):
    """Keys, leaf dtypes and shapes, in order."""
    if isinstance(tree, dict):
        return [(k, _shape_tree(v)) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [type(tree).__name__, [_shape_tree(v) for v in tree]]
    if tree is None:
        return None
    return (str(np.asarray(tree).dtype.kind), np.shape(tree))


def test_checkpoint_payload_has_the_jax_layout(tmp_path):
    """The same run (tiny TransformerLM, SGD with momentum, 3 steps, a
    checkpoint at neval 4) in both packages: the payloads' keys, key
    order, leaf dtypes (by kind) and shapes agree, the driver state's
    keys too (scalars as 0-d arrays, the position block, the random
    stream as a uint32 pair)."""
    import jax
    import jax.numpy as jnp

    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
    from bigdl_tpu.dataset import array_dataset as jarray_dataset
    from bigdl_tpu.nn import criterion as jcrit
    from bigdl_tpu.nn.attention import TransformerLM as JaxLM

    x, y = _corpus()
    jm = JaxLM(VOCAB, 256, 4, 4, max_len=SEQ)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32),
             rng=jax.random.PRNGKey(0))
    jopt = joptim.LocalOptimizer(
        jm, jarray_dataset(x, y) >> JaxToMiniBatch(4), _crit(jcrit),
        joptim.SGD(learning_rate=0.1, momentum=0.9, dampening=0.0))
    jopt.set_end_when(joptim.Trigger.max_iteration(3))
    jopt.set_checkpoint(str(tmp_path / "jax"),
                        joptim.Trigger.several_iteration(4))
    jopt.optimize()
    opt = _port_opt()
    opt.set_end_when(optim.Trigger.max_iteration(3))
    opt.set_checkpoint(str(tmp_path / "port"),
                       optim.Trigger.several_iteration(4))
    opt.optimize()
    want = file_io.load(str(tmp_path / "jax" / "checkpoint.4.pkl"))
    got = file_io.load(str(tmp_path / "port" / "checkpoint.4.pkl"))
    for key in ("model_params", "model_state", "opt_state"):
        assert _shape_tree(got[key]) == _shape_tree(want[key]), key
    gd, wd = got["driver_state"], want["driver_state"]
    assert list(gd) == list(wd)
    assert _shape_tree(gd["data_position"]) == \
        _shape_tree(wd["data_position"])
    assert gd["rng_state"].dtype == wd["rng_state"].dtype == np.uint32
    assert gd["rng_state"].shape == wd["rng_state"].shape == (2,)
    for k in ("neval", "epoch", "record_count", "batches_consumed"):
        assert isinstance(gd[k], np.ndarray) and gd[k].ndim == 0
        assert int(gd[k]) == int(wd[k]), k


def _straight_and_resumed(tmp_path, steps, ckpt_every, method):
    """Losses by step and the final parameters of a straight run of
    ``steps``, and of a run checkpointed at ``ckpt_every`` then resumed
    by a fresh model (other weights) and optimizer to ``steps``."""
    def run(model, ckpt=None, every=None, resume=False, end=steps):
        losses = {}

        class _Summary:
            def add_scalar(self, tag, value, step):
                if tag == "Loss":
                    losses[step] = value

        opt = _port_opt(model=model, method=method())
        opt.set_end_when(optim.Trigger.max_iteration(end))
        opt.set_train_summary(_Summary())
        if ckpt:
            opt.set_checkpoint(str(ckpt), optim.Trigger.several_iteration(
                every))
        if resume:
            opt.resume_from_checkpoint()
        opt.optimize()
        return losses, opt

    m1 = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu")
    straight, _ = run(m1)
    ck = tmp_path / "ck"
    first, _ = run(transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu"),
                   ck, ckpt_every, end=ckpt_every)
    m2 = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu", seed=5)
    second, opt2 = run(m2, ck, 100, resume=True)
    return straight, {**first, **second}, m1, m2, opt2


def _close_models(a, b, tol):
    """Every parameter within ``tol`` relative L2."""
    for (k, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert ((pb - pa).norm() / pa.norm()).item() <= tol, k


def test_resume_mid_epoch_equals_the_straight_run(tmp_path):
    """6 batches an epoch; a checkpoint at neval 4 (mid-epoch), a fresh
    model resumed from it runs to step 10 (past a reshuffle): every
    step's loss and the parameters equal the straight run's."""
    straight, resumed, m1, m2, opt2 = _straight_and_resumed(
        tmp_path, 10, 4, lambda: optim.SGD(learning_rate=0.1, momentum=0.9,
                                           dampening=0.0))
    assert sorted(resumed) == list(range(1, 11))
    np.testing.assert_allclose([resumed[s] for s in range(1, 11)],
                               [straight[s] for s in range(1, 11)],
                               rtol=1e-6)
    _close_models(m1, m2, 1e-5)
    assert opt2.driver_state["epoch"] == 2
    assert opt2.driver_state["neval"] == 11


def test_resume_in_place_keeps_the_tensors(tmp_path):
    """Resume copies into the model's parameters and the method's state:
    the tensors a built step holds are the ones the snapshot filled."""
    opt = _port_opt()
    opt.set_end_when(optim.Trigger.max_iteration(2))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(2))
    opt.optimize()
    model = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu", seed=3)
    ids = {k: p.data_ptr() for k, p in model.named_parameters()}
    opt2 = _port_opt(model=model, method=optim.SGD(
        learning_rate=0.1, momentum=0.9, dampening=0.0))
    method = opt2.optim_method
    state = method.init_state(dict(model.named_parameters()))
    method.state = state
    velocity = state["velocity"]["wte"].data_ptr()
    opt2.resume_from_checkpoint(str(tmp_path))
    opt2.set_end_when(optim.Trigger.max_iteration(1))
    opt2.optimize()                      # resumes at neval 2: no step
    assert {k: p.data_ptr() for k, p in model.named_parameters()} == ids
    assert method.state["velocity"]["wte"].data_ptr() == velocity
    snap = file_io.load(str(tmp_path / "checkpoint.2.pkl"))
    np.testing.assert_array_equal(model.wte.detach().numpy(),
                                  snap["model_params"]["wte"])
    np.testing.assert_array_equal(
        method.state["velocity"]["wte"].numpy(),
        snap["opt_state"]["velocity"]["wte"])
    assert int(method.state["neval"]) == int(snap["opt_state"]["neval"])


class _FailOnce(AbstractDataSet):
    def __init__(self, base, at, error=RuntimeError):
        self.base, self.at, self.error = base, at, error
        self.fetched, self.failed = 0, False

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()

    def position_state(self):
        return self.base.position_state()

    def restore_position(self, state):
        self.base.restore_position(state)

    def data(self, train):
        it = self.base.data(train)

        def gen():
            for b in it:
                if train:
                    self.fetched += 1
                    if not self.failed and self.fetched == self.at:
                        self.failed = True
                        raise self.error("injected fault")
                yield b
        return gen()


def _flaky_run(tmp_path, at, error=RuntimeError, every=2, end=6):
    x, y = _corpus()
    flaky = _FailOnce(array_dataset(x, y) >> SampleToMiniBatch(4), at,
                      error)
    opt = _port_opt(dataset=flaky)
    opt.set_end_when(optim.Trigger.max_iteration(end))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(every))
    calls = []
    resume = opt.resume_from_checkpoint
    opt.resume_from_checkpoint = lambda *a: (calls.append(1), resume(*a))[1]
    return opt, flaky, calls


def test_retry_loop_restores_once_and_finishes(tmp_path):
    """The 5th batch's fetch raises once: ``optimize()`` resumes from the
    checkpoint at neval 4 and finishes at the straight run's
    parameters."""
    opt, flaky, calls = _flaky_run(tmp_path / "flaky", at=5)
    opt.optimize()
    assert flaky.failed and calls == [1]
    assert opt.driver_state["neval"] == 7
    straight = _port_opt()
    straight.set_end_when(optim.Trigger.max_iteration(6))
    straight.optimize()
    _close_models(straight.model, opt.model, 1e-5)


def test_retry_loop_does_not_retry_configuration_errors(tmp_path):
    opt, _, calls = _flaky_run(tmp_path, at=3, error=ConfigurationError)
    with pytest.raises(ConfigurationError):
        opt.optimize()
    assert calls == []


def test_retry_loop_stops_when_out_of_retries(tmp_path, monkeypatch):
    monkeypatch.setenv("BIGDL_FAILURE_RETRY_TIMES", "0")
    opt, _, calls = _flaky_run(tmp_path, at=5)
    with pytest.raises(RuntimeError, match="injected"):
        opt.optimize()
    assert calls == []


def test_random_stream_state_round_trips():
    """``get_state`` is a uint32 pair from which the stream goes on as
    ``set_state`` starts it; a JAX key seeds the stream the same way
    every time."""
    RNG.set_seed(3)
    RNG.next_generator()
    state = RNG.get_state()
    assert state.dtype == np.uint32 and state.shape == (2,)
    after = [int(torch.randint(0, 1000, (), generator=RNG.next_generator()))
             for _ in range(3)]
    RNG.set_seed(99)
    RNG.set_state(state)
    assert after == [int(torch.randint(0, 1000, (),
                                       generator=RNG.next_generator()))
                     for _ in range(3)]
    from bigdl_tpu.utils.random_generator import RNG as JRNG
    jkey = JRNG.get_state()
    RNG.set_state(jkey)
    a = int(torch.randint(0, 1 << 30, (), generator=RNG.next_generator()))
    RNG.set_state(jkey)
    assert a == int(torch.randint(0, 1 << 30, (),
                                  generator=RNG.next_generator()))


# --------------------------------------------------------------------------- #
# Across the packages
# --------------------------------------------------------------------------- #

def _methods(o):
    """``name -> factory``, ``o`` a package's ``optim_method`` module:
    Adam, and a composite (SGD
    for the embedding table, Adam elsewhere).  A large epsilon keeps
    Adam from scaling rounding noise on exactly-zero gradients (the key
    part of ``qkv_bias``) up to full steps."""
    return {
        "adam": lambda: o.Adam(learning_rate=1e-2, epsilon=1e-3),
        "composite": lambda: o.CompositeOptimMethod(
            [("embedding", ("wte",), o.SGD(learning_rate=0.5,
                                            momentum=0.9)),
             *((k, (k,), o.Adam(learning_rate=1e-2, epsilon=1e-3))
               for k in ("wpe", "head", "block0", "block1", "block2",
                         "block3", "ln_f"))]),
    }


def _jax_model(seed):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.nn.attention import TransformerLM as JaxLM

    jm = JaxLM(VOCAB, 256, 4, 4, max_len=SEQ)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32),
             rng=jax.random.PRNGKey(seed))
    return jm


def _jax_run(jm, method, end, ckpt=None, every=None, resume=False):
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
    from bigdl_tpu.dataset import array_dataset as jarray_dataset
    from bigdl_tpu.nn import criterion as jcrit

    x, y = _corpus()
    opt = joptim.LocalOptimizer(
        jm, jarray_dataset(x, y) >> JaxToMiniBatch(4), _crit(jcrit), method)
    opt.set_end_when(joptim.Trigger.max_iteration(end))
    if ckpt:
        opt.set_checkpoint(str(ckpt), joptim.Trigger.several_iteration(every))
    if resume:
        opt.resume_from_checkpoint()
    opt.optimize()
    return opt


def _port_model_from(jm):
    import jax

    from bigdl_tpu_torch.interop import load_jax_params

    tm = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu", seed=9)
    return load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))


def _close_to_jax(tm, jm, tol):
    import jax

    from bigdl_tpu_torch.interop import to_jax_params

    want = jax.tree.map(np.asarray, jm.parameters()[0])
    got = to_jax_params(tm)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], w, rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("method", ["adam", "composite"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, method):
    """JAX trains 4 steps of 6 an epoch and checkpoints at neval 5; a port
    model (other weights) and optimizer resume from it and take steps 5
    and 6: the parameters within 1e-5 of JAX's straight 6 steps."""
    from bigdl_tpu.optim import optim_method as jom

    jstraight = _jax_model(0)
    _jax_run(jstraight, _methods(jom)[method](), 6)
    _jax_run(_jax_model(0), _methods(jom)[method](), 4, tmp_path, 5)
    assert os.path.exists(tmp_path / "checkpoint.5.pkl")
    tm = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu", seed=9)
    opt = _port_opt(model=tm, method=_methods(tom)[method]())
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(100))
    opt.resume_from_checkpoint()
    opt.set_end_when(optim.Trigger.max_iteration(6))
    opt.optimize()
    assert opt.driver_state["neval"] == 7
    _close_to_jax(tm, jstraight, 1e-5)


@pytest.mark.parametrize("method", ["adam", "composite"])
def test_port_checkpoint_resumes_in_jax(tmp_path, method):
    """The port trains 4 steps from JAX's weights and checkpoints at
    neval 5; a JAX model (other weights) and ``LocalOptimizer`` resume
    from it and take steps 5 and 6: the parameters within 1e-5 of the
    port's straight 6 steps."""
    from bigdl_tpu.optim import optim_method as jom

    straight = _port_model_from(_jax_model(0))
    opt = _port_opt(model=straight, method=_methods(tom)[method]())
    opt.set_end_when(optim.Trigger.max_iteration(6))
    opt.optimize()
    opt = _port_opt(model=_port_model_from(_jax_model(0)),
                    method=_methods(tom)[method]())
    opt.set_end_when(optim.Trigger.max_iteration(4))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(5))
    opt.optimize()
    jm = _jax_model(1)
    jopt = _jax_run(jm, _methods(jom)[method](), 6, tmp_path, 100,
                    resume=True)
    assert jopt.driver_state["neval"] == 7
    _close_to_jax(straight, jm, 1e-5)
