"""The prefetch pipeline of the port (``bigdl_tpu_torch/dataset/
prefetch.py``, ``AbstractDataSet.prefetch()``, the recipes'
``--numWorkers`` / ``--queueDepth``) against the JAX package's
``bigdl_tpu/dataset/prefetch.py``, on the CPU; the cases of JAX's
``tests/test_prefetch.py:86-264`` at the same small sizes.

- The chain's decomposition and its split at the first order-dependent
  stage; a stateful stage stays serial, in source order.
- Determinism: the prefetched batch sequence equals the synchronous one
  across epoch reshuffles with workers in flight, and equals JAX's
  prefetched sequence batch for batch (exact: the same numpy draws); an
  8-step loss trajectory with 2 workers equals the synchronous one
  bitwise and JAX's within 1e-5.
- Lifecycle: a worker's exception surfaces in ``next()`` and in
  ``optimize()``; no ``bigdl-prefetch`` thread outlives ``optimize()``
  (predicted end, an exception); the reorder buffer stays bounded under a
  stalled consumer; ``queue_stats``; 0 workers is the synchronous path;
  the eval stream stays synchronous; bad settings raise.
- Resume through the pipeline: a checkpoint taken mid-epoch with workers
  in flight, resumed by a fresh model, reproduces the straight run.
- The recipes take ``--numWorkers`` and ``--queueDepth``.
"""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import Normalizer as JNormalizer
from bigdl_tpu.dataset import SampleToMiniBatch as JToBatch
from bigdl_tpu.dataset import array_dataset as jarray
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import (FnTransformer, Normalizer,
                                     PrefetchDataSet, SampleToMiniBatch,
                                     array_dataset)
from bigdl_tpu_torch.dataset.prefetch import decompose, split_parallel
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.models import run as trun


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("bigdl-prefetch")]


def _data(seed=0, n=96):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype("float32")
    y = rng.integers(0, 4, n).astype("int32")
    return x, y


def _pipeline(seed=0, n=96, batch=32, workers=0, queue_depth=4, jax_=False):
    x, y = _data(seed, n)
    arr, norm, to_batch = (jarray, JNormalizer, JToBatch) if jax_ else \
        (array_dataset, Normalizer, SampleToMiniBatch)
    ds = arr(x, y) >> norm(0.0, 1.0) >> to_batch(batch)
    if workers:
        ds = ds.prefetch(num_workers=workers, queue_depth=queue_depth)
    return ds


def _jax_model():
    m = (jnn.Sequential().add(jnn.Linear(8, 16)).add(jnn.ReLU())
         .add(jnn.Linear(16, 4)))
    m.build(jax.ShapeDtypeStruct((2, 8), jnp.float32),
            rng=jax.random.PRNGKey(0))
    return m


def _model():
    m = (nn.Sequential().add(nn.Linear(8, 16)).add(nn.ReLU())
         .add(nn.Linear(16, 4))).to("cpu")
    return load_jax_params(m, jax.tree.map(np.asarray,
                                           _jax_model().parameters()[0]))


class _Losses:
    """A train summary that keeps each step event's loss."""

    def __init__(self):
        self.losses = []

    def add_step_event(self, event):
        self.losses.append(event["loss"])

    def add_scalar(self, tag, value, step):
        pass


def _fit(ds, iterations=8, model=None, ckpt=None, every=100, resume=False):
    opt = optim.Optimizer(model or _model(), ds, nn.CrossEntropyCriterion(),
                          optim.SGD(learning_rate=0.1), device="cpu")
    opt.set_end_when(optim.Trigger.max_iteration(iterations))
    summary = _Losses()
    opt.set_train_summary(summary)
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), optim.Trigger.several_iteration(every))
    if resume:
        opt.resume_from_checkpoint()
    opt.optimize()
    return opt, summary.losses


class TestChainDecomposition:
    def test_decompose_walks_nested_wrappers_in_order(self):
        source, stages = decompose(_pipeline())
        assert [type(t).__name__ for t in stages] == [
            "Normalizer", "SampleToMiniBatch"]
        assert source.size() == 96

    def test_split_at_first_order_dependent_stage(self):
        _, stages = decompose(_pipeline())
        fns, suffix = split_parallel(stages)
        assert len(fns) == 1                      # Normalizer.apply_one
        assert [type(t).__name__ for t in suffix] == ["SampleToMiniBatch"]

    def test_chained_transformer_flattens(self):
        chain = Normalizer(0.0, 1.0) >> FnTransformer(lambda s: s) \
            >> SampleToMiniBatch(4)
        base = array_dataset(np.zeros((8, 2), "float32"))
        _, stages = decompose(base >> chain)
        fns, suffix = split_parallel(stages)
        assert len(fns) == 2 and len(suffix) == 1

    def test_parallel_safe_false_stays_serial(self):
        seen = []
        stateful = FnTransformer(lambda s: (seen.append(s), s)[1],
                                 parallel_safe=False)
        ds = array_dataset(np.arange(32, dtype="float32").reshape(8, 4))
        for t in (Normalizer(0.0, 1.0), stateful, SampleToMiniBatch(4)):
            ds = ds >> t
        _, stages = decompose(ds)
        fns, suffix = split_parallel(stages)
        assert len(fns) == 1 and stages[1] in suffix
        pre = ds.prefetch(num_workers=3, queue_depth=2)
        it = pre.data(train=True)
        for _ in range(4):                   # more than an epoch
            next(it)
        pre.shutdown()
        feats = [float(np.asarray(s.feature)[0]) for s in seen[:8]]
        assert feats == sorted(feats)


def _collect(ds, epochs=3, steps_per_epoch=3):
    out = []
    for _ in range(epochs):
        it = ds.data(train=True)
        for _ in range(steps_per_epoch):
            out.append(next(it))
        ds.shuffle()              # reshuffle with workers in flight
    shutdown = getattr(ds, "shutdown", None)
    if shutdown:
        shutdown()
    return out


class TestDeterminism:
    def test_batch_sequence_matches_synchronous_path_and_jax(self):
        a = _collect(_pipeline(workers=0))
        b = _collect(_pipeline(workers=3, queue_depth=2))
        c = _collect(_pipeline(workers=3, queue_depth=2, jax_=True))
        assert len(a) == len(b) == len(c) == 9
        for ba, bb, bc in zip(a, b, c):
            for get in ("get_input", "get_target"):
                np.testing.assert_array_equal(getattr(ba, get)(),
                                              getattr(bb, get)())
                np.testing.assert_array_equal(getattr(bb, get)(),
                                              np.asarray(getattr(bc, get)()))
        assert _prefetch_threads() == []

    def test_loss_trajectory_matches_synchronous_path_and_jax(self):
        _, sync_losses = _fit(_pipeline(workers=0))
        _, pre_losses = _fit(_pipeline(workers=2, queue_depth=3))
        assert len(sync_losses) == 8
        assert sync_losses == pre_losses          # bitwise
        jopt = joptim.LocalOptimizer(
            _jax_model(), _pipeline(workers=2, queue_depth=3, jax_=True),
            jnn.CrossEntropyCriterion(), joptim.SGD(learning_rate=0.1))
        jopt.set_end_when(joptim.Trigger.max_iteration(8))
        jlosses = _Losses()
        jopt.set_train_summary(jlosses)
        jopt.optimize()
        np.testing.assert_allclose(pre_losses, jlosses.losses, rtol=1e-5)
        assert _prefetch_threads() == []


class TestLifecycle:
    def test_worker_exception_propagates(self):
        def boom(sample):
            raise ValueError("transform exploded")

        ds = (array_dataset(np.ones((16, 4), "float32"),
                            np.zeros(16, "int32"))
              >> FnTransformer(boom) >> SampleToMiniBatch(4))
        pre = ds.prefetch(num_workers=2, queue_depth=2)
        it = pre.data(train=True)
        with pytest.raises(ValueError, match="transform exploded"):
            next(it)
        pre.shutdown()
        assert _prefetch_threads() == []

    def test_worker_exception_surfaces_in_optimize(self):
        calls = {"n": 0}
        lock = threading.Lock()

        def boom_later(sample):
            with lock:
                calls["n"] += 1
                n = calls["n"]
            if n > 40:
                raise RuntimeError("mid-epoch transform failure")
            return sample

        x, y = _data()
        ds = (array_dataset(x, y) >> FnTransformer(boom_later)
              >> SampleToMiniBatch(32))
        pre = ds.prefetch(num_workers=2, queue_depth=2)
        with pytest.raises(RuntimeError, match="mid-epoch transform"):
            _fit(pre, iterations=50)
        assert _prefetch_threads() == []

    def test_shutdown_after_predicted_end_leaves_no_threads(self):
        pre = _pipeline(workers=3, queue_depth=4)
        _fit(pre, iterations=5)
        assert pre._live is None
        assert _prefetch_threads() == []

    def test_reorder_buffer_bounded_under_slow_consumer(self):
        pre = _pipeline(n=960, batch=32, workers=4, queue_depth=2)
        it = pre.data(train=True)
        next(it)                      # start the pipeline, then stall
        time.sleep(1.0)
        live = pre._live
        assert len(live._ready) <= live._window + 4, len(live._ready)
        assert live._out.qsize() <= 2
        pre.shutdown()
        assert _prefetch_threads() == []

    def test_queue_stats_live_and_retired(self):
        pre = _pipeline(workers=2, queue_depth=3)
        assert pre.queue_stats() is None
        it = pre.data(train=True)
        next(it)
        depth, cap = pre.queue_stats()
        assert cap == 3 and 0 <= depth <= 3
        pre.shutdown()
        assert pre.queue_stats() is None

    def test_queue_occupancy_reaches_the_step_events(self):
        events = []

        class _Events(_Losses):
            def add_step_event(self, event):
                events.append(event)

        opt = optim.Optimizer(_model(), _pipeline(workers=2, queue_depth=3),
                              nn.CrossEntropyCriterion(),
                              optim.SGD(learning_rate=0.1), device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(3))
        opt.set_train_summary(_Events())
        opt.optimize()
        assert len(events) == 3
        assert all(e["queue_capacity"] == 3 for e in events)
        assert all(0 <= e["queue_depth"] <= 3 for e in events)

    def test_zero_workers_is_synchronous_passthrough(self):
        assert not isinstance(_pipeline(workers=0), PrefetchDataSet)
        pre = PrefetchDataSet(_pipeline(), num_workers=0)
        assert next(pre.data(train=True)).size() == 32
        assert _prefetch_threads() == []

    def test_eval_stream_stays_synchronous(self):
        pre = _pipeline(workers=2)
        assert len(list(pre.data(train=False))) == 3
        assert _prefetch_threads() == []

    def test_bad_knobs_raise(self):
        with pytest.raises(ValueError, match="num_workers"):
            PrefetchDataSet(_pipeline(), num_workers=-1)
        with pytest.raises(ValueError, match="queue_depth"):
            PrefetchDataSet(_pipeline(), queue_depth=0)


def test_resume_through_the_prefetch_pipeline(tmp_path):
    """3 batches an epoch; a checkpoint at neval 5 (after step 4, mid
    epoch 2, workers in flight), resumed by a fresh model (other weights)
    through a fresh pipeline to step 8: every loss and parameter is the
    straight run's."""
    m1 = _model()
    _, straight = _fit(_pipeline(workers=2, queue_depth=2), model=m1)
    _, first = _fit(_pipeline(workers=2, queue_depth=2), iterations=5,
                    ckpt=tmp_path, every=5)
    m2 = _model()
    with torch.no_grad():
        for p in m2.parameters():
            p.mul_(0.5)
    opt2, second = _fit(_pipeline(workers=2, queue_depth=2), model=m2,
                        ckpt=tmp_path, resume=True)
    # checkpoint.5 holds the state after step 4: step 5 runs again
    assert len(first) == 5 and len(second) == 4
    np.testing.assert_allclose(first[:4] + second, straight, rtol=1e-6)
    for pa, pb in zip(m1.parameters(), m2.parameters()):
        assert ((pb - pa).norm() / pa.norm()).item() <= 1e-5
    assert opt2.driver_state["neval"] == 9
    assert _prefetch_threads() == []


@pytest.mark.parametrize("recipe", [
    ["lenet-train", "--synthN", "64", "-b", "16"],
    ["resnet-train", "--depth", "8", "--synthN", "24", "-b", "6"],
    ["transformer-train", "--synthN", "16", "-b", "4", "--vocab", "64",
     "--seq-len", "16"]])
def test_recipes_take_num_workers_and_queue_depth(recipe):
    """``--numWorkers 2 --queueDepth 3`` wraps the training set in a
    ``PrefetchDataSet`` (JAX ``_build_optimizer`` :62-68) and the run sees
    the synchronous run's batches: equal losses, no thread left."""
    steps = ["--maxIteration", "3", "--device", "cpu"]
    sync = trun.main(recipe + steps)
    pre = trun.main(recipe + steps + ["--numWorkers", "2",
                                      "--queueDepth", "3"])
    assert isinstance(pre.dataset, PrefetchDataSet)
    assert (pre.dataset.num_workers, pre.dataset.queue_depth) == (2, 3)
    assert not isinstance(sync.dataset, PrefetchDataSet)
    assert pre.driver_state["neval"] == 4
    assert pre.driver_state["loss"] == sync.driver_state["loss"]
    assert _prefetch_threads() == []
