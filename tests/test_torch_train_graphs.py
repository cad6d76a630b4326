"""The compiled training step (``bigdl_tpu_torch/optim/graphs.py``,
``CompiledTrainStep``) and ``LocalOptimizer``'s loop through it, on the
CPU and, as CUDA graphs, on the card.

CPU (tiny TransformerLM, vocab 512, hidden 32, 4 heads, 2 layers):

- the compiled step's CPU path runs the eager step on its static
  buffers: losses and parameters equal the eager step's exactly (fp32
  and bf16 ``compute_dtype``; Adam, ``Fused(Adam)``; clipping, a
  ``grad_transform``, a frozen block);
- one key per batch shape: a second only for an epoch's short last
  batch; each ``optimize()`` builds its step anew, so a block frozen, a
  regularizer set or a rate changed between two calls takes effect;
- ``SGD(momentum=0.9)`` under ``SequentialSchedule(Warmup, Poly)``
  through ``LocalOptimizer``: losses and ``LearningRate`` scalars against
  JAX's ``LocalOptimizer`` (1e-5; the rates 1e-6).

Card (``cuda`` marker, skipped without one): compiled against eager steps
from the same weights (fp32, bf16; Adam, ``Fused(Adam)``), launch counts
through replays (the backward's too), no capture after a shape's first
step, a failed capture raising and leaving later captures working, and
the warm-up leaving the run's losses unchanged.  The JAX package is
imported by the CPU tests' fixtures only, so the card tests run on a
machine without JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_train_graphs.py
"""

import types

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import (MiniBatch, SampleToMiniBatch,
                                     array_dataset)
from bigdl_tpu_torch.ops import cross_entropy as ce
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.utils import cuda_graphs

VOCAB, HIDDEN, HEADS, LAYERS, SEQ = 512, 32, 4, 2, 16


def _model(device="cpu", seed=0, hidden=HIDDEN):
    return nn.TransformerLM(VOCAB, hidden, HEADS, LAYERS, max_len=SEQ,
                            device=device, seed=seed)


def _crit():
    return nn.TimeDistributedCriterion(nn.FusedSoftmaxCrossEntropyCriterion())


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32),
            rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32))


class _Summary:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append(float(value))


def _freeze_block0(m):
    m.block0.freeze()
    return m


#: make_train_step options of the CPU equality cases
OPTIONS = {
    "fp32-adam": dict(method=lambda: optim.Adam(learning_rate=1e-2)),
    "bf16-adam": dict(method=lambda: optim.Adam(learning_rate=1e-2),
                      compute_dtype=torch.bfloat16),
    "fused-adam-clipped": dict(
        method=lambda: optim.Fused(optim.Adam(learning_rate=1e-2)),
        clip_value=(-0.5, 0.5), clip_norm=1.0),
    "sgd-transform-frozen": dict(
        method=lambda: optim.SGD(learning_rate=0.5, momentum=0.9,
                                 learning_rate_schedule=optim.Step(2, 0.5)),
        grad_transform=lambda g: {k: v * 0.5 for k, v in g.items()},
        prepare=_freeze_block0),
}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_cpu_compiled_step_equals_the_eager_step(case):
    kw = dict(OPTIONS[case])
    make_method = kw.pop("method")
    prepare = kw.pop("prepare", lambda m: m)
    x, y = _data(8)
    ma, mb = prepare(_model()), prepare(_model())
    meth_a, meth_b = make_method(), make_method()
    sa = meth_a.init_state(dict(ma.named_parameters()))
    sb = meth_b.init_state(dict(mb.named_parameters()))
    eager = optim.make_train_step(ma, _crit(), meth_a, **kw)
    compiled = optim.CompiledTrainStep(mb, _crit(), meth_b, sb, "cpu", **kw)
    before = cuda_graphs.capture_count()
    for i in range(4):
        xb = torch.from_numpy(x[2 * i:2 * i + 2])
        yb = torch.from_numpy(y[2 * i:2 * i + 2])
        _, want = eager(sa, xb, yb)
        got = compiled.run(xb, yb)
        assert torch.equal(got, want), i
    for (k, pa), (_, pb) in zip(ma.named_parameters(), mb.named_parameters()):
        assert torch.equal(pa, pb), k
    assert int(sb["neval"]) == 4
    assert compiled.stats()["captured"] == 1
    assert compiled.stats()["replays"] == 4
    assert cuda_graphs.capture_count() - before == 1


def _optimizer(model, n, batch, method, end, device="cpu"):
    opt = optim.Optimizer(model, array_dataset(*_data(n))
                          >> SampleToMiniBatch(batch), _crit(), method,
                          device=device)
    opt.set_end_when(end)
    return opt


class _ShortLastBatch:
    """10 records an epoch, read as a finite iterator of batches of 4, 4
    and a short 2 (as a file-backed dataset without ``drop_remainder``
    gives them)."""

    def __init__(self):
        self.x, self.y = _data(10)

    def size(self):
        return 10

    def shuffle(self):
        pass

    def data(self, train=True):
        return iter([MiniBatch(self.x[i:i + 4], self.y[i:i + 4])
                     for i in (0, 4, 8)])


def test_cpu_one_key_per_batch_shape():
    """Full batches build one key; the epoch's short last batch a second.
    Each ``optimize()`` builds its step anew (JAX jits a fresh
    ``make_train_step`` in each), so its stats count its own keys."""
    model = _model()
    opt = optim.Optimizer(model, _ShortLastBatch(), _crit(),
                          optim.Adam(learning_rate=1e-2), device="cpu")
    opt.set_end_when(optim.Trigger.max_iteration(2))
    opt.optimize()
    stats = opt.compiled_stats
    assert stats["captured"] == 1 and stats["replays"] == 2
    assert [k[0] for k in stats["keys"]] == [(4, SEQ)]
    assert stats["keys"][0][1] == torch.int32
    opt.set_end_when(optim.Trigger.max_epoch(2))
    opt.optimize()
    stats = opt.compiled_stats
    assert [k[0] for k in stats["keys"]] == [(4, SEQ), (2, SEQ)]
    assert stats["captured"] == 2
    assert opt.driver_state["neval"] - 1 == 6
    assert stats["replays"] == 4
    opt.optim_method.state = None
    opt.set_end_when(optim.Trigger.max_epoch(3))
    opt.optimize()
    assert opt.compiled_stats["captured"] == 2


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("change", ["freeze", "regularizer",
                                    "learning_rate"])
def test_cpu_each_optimize_reads_the_model_anew(change):
    """What the step reads when it is built changes between two
    ``optimize()`` calls, and the second call trains with the change: a
    block frozen after the first call stays bit-identical through the
    second; a regularizer set after it moves the parameters away from an
    unregularized twin trained the same way; a learning rate of 0 set
    after it leaves every parameter as it was."""
    runs = {}
    for label in ("changed", "twin"):
        model = _model()
        opt = _optimizer(model, 16, 2, optim.Adam(learning_rate=1e-2),
                         optim.Trigger.max_iteration(2))
        opt.optimize()
        after_first = _params(model)
        if label == "changed":
            if change == "freeze":
                model.block0.freeze()
            elif change == "regularizer":
                model.block0.fc1.set_regularizer(
                    w=optim.L2Regularizer(10.0))
            else:
                opt.optim_method.learning_rate = 0.0
        opt.set_end_when(optim.Trigger.max_iteration(4))
        opt.optimize()
        runs[label] = (after_first, _params(model))
    first, second = runs["changed"]
    twin_first, twin_second = runs["twin"]
    for k in first:
        assert torch.equal(first[k], twin_first[k]), k
    if change == "freeze":
        for k in first:
            assert torch.equal(second[k], first[k]) == \
                k.startswith("block0."), k
    elif change == "regularizer":
        assert not torch.equal(second["block0.fc1.weight"],
                               twin_second["block0.fc1.weight"])
    else:
        for k in first:
            assert torch.equal(second[k], first[k]), k
            assert not torch.equal(twin_second[k], first[k]), k


def test_cpu_recipe_takes_sync_every():
    """``models/run.py transformer-train --syncEvery 2`` trains through the
    compiled step, reading the loss every second step."""
    from bigdl_tpu_torch.models import run

    opt = run.main(["transformer-train", "--device", "cpu", "--size", "tiny",
                    "--vocab", "512", "--seq-len", "16", "-b", "4",
                    "--maxIteration", "3", "--synthN", "32",
                    "--syncEvery", "2"])
    assert opt.sync_every == 2 and opt.driver_state["neval"] == 4
    assert opt.compiled_stats["replays"] == 3
    assert np.isfinite(opt.driver_state["loss"])


@pytest.fixture(scope="module")
def jx():
    """JAX and the JAX package's training path (the CPU tests' oracle)."""
    jax = pytest.importorskip("jax")
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
    from bigdl_tpu.dataset import array_dataset as jax_array_dataset
    from bigdl_tpu.nn.attention import TransformerLM
    from bigdl_tpu.optim import LocalOptimizer, Trigger
    from bigdl_tpu.optim import optim_method

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, nn=jnn, LM=TransformerLM,
        ToMiniBatch=JaxToMiniBatch, array_dataset=jax_array_dataset,
        LocalOptimizer=LocalOptimizer, Trigger=Trigger, om=optim_method)


def _warmup_poly(mod):
    return mod.SequentialSchedule().add(mod.Warmup(0.05), 3) \
        .add(mod.Poly(2.0, 20), 100)


def test_cpu_scheduled_sgd_matches_jax_local_optimizer(jx):
    """The smoke run's scheduled leg at a tiny size: ``SGD(momentum=0.9)``
    under ``SequentialSchedule(Warmup, Poly)``, 6 steps."""
    from bigdl_tpu_torch.interop import load_jax_params

    jm = jx.LM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=SEQ)
    jm.build(jx.jax.ShapeDtypeStruct((2, SEQ), jx.jnp.int32),
             rng=jx.jax.random.PRNGKey(2))
    tm = _model()
    load_jax_params(tm, jx.jax.tree.map(np.asarray, jm.parameters()[0]))
    jopt = jx.LocalOptimizer(
        jm, jx.array_dataset(*_data(16)) >> jx.ToMiniBatch(2),
        jx.nn.TimeDistributedCriterion(
            jx.nn.FusedSoftmaxCrossEntropyCriterion()),
        jx.om.SGD(learning_rate=0.1, momentum=0.9,
                  learning_rate_schedule=_warmup_poly(jx.om)))
    jopt.set_end_when(jx.Trigger.max_iteration(6))
    js = _Summary()
    jopt.set_train_summary(js)
    jopt.optimize()
    topt = _optimizer(tm, 16, 2, optim.SGD(
        learning_rate=0.1, momentum=0.9,
        learning_rate_schedule=_warmup_poly(optim)),
        optim.Trigger.max_iteration(6))
    ts = _Summary()
    topt.set_train_summary(ts)
    topt.optimize()
    np.testing.assert_allclose(ts.scalars["Loss"], js.scalars["Loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(ts.scalars["LearningRate"],
                               js.scalars["LearningRate"], rtol=1e-6)
    want = [0.1 + 0.05 * min(s, 3) if s < 3 else
            0.1 * (1 - min(s - 3, 100) / 20) ** 2 for s in range(1, 7)]
    np.testing.assert_allclose(ts.scalars["LearningRate"], want, rtol=1e-6)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_compiled_matches_eager_on_the_card(cuda):
    """4 steps of the same batches from the same weights, eager and
    compiled: per-step losses within 1e-6 relative (bf16 1e-5), the
    parameters after them within the same relative L2.  The warm-up runs
    on saved copies: step 1's loss and neval match eager's, not a
    third step's."""
    x, y = _data(8)
    cases = [(None, lambda: optim.Adam(learning_rate=1e-3), 1e-6),
             (torch.bfloat16, lambda: optim.Adam(learning_rate=1e-3), 1e-5),
             (None, lambda: optim.Fused(optim.Adam(learning_rate=1e-3)),
              1e-6),
             (torch.bfloat16,
              lambda: optim.Fused(optim.Adam(learning_rate=1e-3)), 1e-5)]
    for dtype, make, tol in cases:
        ma, mb = _model(cuda, hidden=64), _model(cuda, hidden=64)
        meth_a, meth_b = make(), make()
        sa = meth_a.init_state(dict(ma.named_parameters()))
        sb = meth_b.init_state(dict(mb.named_parameters()))
        eager = optim.make_train_step(ma, _crit(), meth_a,
                                      compute_dtype=dtype)
        compiled = optim.CompiledTrainStep(mb, _crit(), meth_b, sb, cuda,
                                           compute_dtype=dtype)
        for i in range(4):
            xb = torch.as_tensor(x[2 * i:2 * i + 2], device=cuda)
            yb = torch.as_tensor(y[2 * i:2 * i + 2], device=cuda)
            want = eager(sa, xb, yb)[1].item()
            got = compiled.run(xb, yb).item()
            assert _rel(got, want) <= tol, (dtype, i, got, want)
            assert int(sb["neval"]) == i + 1
        for (k, pa), (_, pb) in zip(ma.named_parameters(),
                                    mb.named_parameters()):
            assert _rel_l2(pb, pa) <= tol, (dtype, k)
        assert compiled.stats()["captured"] == 1


@pytest.mark.cuda
def test_launch_counts_through_replays_and_no_recapture(cuda):
    """8 steps through ``Optimizer``: K1 and K1-bwd (whose launches the
    autograd engine's own thread makes) LAYERS a step, K4 and K5 one a
    step, all counted through replays; one capture, made at the first
    step, none after it; the graph pool holds device memory."""
    opt = _optimizer(_model(cuda, hidden=64), 16, 2,
                     optim.Adam(learning_rate=1e-3),
                     optim.Trigger.max_iteration(8), device=cuda)
    fa.reset_launch_counts()
    ce.reset_launch_counts()
    before = cuda_graphs.capture_count()
    opt.optimize()
    torch.cuda.synchronize()
    assert cuda_graphs.capture_count() - before == 1
    got = {**fa.LAUNCHES, **ce.LAUNCHES}
    want = {"flash_attention": 8 * LAYERS, "flash_attention_bwd": 8 * LAYERS,
            "fused_softmax_cross_entropy": 8,
            "fused_softmax_cross_entropy_bwd": 8}
    assert {k: got[k] for k in want} == want
    stats = opt.compiled_stats
    assert stats["captured"] == 1 and stats["replays"] == 8
    assert stats["pool_bytes"] > 0
    warm = stats["warmup_launches"]
    assert warm["flash_attention"]["flash_attention_bwd"] == \
        cuda_graphs.WARMUP_RUNS * LAYERS


@pytest.mark.cuda
def test_a_failed_capture_raises_and_later_captures_work(cuda):
    """A ``grad_transform`` that reads a gradient on the host (``.item()``)
    fails the capture: ``optimize()`` raises and nothing trains eagerly.
    The same optimizer without it captures and trains."""
    model = _model(cuda, hidden=64)
    opt = _optimizer(model, 8, 2, optim.Adam(learning_rate=1e-3),
                     optim.Trigger.max_iteration(2), device=cuda)

    def syncing(grads):
        float(next(iter(grads.values())).sum().item())
        return grads

    opt.set_grad_transform(syncing)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    with pytest.raises(RuntimeError):
        opt.optimize()
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k]), k
    assert opt.optim_method.state is None       # the run never finished
    opt.set_grad_transform(None)
    opt.optimize()
    assert opt.compiled_stats["captured"] == 1
    assert np.isfinite(opt.driver_state["loss"])


@pytest.mark.cuda
def test_warmup_leaves_the_runs_losses_unchanged(cuda):
    """Two ``Optimizer`` runs from the same weights, one through the
    compiled step and one whose every step is the eager step: the
    per-step losses agree to 1e-6 relative."""
    losses = {}
    for label in ("compiled", "eager"):
        model = _model(cuda, hidden=64)
        opt = _optimizer(model, 16, 2, optim.Adam(learning_rate=1e-2),
                         optim.Trigger.max_iteration(6), device=cuda)
        if label == "eager":
            eager = optim.make_train_step(model, _crit(), opt.optim_method)

            class _Eager:
                def __init__(self, state):
                    self.opt_state = state

                def run(self, x, y):
                    return eager(self.opt_state, x, y)[1]

                def stats(self):
                    return {}

            opt._compiled_step = lambda state: _Eager(state)
        summary = _Summary()
        opt.set_train_summary(summary)
        opt.optimize()
        losses[label] = summary.scalars["Loss"]
    assert len(losses["compiled"]) == 6
    for a, b in zip(losses["compiled"], losses["eager"]):
        assert _rel(a, b) <= 1e-6, losses
