"""Validation in the port (``bigdl_tpu_torch/optim/validation.py``,
``local_optimizer.validate``, ``set_validation`` with a ``Plateau``
schedule's feed) against the JAX package's, on the CPU, and the compiled
eval step's CUDA graphs on the card.

CPU:

- every validation method against JAX's on the same numpy arrays: 2-D
  and 3-D outputs, (N, 1) and one-hot targets, tied scores (JAX's stable
  ascending argsort: Top5 and HitRatio take its last k, NDCG reverses
  it), the Top1 count over B * T divided by B on 3-D outputs (counts
  exact, sums 1e-6 relative);
- ``set_validation`` with ``Plateau`` through ``Optimizer`` on the
  "tiny" TransformerLM (vocab 256, seq 64, JAX's weights): the driver
  state after each validation and the ``lr_factor`` sequence against
  JAX's ``LocalOptimizer`` (1e-5); ``_check_plateau_monitor``'s refusal
  before any step; the epoch accounting of JAX's
  ``tests/test_training.py:57``; the point sync a validation forces
  under ``set_sync_every``.

Card (``cuda`` marker, skipped without one): the compiled eval step's
replays against the eager eval step (1e-6), one graph per input shape
and the bound's warning, the eval graph after k training steps equal to
an eager eval of step k's weights (fp32 and bf16), and a failed eval
capture raising.  The JAX package is imported by the CPU tests only:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_validation.py
"""

import logging

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import dataset as tds
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.ops import cross_entropy as ce
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.utils import cuda_graphs

VOCAB, SEQ = 256, 64


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads a test: workers running these tests side by side
    would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Validation methods against JAX's
# --------------------------------------------------------------------------- #

def _scores(rng, shape, tied):
    if tied:   # a handful of values: ties everywhere
        return rng.integers(0, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _case(name, rng):
    """``(method factory taking the package's optim and nn, output,
    target)`` for one case of the parametrised test."""
    n, c = 12, 9
    labels = rng.integers(0, c, (n,))
    onehot = np.eye(c, dtype=np.float32)[labels]
    out2 = _scores(rng, (n, c), False)
    out3 = rng.standard_normal((3, 5, c)).astype(np.float32)
    lab3 = rng.integers(0, c, (3, 5))
    tied = _scores(rng, (n, c), True)
    tree = rng.standard_normal((4, 6, c)).astype(np.float32)
    tree_lab = rng.integers(0, c, (4, 6))
    cases = {
        "top1-2d": (lambda o, m: o.Top1Accuracy(), out2, labels),
        "top1-column": (lambda o, m: o.Top1Accuracy(), out2, labels[:, None]),
        "top1-onehot": (lambda o, m: o.Top1Accuracy(), out2, onehot),
        "top1-3d-counts-tokens-over-batch":
            (lambda o, m: o.Top1Accuracy(), out3, lab3),
        "top1-tied": (lambda o, m: o.Top1Accuracy(), tied, labels),
        "top5-2d": (lambda o, m: o.Top5Accuracy(), out2, labels),
        "top5-column": (lambda o, m: o.Top5Accuracy(), out2, labels[:, None]),
        "top5-onehot": (lambda o, m: o.Top5Accuracy(), out2, onehot),
        "top5-3d": (lambda o, m: o.Top5Accuracy(), out3, lab3),
        "top5-tied": (lambda o, m: o.Top5Accuracy(), tied, labels),
        "loss-cross-entropy":
            (lambda o, m: o.Loss(m.CrossEntropyCriterion()), out2, labels),
        "loss-time-distributed-3d": (lambda o, m: o.Loss(
            m.TimeDistributedCriterion(m.FusedSoftmaxCrossEntropyCriterion())),
            out3, lab3),
        "mae": (lambda o, m: o.MAE(), out2,
                rng.standard_normal((n, c)).astype(np.float32)),
        "hit-ratio": (lambda o, m: o.HitRatio(k=3), out2, labels),
        "hit-ratio-tied": (lambda o, m: o.HitRatio(k=3), tied, labels),
        "ndcg": (lambda o, m: o.NDCG(k=4), out2, labels),
        "ndcg-tied": (lambda o, m: o.NDCG(k=4), tied, labels),
        "tree-root-0": (lambda o, m: o.TreeNNAccuracy(), tree, tree_lab),
        "tree-root-2": (lambda o, m: o.TreeNNAccuracy(root_index=2), tree,
                        tree_lab),
        "tree-root-labels": (lambda o, m: o.TreeNNAccuracy(), tree,
                             tree_lab[:, 0]),
        "tree-binary": (lambda o, m: o.TreeNNAccuracy(),
                        rng.random((4, 6, 1)).astype(np.float32),
                        rng.integers(0, 2, (4, 6))),
    }
    return cases[name]


CASES = ["top1-2d", "top1-column", "top1-onehot",
         "top1-3d-counts-tokens-over-batch", "top1-tied", "top5-2d",
         "top5-column", "top5-onehot", "top5-3d", "top5-tied",
         "loss-cross-entropy", "loss-time-distributed-3d", "mae",
         "hit-ratio", "hit-ratio-tied", "ndcg", "ndcg-tied", "tree-root-0",
         "tree-root-2", "tree-root-labels", "tree-binary"]


@pytest.mark.parametrize("name", CASES)
def test_validation_method_matches_jax(name):
    """The port's method on torch tensors against JAX's on the same
    arrays: the numerator and denominator of the batch result (counts
    exactly, sums to 1e-6 relative), merged results too."""
    import jax.numpy as jnp

    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim

    rng = np.random.default_rng(CASES.index(name))
    make, out, target = _case(name, rng)
    want = make(joptim, jnn)(jnp.asarray(out), jnp.asarray(target))
    got = make(optim, nn)(torch.from_numpy(out), torch.from_numpy(target))
    assert got.fmt == want.fmt
    np.testing.assert_allclose(got.numerator, want.numerator, rtol=1e-6)
    assert got.denominator == want.denominator
    merged, jmerged = got + got, want + want
    assert merged.result()[1] == jmerged.result()[1]
    np.testing.assert_allclose(merged.result()[0], jmerged.result()[0],
                               rtol=1e-6)
    if name == "top1-3d-counts-tokens-over-batch":
        # tokens over sequences, as the reference counts: may pass 1
        assert got.denominator == out.shape[0]


def test_tied_scores_follow_the_stable_ascending_sort():
    """Equal scores: Top5 and HitRatio hold the LAST k indices of the
    stable ascending order (the highest indices among ties), NDCG ranks
    the highest index first."""
    out = torch.zeros(1, 8)
    assert optim.HitRatio(k=3)(out, torch.tensor([7])).numerator == 1.0
    assert optim.HitRatio(k=3)(out, torch.tensor([4])).numerator == 0.0
    assert optim.Top5Accuracy()(out, torch.tensor([3])).numerator == 1.0
    assert optim.Top5Accuracy()(out, torch.tensor([2])).numerator == 0.0
    assert optim.NDCG(k=2)(out, torch.tensor([7])).numerator == 1.0
    np.testing.assert_allclose(
        optim.NDCG(k=2)(out, torch.tensor([6])).numerator, 1 / np.log2(3))


# --------------------------------------------------------------------------- #
# set_validation, Plateau's feed and the epoch accounting against JAX
# --------------------------------------------------------------------------- #

def _tiny_pair(seed=0):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.nn.attention import TransformerLM as JaxLM
    from bigdl_tpu_torch.interop import load_jax_params

    jm = JaxLM(VOCAB, 256, 4, 4, max_len=SEQ)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32),
             rng=jax.random.PRNGKey(seed))
    tm = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _corpus(n, seed=3):
    from bigdl_tpu_torch.models import synthetic_corpus

    return synthetic_corpus(n, SEQ, VOCAB, seed=seed)


def _datasets(pkg_dataset, x, y, batch, xv, yv):
    train = pkg_dataset.array_dataset(x, y) >> \
        pkg_dataset.SampleToMiniBatch(batch)
    val = pkg_dataset.array_dataset(xv, yv, shuffle_on_epoch=False) >> \
        pkg_dataset.SampleToMiniBatch(batch, drop_remainder=False)
    return train, val


def _methods(o, m):
    return [o.Loss(m.TimeDistributedCriterion(
        m.FusedSoftmaxCrossEntropyCriterion())), o.Top1Accuracy(),
        o.Top5Accuracy()]


def _plateau_run(o, m, pkg_dataset, model, steps, sync_every=1,
                 device=None):
    """SGD under a Plateau that reduces at every non-improving
    validation; validation every 2 iterations.  Returns the optimizer
    and, per validation, the driver state's values and the factor
    after the feed."""
    x, y = _corpus(16)
    xv, yv = _corpus(6, seed=4)
    train, val = _datasets(pkg_dataset, x, y, 4, xv, yv)
    sched = o.Plateau(monitor="Loss", mode="max", patience=0, factor=0.5)
    kw = {} if device is None else {"device": device}
    opt = o.Optimizer(model, train, m.TimeDistributedCriterion(
        m.FusedSoftmaxCrossEntropyCriterion()),
        o.SGD(learning_rate=0.05, momentum=0.9,
              learning_rate_schedule=sched), **kw)
    opt.set_end_when(o.Trigger.max_iteration(steps))
    opt.set_validation(o.Trigger.several_iteration(2), val, _methods(o, m))
    if sync_every != 1:
        opt.set_sync_every(sync_every)
    feeds = []
    feed = opt._feed_plateau

    def fed(state, opt_state):
        out = feed(state, opt_state)
        feeds.append(({k: state[k] for k in ("neval", "epoch", "record_count",
                                             "batches_consumed", "loss",
                                             "Loss", "Top1Accuracy",
                                             "Top5Accuracy", "score")},
                      float(out["lr_factor"])))
        return out

    opt._feed_plateau = fed
    opt.optimize()
    return opt, feeds


def test_plateau_fed_by_validation_matches_jax():
    """8 steps (4 an epoch), validation every 2: each validation's
    driver state (counters exact; the training loss, the validation Loss
    and the accuracies to 1e-5) and the ``lr_factor`` after each feed
    equal JAX's ``LocalOptimizer``'s; the factor halves at each
    non-improving (here: falling, mode "max") Loss."""
    from bigdl_tpu import dataset as jds
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim

    jm, tm = _tiny_pair()
    jopt, jfeeds = _plateau_run(joptim, jnn, jds, jm, 8)
    topt, tfeeds = _plateau_run(optim, nn, tds, tm, 8, device="cpu")
    assert len(tfeeds) == len(jfeeds) == 4
    for (ts, tf), (js, jf) in zip(tfeeds, jfeeds):
        for k in ("neval", "epoch", "record_count", "batches_consumed"):
            assert ts[k] == js[k], k
        for k in ("loss", "Loss", "Top1Accuracy", "Top5Accuracy", "score"):
            np.testing.assert_allclose(ts[k], float(js[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(tf, jf, rtol=1e-6)
    assert [f for _, f in tfeeds] != [1.0] * 4     # the feed did reduce
    for k in ("epoch", "neval", "record_count", "batches_consumed"):
        assert topt.driver_state[k] == jopt.driver_state[k], k


def test_validation_forces_a_point_sync():
    """Under ``set_sync_every(3)`` a validation at a deferred step reads a
    fresh loss first, so the driver state's loss at each validation is
    the one the per-step sync would give (losses of consecutive steps
    differ by 1e-3 here)."""
    _, tm1 = _tiny_pair()
    _, tm3 = _tiny_pair()
    _, f1 = _plateau_run(optim, nn, tds, tm1, 6, device="cpu")
    _, f3 = _plateau_run(optim, nn, tds, tm3, 6, sync_every=3, device="cpu")
    # the CPU's GEMMs may round two runs of one step apart (1e-7)
    np.testing.assert_allclose([s["loss"] for s, _ in f3],
                               [s["loss"] for s, _ in f1], rtol=1e-6)


def test_plateau_monitor_refused_before_any_step():
    """A Plateau monitoring a value no validation method produces raises
    at ``optimize()`` before a step runs (the retry loop would replay
    it)."""
    tm = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu")
    x, y = _corpus(8)
    train, val = _datasets(tds, x, y, 4, x, y)
    opt = optim.Optimizer(
        tm, train, nn.TimeDistributedCriterion(nn.CrossEntropyCriterion()),
        optim.SGD(learning_rate=0.1, learning_rate_schedule=optim.Plateau(
            monitor="Top1Accuracy")), device="cpu")
    opt.set_validation(optim.Trigger.every_epoch(), val,
                       [optim.Loss(nn.CrossEntropyCriterion())])
    before = {k: p.detach().clone() for k, p in tm.named_parameters()}
    with pytest.raises(ValueError, match="Top1Accuracy"):
        opt.optimize()
    assert opt.driver_state["neval"] == 1
    for k, p in tm.named_parameters():
        assert torch.equal(p, before[k]), k


def test_validation_and_epoch_accounting():
    """JAX ``tests/test_training.py:57`` on the port: 2 epochs of 16
    records at batch 4 with validation at every epoch end: epoch 3,
    neval 9, and two validations recorded."""
    tm = transformer_lm("tiny", VOCAB, max_len=SEQ, device="cpu")
    x, y = _corpus(16)
    train, val = _datasets(tds, x, y, 4, x[:8], y[:8])
    opt = optim.Optimizer(
        tm, train, nn.TimeDistributedCriterion(nn.CrossEntropyCriterion()),
        optim.SGD(learning_rate=0.2, momentum=0.9, dampening=0.0),
        device="cpu")
    opt.set_end_when(optim.Trigger.max_epoch(2))
    seen = []

    class _Summary:
        def add_scalar(self, tag, value, step):
            seen.append((tag, step))

    opt.set_validation(optim.Trigger.every_epoch(), val,
                       [optim.Top1Accuracy()])
    opt.set_validation_summary(_Summary())
    opt.optimize()
    assert opt.driver_state["epoch"] == 3
    assert opt.driver_state["neval"] == 9
    assert seen == [("Top1Accuracy", 5), ("Top1Accuracy", 9)]
    assert "Top1Accuracy" in opt.driver_state and \
        opt.driver_state["score"] == opt.driver_state["Top1Accuracy"]


# --------------------------------------------------------------------------- #
# The compiled eval step on the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_model(cuda, seed=0):
    return nn.TransformerLM(512, 64, 4, 2, max_len=SEQ, device=cuda,
                            seed=seed)


def _tokens(n, t=SEQ, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (n, t)).astype(np.int32)


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_eval_replays_match_eager_and_count_launches(cuda):
    """Replays of the compiled eval step against the eager eval step on
    the same weights (1e-6 relative L2), fp32 and bf16, with K1 counted
    through every replay (2 layers a call) and nothing built after a
    shape's first call."""
    model = _card_model(cuda)
    for dtype in (None, torch.bfloat16):
        step = optim.compiled_eval_step(model, dtype)
        eager = optim.make_eval_step(model, dtype)
        xs = [torch.as_tensor(_tokens(4, seed=s), device=cuda)
              for s in range(3)]
        want = [eager(x) for x in xs]
        step(xs[0])
        fa.reset_launch_counts()
        before = cuda_graphs.capture_count()
        for x, w in zip(xs, want):
            assert _rel_l2(step(x), w) <= 1e-6, dtype
        torch.cuda.synchronize()
        assert cuda_graphs.capture_count() == before
        assert fa.LAUNCHES["flash_attention"] == 2 * len(xs)
        assert step.stats()["pool_bytes"] > 0


@pytest.mark.cuda
def test_one_graph_per_shape_and_the_bound_warns(cuda, caplog):
    """Each new input shape captures one graph, a repeated shape none; a
    step past its bound warns once per new shape and evicts nothing;
    ``precompile`` returns the graphs it built (0 when warm)."""
    model = _card_model(cuda)
    step = optim.CompiledEvalStep(model, max_executables=2)
    assert step.precompile(np.zeros(SEQ, np.int32), [1, 2]) == 2
    assert step.precompile(np.zeros(SEQ, np.int32), [1, 2]) == 0
    with caplog.at_level(logging.WARNING, "bigdl_tpu_torch.optim"):
        step(torch.zeros(3, SEQ, dtype=torch.int32, device=cuda))
        step(torch.zeros(3, SEQ, dtype=torch.int32, device=cuda))
    warned = [r for r in caplog.records if "bound 2" in r.message]
    assert len(warned) == 1
    assert step.executables() == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_eval_graph_sees_the_trained_weights(cuda, dtype):
    """An eval graph captured before training, replayed after k steps of
    the compiled training step: equal (1e-6) to an eager eval of the
    weights those steps left (the bf16 casts of the masters lie inside
    the graph)."""
    model = _card_model(cuda)
    x, y = _tokens(16), _tokens(16, seed=2)
    xb = torch.as_tensor(x[:4], device=cuda)
    step = optim.compiled_eval_step(model, dtype)
    first = step(xb).clone()
    ds = array_dataset(x, y) >> SampleToMiniBatch(4)
    opt = optim.Optimizer(model, ds, nn.TimeDistributedCriterion(
        nn.FusedSoftmaxCrossEntropyCriterion()),
        optim.Adam(learning_rate=1e-2))
    if dtype is not None:
        opt.set_compute_dtype(dtype)
    opt.set_end_when(optim.Trigger.max_iteration(3))
    opt.optimize()
    after = step(xb).clone()
    assert _rel_l2(after, first) > 1e-3          # the weights moved
    assert _rel_l2(after, optim.make_eval_step(model, dtype)(xb)) <= 1e-6


@pytest.mark.cuda
def test_a_failed_eval_capture_raises(cuda):
    """A forward that reads the card from the host fails its capture:
    the call raises, nothing is evaluated eagerly in its place and no
    graph is kept; without it the same shape captures."""
    model = _card_model(cuda)
    hook = model.register_forward_hook(
        lambda m, i, o: float(o.sum().item()))
    step = optim.CompiledEvalStep(model)
    x = torch.as_tensor(_tokens(4), device=cuda)
    with pytest.raises(RuntimeError):
        step(x)
    assert step.executables() == 0
    hook.remove()
    ce.reset_launch_counts()
    assert _rel_l2(step(x), optim.make_eval_step(model)(x)) <= 1e-6
    assert step.executables() == 1
