"""Model state (BatchNorm's running statistics, the modules' buffers)
through the port's machinery, on the CPU: the compiled step
(``optim/graphs.py``), remat (``nn/containers.py``), the eval steps
(``optim/validation.py``, ``optim/train_step.compute_copy``),
checkpoints and resume (``optim/local_optimizer.py``,
``interop/jax_params.py``), ``Module.load_state_tree``, the TF32 guard
(``utils/device.py``) and the import guard.

- The compiled step's CPU path against the eager ``make_train_step`` on a
  twin from the same weights: losses, parameters and running statistics
  bitwise; ``CompiledTrainStep._live`` (what the card's warm-up saves and
  restores) holds the buffers.
- Remat: ``ResNet(18, remat=True)`` against the same model without remat,
  one SGD step: running statistics and parameters bitwise, and the
  statistics updated once (the recompute under ``frozen_state`` writes
  nothing), as JAX's remat (``tests/test_models.py:56``).
- bf16 and fp32 eval steps built before two training steps read the
  statistics after them: their output equals that of steps built after;
  a ``compute_copy`` twin shares the model's buffers.
- Checkpoints carry ``model_state`` in JAX's tree (``ResNetCifar(8)``,
  batch 8, SGD with momentum): a JAX one resumes in the port, whose
  parameters and statistics after two more steps lie within 1e-4
  (relative L2) of JAX's straight run; a port one loads into JAX bitwise
  and JAX's next two losses are the port's (1e-4); a port run resumed
  mid-epoch equals the straight run (1e-5), and so does a run whose
  retry loop restored the statistics from its own checkpoint.
- ``load_state_tree`` copies in place (the addresses stay) and checks
  keys and shapes.
- ``require_fp32_matmul`` switches off TF32 in cuDNN too.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import (load_jax_params, load_jax_state,
                                     to_jax_params, to_jax_state)
from bigdl_tpu_torch.models import run as trun
from bigdl_tpu_torch.optim.graphs import CompiledTrainStep
from bigdl_tpu_torch.optim.train_step import compute_copy

ROOT = Path(__file__).resolve().parents[1]
B = 4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _data(n=16, seed=11):
    return trun._synthetic_images(n, 32, 32, 3, 10, seed=seed)


def _batches(x, y):
    return [(torch.from_numpy(x[i:i + B]), torch.from_numpy(y[i:i + B]))
            for i in range(0, len(x), B)]


def _twin(model, build):
    twin = build()
    twin.load_parameters_tree(model.parameters_tree())
    twin.load_state_tree(model.state_tree())
    return twin


def _sgd():
    return optim.SGD(learning_rate=0.05, momentum=0.9, dampening=0.0,
                     weight_decay=1e-4, nesterov=True)


def _equal_models(a, b):
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k
    for (k, p), (_, q) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(p, q), k


def test_compiled_step_equals_the_eager_step_with_buffers():
    build = lambda: tmodels.ResNetCifar(8, device="cpu", seed=1)  # noqa
    model = build()
    twin = _twin(model, build)
    x, y = _data()
    crit = nn.CrossEntropyCriterion()
    sgd = _sgd()
    state = sgd.init_state(dict(model.named_parameters()))
    step = CompiledTrainStep(model, crit, sgd, state, "cpu")
    live = step._live()
    assert all(any(t is b for t in live) for b in model.buffers())
    sgd2 = _sgd()
    state2 = sgd2.init_state(dict(twin.named_parameters()))
    eager = optim.make_train_step(twin, crit, sgd2)
    before = model._modules["1"].running_mean.clone()
    for xb, yb in _batches(x, y):
        a = step.run(xb, yb).item()
        b = eager(state2, xb, yb)[1].item()
        assert a == b
    assert not torch.equal(before, model._modules["1"].running_mean)
    _equal_models(model, twin)
    assert step.stats()["captured"] == 1


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_remat_updates_the_statistics_once(policy):
    """One SGD step of ResNet-18 (10 classes, 32 x 32) with every residual
    block rematerialised, against the same weights without remat: the
    parameters and running statistics after it bitwise equal, and the
    statistics those of one training forward."""
    build = lambda remat: tmodels.ResNet(  # noqa: E731
        18, 10, remat=remat, remat_policy=policy if remat else None,
        device="cpu", seed=2)
    # one seed draws the same weights with and without the wrappers (the
    # remat tree has one more key level, "0", under each block)
    plain, rematted, once = build(False), build(True), build(False)
    assert isinstance(rematted._modules["4"], nn.Remat)
    _equal_models(plain, rematted)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    t = torch.tensor([1, 5, 3, 0])
    for m in (plain, rematted):
        sgd = optim.SGD(learning_rate=0.05, momentum=0.9)
        state = sgd.init_state(dict(m.named_parameters()))
        optim.make_train_step(m, nn.CrossEntropyCriterion(), sgd)(
            state, x, t)
    _equal_models(plain, rematted)
    with torch.no_grad():
        once.train()(x)
    for (k, a), (_, b) in zip(once.named_buffers(), rematted.named_buffers()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_eval_steps_read_the_current_statistics(dtype):
    """An eval step built before two training steps, and one built after
    them, give the same output after them: each reads the buffers as they
    are (JAX's eval step reads the current ``mstate``)."""
    build = lambda: tmodels.ResNetCifar(8, device="cpu", seed=3)  # noqa
    model = build()
    x, y = _data()
    early = optim.compiled_eval_step(model, dtype)
    xv = torch.from_numpy(x[:B])
    first = early(xv).clone()
    sgd = _sgd()
    state = sgd.init_state(dict(model.named_parameters()))
    step = optim.make_train_step(model, nn.CrossEntropyCriterion(), sgd,
                                 compute_dtype=dtype)
    for xb, yb in _batches(x, y)[:2]:
        step(state, xb, yb)
    late = optim.make_eval_step(model, dtype)(xv)
    again = early(xv)
    assert torch.equal(again, late)
    assert not torch.equal(first, again)
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_compute_copy_shares_the_buffers():
    model = tmodels.ResNetCifar(8, device="cpu", seed=3)
    twin = compute_copy(model, torch.bfloat16)
    for (k, a), (_, b) in zip(model.named_buffers(), twin.named_buffers()):
        assert a is b, k
    for (k, a), (_, b) in zip(model.named_parameters(),
                              twin.named_parameters()):
        assert a.data_ptr() != b.data_ptr(), k
    assert twin._modules["0"].weight.dtype == torch.bfloat16
    assert twin._modules["1"].weight.dtype == torch.float32
    x, y = _data()
    sgd = _sgd()
    state = sgd.init_state(dict(model.named_parameters()))
    optim.make_train_step(model, nn.CrossEntropyCriterion(), sgd)(
        state, torch.from_numpy(x[:B]), torch.from_numpy(y[:B]))
    assert torch.equal(twin._modules["1"].running_mean,
                       model._modules["1"].running_mean)


def test_load_state_tree_copies_in_place_and_checks():
    bn = nn.SpatialBatchNormalization(3)
    ptr = bn.running_mean.data_ptr()
    bn.load_state_tree({"running_mean": np.arange(3, dtype=np.float32),
                        "running_var": np.full(3, 2.0, np.float32)})
    assert bn.running_mean.data_ptr() == ptr
    assert torch.equal(bn.running_mean, torch.arange(3.0))
    with pytest.raises(KeyError, match="missing"):
        bn.load_state_tree({"running_mean": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        bn.load_state_tree({"running_mean": np.zeros(4, np.float32),
                            "running_var": np.ones(3, np.float32)})
    model = tmodels.ResNetCifar(8, device="cpu")
    tree = to_jax_state(model)
    assert tree["0"] == () and tree["2"] == ()
    ptrs = [b.data_ptr() for b in model.buffers()]
    load_jax_state(model, tree)
    assert ptrs == [b.data_ptr() for b in model.buffers()]
    nn.ReLU().load_state_tree(())


# --------------------------------------------------------------------------- #
# Checkpoints and resume
# --------------------------------------------------------------------------- #

class _Losses:
    def __init__(self):
        self.by_step = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.by_step[step] = value


#: the checkpoint runs: 6 batches of 8 an epoch, SGD with momentum
CK_B = 8
#: two steps of one package against two of the other, relative L2: the
#: packages' fp32 steps part by rounding that train-mode BatchNorm
#: amplifies (2.3e-5 measured on the first convolution's weight), as the
#: 4-step ``optimize()`` parity of ``test_torch_cnn_models.py`` holds
CROSS_TOL = 1e-4


def _ck_sgd(o):
    return o.SGD(learning_rate=0.01, momentum=0.9, dampening=0.0,
                 weight_decay=1e-4)


def _port_run(model, end, ckpt=None, every=100, resume=False):
    x, y = _data(6 * CK_B)
    opt = optim.Optimizer(model, array_dataset(x, y) >>
                          SampleToMiniBatch(CK_B),
                          nn.CrossEntropyCriterion(), _ck_sgd(optim),
                          device="cpu")
    losses = _Losses()
    opt.set_train_summary(losses)
    opt.set_end_when(optim.Trigger.max_iteration(end))
    if ckpt:
        opt.set_checkpoint(str(ckpt), optim.Trigger.several_iteration(every))
    if resume:
        opt.resume_from_checkpoint()
    opt.optimize()
    return opt, losses.by_step


def _close(a, b, tol):
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert ((p - q).norm() / q.norm().clamp_min(1e-12)).item() <= tol, k
    for (k, p), (_, q) in zip(a.named_buffers(), b.named_buffers()):
        assert ((p - q).norm() / q.norm().clamp_min(1e-12)).item() <= tol, k


def test_resume_mid_epoch_carries_the_statistics(tmp_path):
    """6 batches an epoch; a checkpoint at neval 4, a fresh model (other
    weights, init statistics) resumed from it to step 8: losses,
    parameters and statistics equal the straight run's (1e-5)."""
    from bigdl_tpu_torch.utils import file_io

    straight = tmodels.ResNetCifar(8, device="cpu", seed=1)
    _, want = _port_run(straight, 8)
    _port_run(tmodels.ResNetCifar(8, device="cpu", seed=1), 4, tmp_path, 4)
    snap = file_io.load(str(tmp_path / "checkpoint.4.pkl"))
    assert set(snap["model_state"]["1"]) == {"running_mean", "running_var"}
    resumed = tmodels.ResNetCifar(8, device="cpu", seed=6)
    ptrs = [b.data_ptr() for b in resumed.buffers()]
    opt, got = _port_run(resumed, 8, tmp_path, 100, resume=True)
    assert ptrs == [b.data_ptr() for b in resumed.buffers()]
    assert sorted(got) == [4, 5, 6, 7, 8]
    np.testing.assert_allclose([got[s] for s in got],
                               [want[s] for s in got], rtol=1e-5)
    _close(resumed, straight, 1e-5)


def test_retry_loop_restores_the_statistics(tmp_path):
    """The 6th batch's fetch raises once; ``optimize()`` restores the
    checkpoint at neval 5 (parameters, velocity and running statistics,
    in place) and finishes at the straight run's parameters and
    statistics (1e-5)."""
    from bigdl_tpu_torch.dataset.dataset import AbstractDataSet

    class FailOnce(AbstractDataSet):
        def __init__(self, base):
            self.base, self.fetched, self.failed = base, 0, False

        def size(self):
            return self.base.size()

        def shuffle(self):
            self.base.shuffle()

        def position_state(self):
            return self.base.position_state()

        def restore_position(self, state):
            self.base.restore_position(state)

        def data(self, train):
            for b in self.base.data(train):
                if train:
                    self.fetched += 1
                    if not self.failed and self.fetched == 6:
                        self.failed = True
                        raise RuntimeError("injected fault")
                yield b

    straight = tmodels.ResNetCifar(8, device="cpu", seed=1)
    _port_run(straight, 7)
    x, y = _data(6 * CK_B)
    model = tmodels.ResNetCifar(8, device="cpu", seed=1)
    flaky = FailOnce(array_dataset(x, y) >> SampleToMiniBatch(CK_B))
    opt = optim.Optimizer(model, flaky, nn.CrossEntropyCriterion(),
                          _ck_sgd(optim), device="cpu")
    opt.set_end_when(optim.Trigger.max_iteration(7))
    opt.set_checkpoint(str(tmp_path), optim.Trigger.several_iteration(5))
    opt.optimize()
    assert flaky.failed and opt.driver_state["neval"] == 8
    _close(model, straight, 1e-5)


def _jax_pair(seed=0):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.models import resnet as jres

    jm = jres.ResNetCifar(8)
    jm.build(jax.ShapeDtypeStruct((CK_B, 32, 32, 3), jnp.float32),
             rng=jax.random.PRNGKey(seed))
    return jm


def _jax_run(jm, end, ckpt, every=100, resume=False, summary=None):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import SampleToMiniBatch as JToMiniBatch
    from bigdl_tpu.dataset import array_dataset as jarray_dataset

    x, y = _data(6 * CK_B)
    opt = joptim.LocalOptimizer(
        jm, jarray_dataset(x, y) >> JToMiniBatch(CK_B),
        jnn.CrossEntropyCriterion(), _ck_sgd(joptim))
    opt.set_end_when(joptim.Trigger.max_iteration(end))
    opt.set_checkpoint(str(ckpt), joptim.Trigger.several_iteration(every))
    if summary is not None:
        opt.set_train_summary(summary)
    if resume:
        opt.resume_from_checkpoint()
    opt.optimize()
    return opt


def _port_from(jm, seed=9):
    import jax

    tm = tmodels.ResNetCifar(8, device="cpu", seed=seed)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    load_jax_state(tm, jax.tree.map(np.asarray, jm.state()))
    return tm


def _close_to_jax(tm, jm, tol):
    import jax

    for got, want in ((to_jax_params(tm), jm.parameters()[0]),
                      (to_jax_state(tm), jm.state())):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            b = np.asarray(b, np.float64)
            assert np.linalg.norm(a - b) <= tol * max(np.linalg.norm(b),
                                                      1e-12)


def test_jax_checkpoint_with_statistics_resumes_in_the_port(tmp_path):
    """JAX trains 4 steps and checkpoints at neval 5; a port model (other
    weights) resumes and takes steps 5 and 6: parameters and running
    statistics within 1e-4 (relative L2) of JAX's straight 6 steps."""
    jstraight = _jax_pair()
    _jax_run(jstraight, 6, tmp_path / "straight")
    _jax_run(_jax_pair(), 4, tmp_path / "ck", 5)
    tm = tmodels.ResNetCifar(8, device="cpu", seed=9)
    opt, _ = _port_run(tm, 6, tmp_path / "ck", 100, resume=True)
    assert opt.driver_state["neval"] == 7
    _close_to_jax(tm, jstraight, CROSS_TOL)


def test_port_checkpoint_with_statistics_resumes_in_jax(tmp_path):
    """The port trains 4 steps from JAX's weights and checkpoints at
    neval 5 (``model_state``, the parameters and the SGD velocity in
    JAX's trees, its empty entries included).  A JAX model (other
    weights) resumed from it to neval 5, taking no step, holds the
    snapshot's parameters and statistics bitwise; resumed to step 6, its
    losses of steps 5 and 6 are the port's from the same snapshot within
    1e-4.  (Its parameters are not held to the port's: from this state
    JAX's fp32 step moves two BatchNorm biases 1e-2 away from a float64
    step, where the port's stays within 2.5e-4.)"""
    import jax

    from bigdl_tpu_torch.utils import file_io

    _port_run(_port_from(_jax_pair()), 4, tmp_path, 5)
    snap = file_io.load(str(tmp_path / "checkpoint.5.pkl"))
    jm = _jax_pair(seed=1)
    _jax_run(jm, 4, tmp_path, 100, resume=True)
    for got, want in ((jm.parameters()[0], snap["model_params"]),
                      (jm.state(), snap["model_state"])):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)
    jlosses = _Losses()
    jopt = _jax_run(_jax_pair(seed=1), 6, tmp_path, 100, resume=True,
                    summary=jlosses)
    assert jopt.driver_state["neval"] == 7
    _, plosses = _port_run(tmodels.ResNetCifar(8, device="cpu", seed=6), 6,
                           tmp_path, 100, resume=True)
    assert sorted(plosses) == sorted(jlosses.by_step) == [5, 6]
    np.testing.assert_allclose([jlosses.by_step[k] for k in (5, 6)],
                               [plosses[k] for k in (5, 6)], rtol=1e-4)


# --------------------------------------------------------------------------- #
# Guards
# --------------------------------------------------------------------------- #

def test_tf32_is_switched_off_in_cudnn_too():
    from bigdl_tpu_torch.utils.device import require_fp32_matmul

    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        with pytest.warns(RuntimeWarning, match="convolutions"):
            require_fp32_matmul()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cudnn.allow_tf32 = before[0]
        torch.backends.cuda.matmul.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def test_cnn_modules_import_neither_jax_nor_the_jax_package():
    files = [ROOT / "bigdl_tpu_torch" / p for p in (
        "nn/conv.py", "nn/pooling.py", "nn/normalization.py",
        "nn/activations.py", "nn/reshape.py", "nn/initialization.py",
        "models/lenet.py", "models/vgg.py", "models/alexnet.py",
        "models/resnet.py", "models/inception.py", "models/run.py")]
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "bigdl_tpu"), \
                    f"{path.name} imports {name}"
