"""The data-parallel trainer and the model's eval graphs on the card
(``cuda`` marker: each test skips without a CUDA card).

``DistriOptimizer`` makes every parameter a view of one flat plane
(``parallel.zero.FlatParamSpace.bind``), while an eval step's CUDA graph
reads the tensors it was captured on.  At a world of one on NCCL a
``ResNetCifar(8)`` is validated (its eval graph captured), trained,
validated, trained again with validation in the loop, and validated
once more; every validation, and the captured eval step's output, is
held against an eager eval of the same weights, and the second
``optimize()`` keeps the first one's plane.

No JAX here, so the file runs on the card with ``--noconftest``:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_distri_cuda.py
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.models import ResNetCifar
from bigdl_tpu_torch.optim.local_optimizer import validate
from bigdl_tpu_torch.optim.train_step import make_eval_step
from bigdl_tpu_torch.optim.validation import compiled_eval_step
from bigdl_tpu_torch.utils.device import require_fp32_matmul
from bigdl_tpu_torch.utils.engine import Engine

#: a captured eval against an eager one of the same weights, relative to
#: the largest logit (a capture may pick other cuDNN algorithms)
EVAL_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    require_fp32_matmul()
    yield torch.device("cuda")
    Engine.reset()


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _eager_loss(model, ds, crit):
    """The validation ``Loss`` through the eager eval step."""
    step = make_eval_step(model)
    num = den = 0.0
    for batch in ds.data(train=False):
        out = step(torch.from_numpy(np.asarray(batch.get_input())).cuda())
        t = torch.from_numpy(np.asarray(batch.get_target())).cuda()
        num += float(crit.apply(out, t)) * t.shape[0]
        den += t.shape[0]
    return num / den


def _held(model, ds, crit, probe):
    """The captured validation and eval step against the eager ones; the
    captured step's output on ``probe``."""
    loss, _ = validate(model, ds, [optim.Loss(crit)])[0].result()
    want = _eager_loss(model, ds, crit)
    assert abs(loss - want) <= EVAL_RTOL * abs(want), (loss, want)
    got = compiled_eval_step(model)(probe).clone()
    ref = make_eval_step(model)(probe)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= EVAL_RTOL * ref.abs().max()
    return got


@pytest.mark.cuda
def test_eval_graphs_follow_data_parallel_training(cuda):
    model = ResNetCifar(8, device="cuda", seed=0)
    crit = nn.CrossEntropyCriterion()
    x, y = _data(64, 0)
    xv, yv = _data(32, 1)
    val = array_dataset(xv, yv) >> SampleToMiniBatch(16)
    probe = torch.from_numpy(xv[:16]).cuda()

    before = _held(model, val, crit, probe)
    assert compiled_eval_step(model).stats()["captured"] == 1

    def train(steps):
        opt = optim.DistriOptimizer(
            model, array_dataset(x, y) >> SampleToMiniBatch(16), crit,
            optim.SGD(learning_rate=0.1, momentum=0.9, dampening=0.0))
        opt.set_validation(optim.Trigger.several_iteration(1), val,
                           [optim.Loss(crit)])
        opt.set_end_when(optim.Trigger.max_iteration(steps))
        opt.optimize()
        assert opt.captured_route == "nccl-graph"
        return opt

    opt = train(2)
    after_one = _held(model, val, crit, probe)
    # the weights moved: a graph on the old storage would show this
    assert (after_one - before).abs().max() > 100 * EVAL_RTOL * \
        before.abs().max()
    ptrs = [p.data_ptr() for p in model.parameters()]
    # a second optimize() keeps the plane; its in-loop validation (the
    # last at the run's last step) is the eager one of the final weights
    opt = train(4)
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    want = _eager_loss(model, val, crit)
    assert abs(opt.driver_state["Loss"] - want) <= EVAL_RTOL * abs(want)
    after_two = _held(model, val, crit, probe)
    assert (after_two - after_one).abs().max() > 100 * EVAL_RTOL * \
        after_one.abs().max()
