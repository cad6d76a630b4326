"""The CNN layers and model state of the port on the card (``cuda``
marker: each test skips without a CUDA card).

- Every convolution, pooling and normalization layer on the card against
  the same layer on the CPU, same parameters, state and input: outputs,
  input and parameter gradients, and the running statistics, fp32 within
  1e-4 (TF32 off: ``require_fp32_matmul`` clears cuDNN's flag too).
- ``ResNet(18)`` through ``CompiledTrainStep`` (one CUDA graph; the
  BatchNorm buffers updated in place inside it) against the eager step
  from the same weights, 4 steps at 32 x 32, fp32 and bf16, with cuDNN's
  deterministic algorithms: losses, parameters and running statistics
  (relative: a capture may pick other algorithms than eager calls).
- A capture that fails (a gradient read on the host) raises and leaves
  the parameters and the running statistics as they were.

No JAX here, so the file runs on the card with ``--noconftest``:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_cnn_cuda.py
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.utils.device import require_fp32_matmul

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    require_fp32_matmul()
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


#: (builder, input shape, training)
LAYERS = [
    (lambda: nn.SpatialConvolution(4, 6, 3, 3, 2, 2, -1, -1), (2, 9, 9, 4),
     False),
    (lambda: nn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1, n_group=4,
                                   dilation_w=2, dilation_h=2),
     (2, 9, 9, 8), False),
    (lambda: nn.SpatialConvolution(3, 5, 3, 3, 1, 1, 1, 1,
                                   data_format="NCHW"), (2, 3, 8, 8), False),
    (lambda: nn.SpaceToDepthStem(3, 16, 7), (2, 32, 32, 3), False),
    (lambda: nn.SpatialFullConvolution(3, 4, 3, 3, 2, 2, 1, 1, 1, 1),
     (2, 5, 5, 3), False),
    (lambda: nn.Conv1D(6, 5, 3, 2, -1), (2, 11, 6), False),
    (lambda: nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1).ceil(), (2, 8, 8, 3),
     False),
    (lambda: nn.SpatialAveragePooling(3, 3, 2, 2, 1, 1).ceil(),
     (2, 8, 8, 3), False),
    (lambda: nn.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                      count_include_pad=False).ceil(),
     (2, 7, 7, 3), False),
    (lambda: nn.SpatialBatchNormalization(4), (3, 5, 6, 4), True),
    (lambda: nn.SpatialBatchNormalization(4), (3, 5, 6, 4), False),
    (lambda: nn.BatchNormalization(5), (8, 5), True),
    (lambda: nn.SpatialCrossMapLRN(5, 1e-4, 0.75), (2, 4, 4, 7), False),
]


@pytest.mark.cuda
def test_cnn_layers_on_the_card_match_the_cpu(cuda):
    for i, (build, shape, training) in enumerate(LAYERS):
        g = torch.Generator().manual_seed(i)
        cpu = build()
        card = build().to(cuda)
        card.load_parameters_tree(cpu.parameters_tree())
        with torch.no_grad():
            for b in cpu.buffers():
                b.uniform_(0.5, 1.5, generator=g)
        card.load_state_tree(cpu.state_tree())
        cpu.train(training)
        card.train(training)
        x = torch.randn(shape, generator=g)
        outs = []
        for m, dev in ((cpu, "cpu"), (card, cuda)):
            xd = x.to(dev, copy=True).requires_grad_(True)
            y = m(xd)
            r = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(dev)
            (y * r).sum().backward()
            outs.append((y, xd.grad, {k: p.grad for k, p in
                                      m.named_parameters()},
                         dict(m.named_buffers())))
        (y0, gx0, gp0, b0), (y1, gx1, gp1, b1) = outs
        assert _rel(y1, y0) <= TOL, (i, "output")
        assert _rel(gx1, gx0) <= TOL, (i, "input gradient")
        for k in gp0:
            assert _rel(gp1[k], gp0[k]) <= TOL, (i, k)
        for k in b0:
            assert _rel(b1[k], b0[k]) <= TOL, (i, k)


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms for the test: its default
    backward algorithms part two runs of one step."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


@pytest.mark.cuda
def test_compiled_resnet18_with_buffers_matches_eager(cuda, deterministic):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((32, 32, 32, 3)).astype(
        np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 10, 32)).to(cuda)
    for dtype, tol in ((None, 1e-5), (torch.bfloat16, 1e-3)):
        ma = tmodels.ResNet(18, 10, device=cuda, seed=1)
        mb = tmodels.ResNet(18, 10, device=cuda, seed=1)
        sa = optim.SGD(learning_rate=0.05, momentum=0.9)
        sb = optim.SGD(learning_rate=0.05, momentum=0.9)
        st_a = sa.init_state(dict(ma.named_parameters()))
        st_b = sb.init_state(dict(mb.named_parameters()))
        eager = optim.make_train_step(ma, nn.CrossEntropyCriterion(), sa,
                                      compute_dtype=dtype)
        compiled = optim.CompiledTrainStep(
            mb, nn.CrossEntropyCriterion(), sb, st_b, cuda,
            compute_dtype=dtype)
        for i in range(4):
            xb, yb = x[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
            want = eager(st_a, xb, yb)[1].item()
            got = compiled.run(xb, yb).item()
            assert abs(got - want) <= tol * abs(want), (dtype, i, got, want)
        # as one vector each: a BatchNorm bias takes gradients small
        # against their terms, so one leaf alone can part further
        for named in ("named_parameters", "named_buffers"):
            a = torch.cat([t.flatten() for _, t in getattr(ma, named)()])
            b = torch.cat([t.flatten() for _, t in getattr(mb, named)()])
            assert _rel(b, a) <= tol, (dtype, named)
        assert compiled.stats()["captured"] == 1
        assert not torch.equal(mb._modules["1"].running_var,
                               torch.ones_like(mb._modules["1"].running_var))


@pytest.mark.cuda
def test_a_failed_capture_leaves_the_buffers(cuda):
    model = tmodels.ResNetCifar(8, device=cuda, seed=2)
    x = np.random.default_rng(1).standard_normal((16, 32, 32, 3)).astype(
        np.float32)
    y = np.arange(16) % 10
    opt = optim.Optimizer(model, array_dataset(x, y) >> SampleToMiniBatch(8),
                          nn.CrossEntropyCriterion(),
                          optim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(optim.Trigger.max_iteration(2))

    def syncing(grads):
        float(next(iter(grads.values())).sum().item())
        return grads

    opt.set_grad_transform(syncing)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    buffers = {k: b.detach().clone() for k, b in model.named_buffers()}
    with pytest.raises(RuntimeError):
        opt.optimize()
    torch.cuda.synchronize()
    for k, p in model.named_parameters():
        assert torch.equal(p, params[k]), k
    for k, b in model.named_buffers():
        assert torch.equal(b, buffers[k]), k
    opt.set_grad_transform(None)
    opt.optimize()
    assert opt.compiled_stats["captured"] == 1
    assert not torch.equal(model._modules["1"].running_mean,
                           buffers["1.running_mean"])
