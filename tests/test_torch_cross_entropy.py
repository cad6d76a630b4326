"""The port's cross-entropy (K4/K5 plain versions, the autograd Function
and the four criteria) against the JAX package's, on the CPU.

K4/K5 are held against ``fused_softmax_cross_entropy(interpret=True)``,
the Pallas kernel run in interpret mode (``bigdl_tpu/ops/
cross_entropy.py``), on a ragged vocabulary (1000, padded by the JAX
side to 1024) and with labels outside ``[0, V)``; the criteria against
``bigdl_tpu/nn/criterion.py``.  Inputs come from one numpy seed;
tolerance 1e-5 abs and rel in fp32 (same math, sums in another order).
The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.ops.cross_entropy import _ce_fwd
from bigdl_tpu.ops.cross_entropy import \
    fused_softmax_cross_entropy as jax_fused
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.ops import cross_entropy as ce

TOL = dict(atol=1e-5, rtol=1e-5)


def _logits(n, v, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, v)) * 3).astype(np.float32)


def _labels(n, v, seed, out_of_range=False):
    y = np.random.default_rng(seed + 100).integers(0, v, n).astype(np.int32)
    if out_of_range:
        # outside [0, V) and outside the JAX side's -1e30 padding columns
        y[0], y[1] = -1, v + 4096
    return y


@pytest.mark.parametrize("n,v", [(64, 512), (128, 1000)])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_forward_matches_pallas_interpret(n, v, out_of_range):
    x, y = _logits(n, v, n + v), _labels(n, v, n + v, out_of_range)
    want_loss, (_, _, want_lse) = _ce_fwd(jnp.asarray(x), jnp.asarray(y),
                                          128, 512, True)
    before = dict(ce.LAUNCHES)
    loss, lse = ce.fused_softmax_cross_entropy_fwd(torch.from_numpy(x),
                                                   torch.from_numpy(y))
    assert ce.LAUNCHES == before         # CPU tensors: the plain version
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0],
                               **TOL)


@pytest.mark.parametrize("n,v", [(64, 512), (128, 1000)])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_gradient_matches_pallas_interpret(n, v, out_of_range):
    x, y = _logits(n, v, n * v), _labels(n, v, n * v, out_of_range)
    w = np.random.default_rng(7).random(n).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_fused(
        a, jnp.asarray(y), 128, 512, True) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (ce.fused_softmax_cross_entropy(xt, torch.from_numpy(y))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **TOL)
    # the grad plain version directly, with the per-row upstream g
    _, lse = ce.fused_softmax_cross_entropy_reference(torch.from_numpy(x),
                                                      torch.from_numpy(y))
    dx = ce.fused_softmax_cross_entropy_bwd(
        torch.from_numpy(x), torch.from_numpy(y), lse, torch.from_numpy(w))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), **TOL)


def test_bf16_logits_keep_their_dtype_in_the_gradient():
    x = torch.from_numpy(_logits(8, 600, 3)).bfloat16().requires_grad_(True)
    y = torch.from_numpy(_labels(8, 600, 3))
    loss = ce.fused_softmax_cross_entropy(x, y)
    assert loss.dtype == torch.float32
    loss.mean().backward()
    assert x.grad.dtype == torch.bfloat16


def _both(jc, tc, x, y):
    """Value and input gradient of a JAX and a port criterion."""
    jv = jc.forward(jnp.asarray(x), jnp.asarray(y))
    jg = jc.backward(jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tv = tc.forward(xt, yt)
    tg = tc.backward(xt, yt)
    np.testing.assert_allclose(float(tv), float(jv), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("size_average", [True, False])
def test_class_nll_matches_jax(size_average):
    n, c = 24, 7
    lp = np.log(np.random.default_rng(1).dirichlet(np.ones(c), n)
                ).astype(np.float32)
    y = _labels(n, c, 1)
    y[3] = 9                                   # clipped into range
    weights = np.linspace(0.5, 2.0, c).astype(np.float32)
    _both(jcrit.ClassNLLCriterion(size_average=size_average),
          nn.ClassNLLCriterion(size_average=size_average), lp, y)
    _both(jcrit.ClassNLLCriterion(weights, size_average, padding_value=2),
          nn.ClassNLLCriterion(weights, size_average, padding_value=2), lp,
          y)


@pytest.mark.parametrize("size_average", [True, False])
def test_cross_entropy_matches_jax(size_average):
    x, y = _logits(16, 40, 2), _labels(16, 40, 2)
    _both(jcrit.CrossEntropyCriterion(size_average=size_average),
          nn.CrossEntropyCriterion(size_average=size_average), x, y)


@pytest.mark.parametrize("n,v", [(64, 512), (64, 1000), (13, 1000),
                                 (16, 100)])
@pytest.mark.parametrize("size_average", [True, False])
def test_fused_criterion_matches_jax(n, v, size_average):
    """Above ``min_classes`` the port takes the fused path for every N;
    the JAX package takes its kernel (interpret) where N % 8 == 0 and the
    plain formulation elsewhere: the values agree either way, and
    out-of-range labels are clipped on both sides."""
    x, y = _logits(n, v, n + 1), _labels(n, v, n + 1, out_of_range=True)
    _both(jcrit.FusedSoftmaxCrossEntropyCriterion(size_average,
                                                  interpret=True),
          nn.FusedSoftmaxCrossEntropyCriterion(size_average), x, y)


def test_time_distributed_matches_jax_and_reshapes_without_copy():
    x = _logits(4 * 9, 512, 5).reshape(4, 9, 512)
    y = _labels(4 * 9, 512, 5).reshape(4, 9)
    inner = nn.FusedSoftmaxCrossEntropyCriterion()
    _both(jcrit.TimeDistributedCriterion(
              jcrit.FusedSoftmaxCrossEntropyCriterion(interpret=True)),
          nn.TimeDistributedCriterion(inner), x, y)

    seen = []

    class Spy(nn.Criterion):
        def apply(self, input, target):
            seen.append(input)
            return input.sum()

    xt = torch.from_numpy(x)
    nn.TimeDistributedCriterion(Spy()).apply(xt, torch.from_numpy(y))
    assert seen[0].shape == (36, 512)
    assert seen[0].data_ptr() == xt.data_ptr()    # a view, not a copy


def _graph(t):
    """Names of the autograd nodes behind ``t``."""
    names, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None:
            names.add(type(node).__name__)
            todo.extend(nxt for nxt, _ in node.next_functions)
    return names


def test_fused_criterion_goes_through_the_function():
    """2-D input with V >= min_classes runs the autograd Function (whose
    forward keeps lse); small V takes the plain criterion."""
    crit = nn.FusedSoftmaxCrossEntropyCriterion()
    x = torch.from_numpy(_logits(8, 512, 9)).requires_grad_(True)
    y = torch.from_numpy(_labels(8, 512, 9))
    assert "FusedSoftmaxCrossEntropyBackward" in _graph(crit.apply(x, y))
    small = torch.from_numpy(_logits(8, 100, 9)).requires_grad_(True)
    names = _graph(crit.apply(small, y.clamp(max=99)))
    assert "FusedSoftmaxCrossEntropyBackward" not in names
    assert "LogSoftmaxBackward0" in names
