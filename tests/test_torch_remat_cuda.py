"""Remat, scanned layers and dropout inside the compiled training step,
and ``Predictor.predict_minibatch``'s result, on the CPU and on the card
(no JAX here: the card machine has none; the JAX parity of these modules
is ``test_torch_remat_scan.py``).

CPU: the compiled step's CPU path on a scanned TransformerLM under every
policy equals the eager step bitwise; ``predict_minibatch`` copies the
eval step's output, so two results of one shape are both kept when the
step hands back one static buffer (as a CUDA graph does).

Card (``cuda`` marker, skipped without one):

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_remat_cuda.py

- two ``predict_minibatch`` results of one shape, the first kept after
  the second call, each equal to the eager forward;
- a captured scanned step at head_dim 96 under each policy against its
  eager step, bitwise, with K1 launched 2 x layers a step under remat
  (the recompute reruns it) and layers without, K1-bwd layers;
- a captured step of dropout blocks: each replay draws new masks (the
  key advances on the device), the compiled losses equal the eager
  step's, and the remat'ed stack's gradients equal the plain stack's.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import MiniBatch
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.utils.random_generator import RNG

VOCAB, HIDDEN, HEADS, LAYERS, SEQ = 128, 192, 2, 3, 32   # head_dim 96
POLICIES = [None, "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _model(device, policy=None, scan=True, seed=0):
    return nn.TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=SEQ,
                            device=device, seed=seed, scan_layers=scan,
                            remat_policy=policy)


def _crit():
    return nn.TimeDistributedCriterion(nn.FusedSoftmaxCrossEntropyCriterion())


def _data(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32),
            rng.integers(0, VOCAB, (n, SEQ)).astype(np.int32))


def _eager_and_compiled(device, policy, steps=3):
    """Losses and models of ``steps`` steps, eager and compiled, from one
    seed's weights."""
    x, y = _data(2 * steps)
    ma, mb = _model(device, policy), _model(device, policy)
    meth_a, meth_b = (optim.Adam(learning_rate=1e-2) for _ in range(2))
    sa = meth_a.init_state(dict(ma.named_parameters()))
    sb = meth_b.init_state(dict(mb.named_parameters()))
    eager = optim.make_train_step(ma, _crit(), meth_a)
    compiled = optim.CompiledTrainStep(mb, _crit(), meth_b, sb, device)
    la, lb = [], []
    for i in range(steps):
        xb = torch.as_tensor(x[2 * i:2 * i + 2], device=device)
        yb = torch.as_tensor(y[2 * i:2 * i + 2], device=device)
        la.append(eager(sa, xb, yb)[1].item())
        lb.append(compiled.run(xb, yb).item())
    return la, lb, ma, mb, compiled


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_cpu_compiled_scanned_step_equals_the_eager_step(policy):
    la, lb, ma, mb, compiled = _eager_and_compiled("cpu", policy)
    assert la == lb
    for (k, pa), (_, pb) in zip(ma.named_parameters(),
                                mb.named_parameters()):
        assert torch.equal(pa, pb), k
    assert compiled.stats()["captured"] == 1


class _StaticStep:
    """An eval step handing back one output buffer, overwritten by each
    call (what a replayed CUDA graph returns)."""

    def __init__(self, step):
        self.step, self.out, self.device = step, None, step.device

    def __call__(self, x):
        y = self.step(x)
        if self.out is None:
            self.out = torch.empty_like(y)
        return self.out.copy_(y)


def _two_results(device):
    model = _model(device, scan=False).eval()
    pred = optim.Predictor(model, batch_size=2)
    x1, _ = _data(2, seed=3)
    x2, _ = _data(2, seed=4)
    with torch.no_grad():
        want = [model(torch.as_tensor(x, device=device)) for x in (x1, x2)]
    return pred, [MiniBatch(x1), MiniBatch(x2)], want


def test_cpu_predict_minibatch_copies_a_static_output():
    pred, batches, want = _two_results("cpu")
    pred._eval = _StaticStep(pred._eval)
    first = pred.predict_minibatch(batches[0])
    second = pred.predict_minibatch(batches[1])
    torch.testing.assert_close(first, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(second, want[1], rtol=1e-5, atol=1e-5)
    assert first.data_ptr() != second.data_ptr()
    # predict reads the step's own output before the next batch
    rows = pred.predict(np.concatenate([b.get_input() for b in batches]))
    np.testing.assert_allclose(np.stack(rows[2:]), want[1].numpy(),
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_predict_minibatch_results_survive_the_next_call(cuda):
    pred, batches, want = _two_results(cuda)
    first = pred.predict_minibatch(batches[0])
    second = pred.predict_minibatch(batches[1])
    torch.cuda.synchronize()
    assert pred._eval.stats()["captured"] == 1      # one graph, replayed
    torch.testing.assert_close(first, want[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(second, want[1], rtol=1e-4, atol=1e-4)
    assert not torch.equal(first, second)


@pytest.mark.cuda
def test_captured_scanned_step_with_remat_matches_eager(cuda):
    for policy in POLICIES:
        fa.reset_launch_counts()
        la, lb, ma, mb, compiled = _eager_and_compiled(cuda, policy)
        assert la == lb, policy
        for (k, pa), (_, pb) in zip(ma.named_parameters(),
                                    mb.named_parameters()):
            assert torch.equal(pa, pb), (policy, k)
        # the replays' launches: the warm-up's and the eager run's apart
        fa.reset_launch_counts()
        x, y = _data(2, seed=9)
        compiled.run(torch.as_tensor(x, device=cuda),
                     torch.as_tensor(y, device=cuda))
        torch.cuda.synchronize()
        k1 = LAYERS if policy == "everything_saveable" else 2 * LAYERS
        assert fa.LAUNCHES["flash_attention"] == k1, policy
        assert fa.LAUNCHES["flash_attention_bwd"] == LAYERS, policy


def _dropout_stack(device, scan):
    gen = torch.Generator().manual_seed(0)
    blocks = [nn.TransformerBlock(HIDDEN, HEADS, generator=gen, dropout=0.3)
              for _ in range(LAYERS)]
    if scan:
        return nn.ScanLayers(blocks).to(device)
    for i, b in enumerate(blocks):
        b.attn.dropout_salt = i
    return nn.Sequential(*blocks).to(device)


@pytest.mark.cuda
def test_captured_dropout_step_draws_new_masks_and_recomputes_them(cuda):
    x = torch.randn(2, SEQ, HIDDEN, generator=torch.Generator()
                    .manual_seed(2)).to(cuda)
    target = torch.zeros_like(x)
    losses = {}
    for label in ("eager", "compiled"):
        RNG.set_seed(5)
        model = _dropout_stack(cuda, scan=True)
        meth = optim.SGD(learning_rate=0.0)
        state = meth.init_state(dict(model.named_parameters()))
        if label == "eager":
            step = optim.make_train_step(model, nn.MSECriterion(), meth)
            losses[label] = [step(state, x, target)[1].item()
                             for _ in range(4)]
        else:
            step = optim.CompiledTrainStep(model, nn.MSECriterion(), meth,
                                           state, cuda)
            losses[label] = [step.run(x, target).item() for _ in range(4)]
            assert step.stats()["captured"] == 1
    assert losses["compiled"] == losses["eager"]
    assert len(set(losses["compiled"])) == 4         # a new mask each step
    # the recompute draws the forward's mask: remat'ed gradients equal
    # the plain stack's under one key
    from bigdl_tpu_torch.nn import dropout as tdrop

    grads = {}
    for scan in (True, False):
        model = _dropout_stack(cuda, scan).train()
        with tdrop.step_key(torch.tensor(41, device=cuda)):
            model(x).square().sum().backward()
        grads[scan] = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads[True].items():
        want = torch.stack([grads[False][f"{i}.{k}"] for i in range(LAYERS)])
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
