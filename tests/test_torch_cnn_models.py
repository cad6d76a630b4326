"""The CNN model zoo of the port (``bigdl_tpu_torch/models/lenet.py``,
``vgg.py``, ``alexnet.py``, ``resnet.py``, ``inception.py``, the CNN
recipes of ``models/run.py``) against the JAX package's, on the CPU.

- Every builder's parameter and state trees (keys, JAX's empty ``()``
  entries, shapes) equal JAX's ``setup`` trees, through
  ``interop.to_jax_params`` / ``to_jax_state``; output shapes; ResNet-50
  at 25.557M parameters (``tests/test_models.py:38-43``).
- ResNet-50 in eval mode at 32 x 32, batch 2, on JAX's parameters and
  the non-trivial running statistics of one JAX training-mode apply:
  logits within 1e-4 relative L2.
- One training-mode step of ``ResNetCifar(20)``, ``ResNet(18)`` (32 x
  32) and ``LeNet5`` at batch 8: loss, every gradient and the new running
  statistics within 1e-4 relative L2 of ``jax.value_and_grad``.
  Train-mode BatchNorm at fresh init amplifies fp32 differences about
  1.8x a layer (``tests/test_models.py:59-66``), so whole-model parity
  is held at these depths; at batch 4 ``ResNetCifar(20)``'s step is so
  badly conditioned that JAX's own fp32 gradients sit 8.5e-3 from a
  float64 step, where the port's stay within 1e-4 of its float64 step.
- ``Optimizer(...).optimize()``: ``ResNetCifar(8)`` with SGD (nesterov,
  weight decay) and ``Top1Accuracy`` validation every epoch, against
  JAX's ``LocalOptimizer``: per-step losses, parameters and running
  statistics within 1e-4.  ``VggForCifar10`` (its 512-wide BatchNorm
  normalises over the batch's 8 rows: one fp32 step of either package
  lies 3e-3 to 1e-2 from a float64 step, so trajectories of the two
  packages part after a step): its first loss against JAX's, and
  ``optimize()`` with dropout against the eager steps bitwise.
- The recipes at tiny sizes on ``--device cpu`` with JAX's flags and
  defaults, and their refusals naming ROADMAP items (``--summaryDir``,
  ``--numWorkers`` and ``--queueDepth`` are taken since the summaries
  and prefetch workers were ported: ``test_torch_summaries.py``,
  ``test_torch_prefetch.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import alexnet as jalex
from bigdl_tpu.models import inception as jinc
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import resnet as jres
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch.interop import (load_jax_params, load_jax_state,
                                     to_jax_params, to_jax_state)
from bigdl_tpu_torch.models import run as trun
from bigdl_tpu_torch.utils.random_generator import RNG

REL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


#: name -> (JAX builder, port builder, input shape, output shape)
MODELS = {
    "LeNet5": (lambda: jlenet.LeNet5(), lambda: tmodels.LeNet5(device="cpu"),
               (2, 28, 28), (2, 10)),
    "VggForCifar10": (lambda: jvgg.VggForCifar10(),
                      lambda: tmodels.VggForCifar10(device="cpu"),
                      (2, 32, 32, 3), (2, 10)),
    "Vgg16": (lambda: jvgg.Vgg16(10), lambda: tmodels.Vgg16(10, device="cpu"),
              (1, 224, 224, 3), None),
    "Vgg19-bn": (lambda: jvgg.Vgg19(10, batch_norm=True),
                 lambda: tmodels.Vgg19(10, batch_norm=True, device="cpu"),
                 (1, 224, 224, 3), None),
    "AlexNet": (lambda: jalex.AlexNet(10),
                lambda: tmodels.AlexNet(10, device="cpu"),
                (1, 227, 227, 3), (1, 10)),
    "AlexNetOWT": (lambda: jalex.AlexNetOWT(10),
                   lambda: tmodels.AlexNetOWT(10, device="cpu"),
                   (1, 224, 224, 3), (1, 10)),
    "ResNet18": (lambda: jres.ResNet(18, 10),
                 lambda: tmodels.ResNet(18, 10, device="cpu"),
                 (1, 64, 64, 3), (1, 10)),
    "ResNet34": (lambda: jres.ResNet(34, 10),
                 lambda: tmodels.ResNet(34, 10, device="cpu"),
                 (1, 64, 64, 3), (1, 10)),
    "ResNet50": (lambda: jres.ResNet(50), lambda: tmodels.ResNet(
        50, device="cpu"), (1, 64, 64, 3), (1, 1000)),
    "ResNet50-remat-s2d": (
        lambda: jres.ResNet(50, 10, remat=True, stem_s2d=True),
        lambda: tmodels.ResNet(50, 10, remat=True, stem_s2d=True,
                               device="cpu"), (1, 64, 64, 3), (1, 10)),
    "ResNet101": (lambda: jres.ResNet(101, 10),
                  lambda: tmodels.ResNet(101, 10, device="cpu"),
                  (1, 64, 64, 3), None),
    "ResNet152": (lambda: jres.ResNet(152, 10),
                  lambda: tmodels.ResNet(152, 10, device="cpu"),
                  (1, 64, 64, 3), None),
    "ResNetCifar20": (lambda: jres.ResNetCifar(20),
                      lambda: tmodels.ResNetCifar(20, device="cpu"),
                      (2, 32, 32, 3), (2, 10)),
    "InceptionV1": (lambda: jinc.InceptionV1(10),
                    lambda: tmodels.InceptionV1(10, device="cpu"),
                    (1, 224, 224, 3), (1, 30)),
    "InceptionV1NoAux": (lambda: jinc.InceptionV1NoAuxClassifier(10),
                         lambda: tmodels.InceptionV1NoAuxClassifier(
                             10, device="cpu"), (1, 224, 224, 3), (1, 10)),
    "InceptionV2": (lambda: jinc.InceptionV2(10),
                    lambda: tmodels.InceptionV2(10, device="cpu"),
                    (1, 224, 224, 3), (1, 10)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_trees_and_shapes_match_jax(name):
    """Parameter and state trees of JAX's ``setup`` (abstract, no
    weights drawn) against the port's through the bridge: the same
    structure, keys, empty entries and shapes; then the port's output
    shape in eval mode."""
    jbuild, tbuild, shape, out = MODELS[name]
    jm, tm = jbuild(), tbuild()
    jp, js = jax.eval_shape(
        lambda: jm.setup(jax.random.PRNGKey(0),
                         jax.ShapeDtypeStruct(shape, jnp.float32)))
    tp, ts = to_jax_params(tm), to_jax_state(tm)
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    assert _shapes(tp) == _shapes(jp)
    assert jax.tree.structure(ts) == jax.tree.structure(js)
    assert _shapes(ts) == _shapes(js)
    if out is not None:
        with torch.no_grad():
            y = tm.eval()(torch.zeros(shape))
        assert tuple(y.shape) == out


def test_resnet50_has_25_557m_parameters():
    n = sum(p.numel() for p in tmodels.ResNet(50, device="cpu").parameters())
    assert abs(n - 25.557e6) / 25.557e6 < 0.01, n
    assert n == 25557032


def _jax_built(jm, shape, seed=0):
    jm.build(jax.ShapeDtypeStruct(shape, jnp.float32),
             rng=jax.random.PRNGKey(seed))
    return jm.parameters()[0], jm.state()


def test_resnet50_eval_forward_matches_jax_with_trained_statistics():
    """The running statistics after one JAX training-mode apply (not the
    init's zeros and ones), loaded with the parameters; eval logits on
    another batch within 1e-4 relative L2."""
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x2 = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = jres.ResNet(50)
    jp, js = _jax_built(jm, x1.shape)
    _, js = jm.apply(jp, js, jnp.asarray(x1), training=True)
    want, _ = jm.apply(jp, js, jnp.asarray(x2), training=False)
    tm = tmodels.ResNet(50, device="cpu", seed=3)
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    load_jax_state(tm, jax.tree.map(np.asarray, js))
    stats = tm._modules["1"].running_var
    assert not torch.allclose(stats, torch.ones_like(stats))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x2))
    assert rel_l2(got.numpy(), want) < REL


#: name -> (JAX builder, port builder, input shape, criterion name)
STEP_CASES = {
    "ResNetCifar20": (lambda: jres.ResNetCifar(20),
                      lambda: tmodels.ResNetCifar(20, device="cpu", seed=4),
                      (8, 32, 32, 3), "CrossEntropyCriterion"),
    "ResNet18": (lambda: jres.ResNet(18, 10),
                 lambda: tmodels.ResNet(18, 10, device="cpu", seed=4),
                 (8, 32, 32, 3), "CrossEntropyCriterion"),
    "LeNet5": (lambda: jlenet.LeNet5(),
               lambda: tmodels.LeNet5(device="cpu", seed=4),
               (8, 28, 28), "ClassNLLCriterion"),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_one_train_step_matches_jax(name):
    """Loss, every gradient and the new running statistics of one
    training-mode forward and backward, within 1e-4 relative L2."""
    jbuild, tbuild, shape, crit = STEP_CASES[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    t = rng.integers(0, 10, shape[0]).astype(np.int32)
    jm = jbuild()
    jp, js = _jax_built(jm, shape)
    jcrit = getattr(jnn, crit)()

    def loss_fn(p):
        y, s = jm.apply(p, js, jnp.asarray(x), training=True)
        return jcrit.apply(y, jnp.asarray(t)), s

    (jloss, js2), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    tm = tbuild()
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    load_jax_state(tm, jax.tree.map(np.asarray, js))
    tm.train()
    loss = getattr(nn, crit)().apply(tm(torch.from_numpy(x)),
                                     torch.from_numpy(t).long())
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= REL * abs(float(jloss))
    grads = _flat(jax.tree.map(np.asarray, jg))
    got = _flat(to_jax_params(tm))
    assert grads.keys() == got.keys()
    tgrads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    for k, p in tm.named_parameters():
        path = "".join(f"['{s}']" for s in k.split("."))
        assert rel_l2(tgrads[k], grads[path]) < REL, k
    want = _flat(jax.tree.map(np.asarray, js2))
    got = _flat(to_jax_state(tm))
    assert want.keys() == got.keys()
    for k in want:
        assert rel_l2(got[k], want[k]) < REL, k


def test_train_step_gradients_against_float64():
    """At batch 4, ``ResNetCifar(20)``'s fp32 train-mode step is badly
    conditioned (BatchNorm's E[x^2] - E[x]^2 over few samples): there
    JAX's fp32 gradients sit up to 8.5e-3 (relative L2) from a float64
    computation of the same step.  The port's fp32 gradients are held to
    1e-4 of the port's own float64 step (the same model in ``double()``),
    every parameter whose gradient is not zero in exact arithmetic (the
    biases of convolutions feeding a BatchNorm are)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3))
    t = torch.from_numpy(rng.integers(0, 10, 4))
    grads = {}
    for dt in (torch.float32, torch.float64):
        tm = tmodels.ResNetCifar(20, device="cpu", seed=4).to(dt).train()
        nn.CrossEntropyCriterion().apply(
            tm(torch.from_numpy(x).to(dt)), t).backward()
        grads[dt] = {k: p.grad.double().numpy()
                     for k, p in tm.named_parameters()}
    for k, g64 in grads[torch.float64].items():
        if np.linalg.norm(g64) > 1e-9:
            assert rel_l2(grads[torch.float32][k], g64) < REL, k


# --------------------------------------------------------------------------- #
# optimize() against JAX's LocalOptimizer
# --------------------------------------------------------------------------- #

def _no_dropout(model):
    """Dropout off in a JAX or port model (the masks cannot match)."""
    mods = model.modules() if isinstance(model, torch.nn.Module) else \
        _jax_modules(model)
    for m in mods:
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return model


def _jax_modules(m):
    yield m
    for c in getattr(m, "modules", []) or []:
        yield from _jax_modules(c)


def test_resnet_cifar_optimize_matches_jax_local_optimizer():
    """4 steps of ``optimize()`` of ``ResNetCifar(8)`` with SGD (nesterov,
    weight decay), 3 batches of 4 an epoch, so an epoch ends and
    ``Top1Accuracy`` validation runs on the held-out batch, from JAX's
    weights: per-step losses, the validation result, the parameters and
    the running statistics after the run, against JAX's
    ``LocalOptimizer`` (1e-4)."""
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import SampleToMiniBatch as JToMiniBatch
    from bigdl_tpu.dataset import array_dataset as jarray_dataset
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    b, steps = 4, 4
    x, y = trun._synthetic_images(4 * b, 32, 32, 3, 10)
    xv, yv = x[3 * b:], y[3 * b:]
    x, y = x[:3 * b], y[:3 * b]
    jm = jres.ResNetCifar(8)
    jp, js = _jax_built(jm, (b, 32, 32, 3))
    tm = tmodels.ResNetCifar(8, device="cpu", seed=2)
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    load_jax_state(tm, jax.tree.map(np.asarray, js))
    runs = {}
    for pkg, o, model, ds, crit in (
            ("jax", joptim, jm, lambda *a: jarray_dataset(
                *a, shuffle_on_epoch=False) >> JToMiniBatch(b),
             jnn.CrossEntropyCriterion()),
            ("port", optim, tm, lambda *a: array_dataset(
                *a, shuffle_on_epoch=False) >> SampleToMiniBatch(b),
             nn.CrossEntropyCriterion())):
        method = o.SGD(learning_rate=0.05, momentum=0.9, dampening=0.0,
                       weight_decay=1e-4, nesterov=True)
        opt = (o.LocalOptimizer(model, ds(x, y), crit, method)
               if pkg == "jax" else
               o.Optimizer(model, ds(x, y), crit, method, device="cpu"))
        summary = _LossSummary()
        opt.set_train_summary(summary)
        opt.set_validation(o.Trigger.every_epoch(), ds(xv, yv),
                           [o.Top1Accuracy()])
        opt.set_end_when(o.Trigger.max_iteration(steps))
        opt.optimize()
        runs[pkg] = (summary.loss, opt.driver_state["Top1Accuracy"])
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], rtol=REL)
    assert runs["port"][1] == runs["jax"][1]
    want = _flat(jax.tree.map(np.asarray, jm.parameters()[0]))
    for k, v in _flat(to_jax_params(tm)).items():
        assert rel_l2(v, want[k]) < REL, k
    want = _flat(jax.tree.map(np.asarray, jm.state()))
    for k, v in _flat(to_jax_state(tm)).items():
        assert rel_l2(v, want[k]) < REL, k


class _LossSummary:
    def __init__(self):
        self.loss = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss.append(float(value))


def _vgg_pair(seed=2):
    """VggForCifar10 in both packages on JAX's weights (batch 8 spec)."""
    jm = jvgg.VggForCifar10()
    jp, js = _jax_built(jm, (8, 32, 32, 3))
    tm = tmodels.VggForCifar10(device="cpu", seed=seed)
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    load_jax_state(tm, jax.tree.map(np.asarray, js))
    return jm, jax.tree.map(np.array, jp), jax.tree.map(np.array, js), tm


def test_vgg_optimize_runs_the_eager_steps_and_starts_at_jax():
    """VggForCifar10, dropout as built (0.5), 3 steps of 8 with SGD
    (momentum, weight decay 5e-4) and ``Top1Accuracy`` validation at the
    epoch's end: the first loss is JAX's on the same weights and batch
    (dropout off there: the masks cannot match JAX's, so the JAX side is
    evaluated without it, and so is the port's first step, through a
    dropout-free copy); every step's loss equals the eager
    ``make_train_step``'s on a twin from the same weights, bitwise, the
    running statistics too; the validation equals an eager eval of the
    trained model."""
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset

    jm, jp, js, tm = _vgg_pair()
    twin = tmodels.VggForCifar10(device="cpu", seed=7)
    twin.load_parameters_tree(tm.parameters_tree())
    twin.load_state_tree(tm.state_tree())
    x, y = trun._synthetic_images(32, 32, 32, 3, 10)
    xv, yv = x[24:], y[24:]
    x, y = x[:24], y[:24]
    # the first loss, no dropout, in both packages
    _no_dropout(jm)
    jy, _ = jm.apply(jax.tree.map(jnp.asarray, jp), js, jnp.asarray(x[:8]),
                     training=True)
    jloss = float(jnn.ClassNLLCriterion().apply(jy, jnp.asarray(y[:8])))
    plain = tmodels.VggForCifar10(device="cpu", seed=9)
    plain.load_parameters_tree(tm.parameters_tree())
    plain.load_state_tree(tm.state_tree())
    _no_dropout(plain).train()
    with torch.no_grad():
        tloss = nn.ClassNLLCriterion().apply(
            plain(torch.from_numpy(x[:8])), torch.from_numpy(y[:8])).item()
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)

    opt = optim.Optimizer(
        tm, array_dataset(x, y, shuffle_on_epoch=False) >>
        SampleToMiniBatch(8), nn.ClassNLLCriterion(),
        optim.SGD(learning_rate=0.01, momentum=0.9, dampening=0.0,
                  weight_decay=5e-4), device="cpu")
    summary = _LossSummary()
    opt.set_train_summary(summary)
    val = array_dataset(xv, yv) >> SampleToMiniBatch(8)
    opt.set_validation(optim.Trigger.every_epoch(), val,
                       [optim.Top1Accuracy()])
    opt.set_end_when(optim.Trigger.max_iteration(3))
    RNG.set_seed(5)        # the step's dropout key is drawn from it
    opt.optimize()
    sgd = optim.SGD(learning_rate=0.01, momentum=0.9, dampening=0.0,
                    weight_decay=5e-4)
    state = sgd.init_state(dict(twin.named_parameters()))
    RNG.set_seed(5)
    step = optim.make_train_step(twin, nn.ClassNLLCriterion(), sgd)
    assert step.dropout_key is not None
    eager = [step(state, torch.from_numpy(x[i * 8:(i + 1) * 8]),
                  torch.from_numpy(y[i * 8:(i + 1) * 8]))[1].item()
             for i in range(3)]
    assert eager == summary.loss
    for (k, a), (_, b) in zip(tm.named_buffers(), twin.named_buffers()):
        assert torch.equal(a, b), k
    with torch.no_grad():
        out = twin.eval()(torch.from_numpy(xv))
    top1 = (out.argmax(-1).numpy() == yv).mean()
    assert opt.driver_state["Top1Accuracy"] == top1
    assert all(np.isfinite(summary.loss))


# --------------------------------------------------------------------------- #
# The recipes
# --------------------------------------------------------------------------- #

def test_lenet_recipes_train_and_test():
    opt = trun.main(["lenet-train", "--device", "cpu", "--synthN", "96",
                     "-b", "24", "--maxIteration", "3"])
    assert opt.driver_state["neval"] == 4
    sgd = opt.optim_method
    assert (sgd.momentum, sgd.dampening) == (0.9, 0.0)
    assert sgd.learning_rate == 0.05          # JAX's default
    assert [m.name for m in opt.validation_methods] == ["Top1Accuracy"]
    top1, top5 = trun.main(["lenet-test", "--device", "cpu", "--synthN",
                            "64", "-b", "16"])
    assert top1.result()[1] == top5.result()[1] == 16
    assert top1.result()[0] <= top5.result()[0]


def test_synthetic_data_is_the_jax_recipes():
    from bigdl_tpu.dataset import mnist as jmnist
    from bigdl_tpu.models import run as jrun

    for a, b in zip(trun.synthetic_mnist(64), jmnist.synthetic_mnist(64)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(trun._synthetic_images(8, 5, 6, 3, 10),
                    jrun._synthetic_images(8, 5, 6, 3, 10)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv,steps", [
    (["vgg-train", "--synthN", "24", "-b", "6", "--maxIteration", "2"], 2),
    (["resnet-train", "--depth", "8", "--synthN", "24", "-b", "6",
      "--maxEpoch", "1"], 3),
    (["inception-train", "--version", "v1", "--synthN", "16", "-b", "2",
      "--maxIteration", "1", "--classes", "10"], 1),
    (["inception-train", "--version", "v2", "--synthN", "16", "-b", "2",
      "--maxIteration", "1", "--classes", "10"], 1),
])
def test_cnn_recipes_train(argv, steps):
    opt = trun.main(argv + ["--device", "cpu"])
    assert opt.driver_state["neval"] == steps + 1
    assert np.isfinite(opt.driver_state["loss"])


def test_resnet_imagenet_recipe(monkeypatch):
    """The recipe's schedule, method and flags (``--fused``, ``--s2d``,
    ``--remat``), with ResNet-18 standing in for ResNet-50 so that a
    224 x 224 CPU step stays short."""
    from bigdl_tpu_torch.models import resnet

    built = {}
    real = resnet.ResNet

    def small(depth=50, **kw):
        built.update(depth=depth, **kw)
        return real(18, **kw)

    monkeypatch.setattr(resnet, "ResNet", small)
    opt = trun.main(["resnet-imagenet-train", "--device", "cpu", "-b", "2",
                     "--synthN", "8", "--maxIteration", "1", "--fused",
                     "--s2d", "--remat", "--learningRate", "0.1"])
    assert built["depth"] == 50 and built["class_num"] == 1000
    assert built["stem_s2d"] and built["remat"]
    assert isinstance(opt.optim_method, optim.Fused)
    sgd = opt.optim_method.inner
    sched = sgd.schedule
    steps = int(np.ceil(1281167 / 2))
    assert sched.steps_per_epoch == steps
    assert sched.warmup_iteration == 5 * steps
    np.testing.assert_allclose(sched.warmup_delta, (3.2 - 0.1) / (5 * steps))
    assert (sgd.momentum, sgd.weight_decay) == (0.9, 1e-4)
    assert opt.driver_state["neval"] == 2
    with pytest.raises(ValueError):
        trun.main(["resnet-imagenet-train", "--device", "cpu",
                   "--rematPolicy", "no_such_policy"])


@pytest.mark.parametrize("flag,item", [
    (["--folder", "data"], "A9"), (["--model", "m.bigdl"], "A9")])
@pytest.mark.parametrize("recipe", ["lenet-train", "lenet-test",
                                    "vgg-train", "resnet-train",
                                    "resnet-imagenet-train",
                                    "inception-train"])
def test_recipes_refuse_unported_flags(recipe, flag, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        trun.main([recipe, "--device", "cpu"] + flag)


#: tiny settings of each recipe for one iteration on the CPU
_TINY = {"lenet-train": ["-b", "4", "--synthN", "16"],
         "vgg-train": ["-b", "4", "--synthN", "16"],
         "resnet-train": ["-b", "4", "--synthN", "16", "--depth", "8"],
         "resnet-imagenet-train": ["-b", "2", "--synthN", "8", "--fused"],
         "inception-train": ["-b", "2", "--synthN", "16", "--classes", "4"]}


@pytest.mark.parametrize("recipe", ["lenet-train", "lenet-test",
                                    "vgg-train", "resnet-train",
                                    "resnet-imagenet-train",
                                    "inception-train"])
def test_recipes_route_distributed(recipe, monkeypatch):
    """``--distributed`` routes through ``DistriOptimizer`` wherever the
    JAX recipe routes it (JAX ``models/run.py:67``): one iteration at the
    world of one the engine starts on gloo.  ``lenet-test`` runs no
    optimizer and keeps its refusal (ROADMAP A4)."""
    from bigdl_tpu_torch.utils.engine import Engine

    if recipe == "lenet-test":
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            trun.main([recipe, "--device", "cpu", "--distributed"])
        return
    if recipe == "resnet-imagenet-train":
        from bigdl_tpu_torch.models import resnet

        real = resnet.ResNet
        monkeypatch.setattr(resnet, "ResNet",
                            lambda depth=50, **kw: real(18, **kw))
    try:
        opt = trun.main([recipe, "--device", "cpu", "--distributed",
                         "--maxIteration", "1"] + _TINY[recipe])
    finally:
        Engine.reset()
    assert isinstance(opt, optim.DistriOptimizer)
    assert opt.driver_state["neval"] == 2
    assert np.isfinite(opt.driver_state["loss"])
    assert opt.compiled_stats["replays"] == 1
