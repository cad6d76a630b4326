"""The port's training path against the JAX package's, on the CPU.

Held against ``bigdl_tpu``: the K1 autograd Function's backward (against
``jax.grad`` of ``dot_product_attention``: the Pallas K1 has no VJP), the
optim methods and clipping (``optim/optim_method.py``), one
``make_train_step`` step (``jax.value_and_grad`` of the JAX step's loss
on bridged weights), ``Optimizer(...).optimize()`` (JAX's
``LocalOptimizer``), the datasets' batch order, the triggers and the
optimizer-state bridge.  Small model: vocab 512, hidden 64, 4 heads, 2
layers, T 16-37.  Inputs and weights come from numpy / JAX seeds.
Tolerances: 1e-6 for an update on given gradients, 1e-5 for parameters
after training, 1e-4 for losses and gradients through the model (fp32,
sums in another order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
from bigdl_tpu.dataset import array_dataset as jax_array_dataset
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.nn.attention import dot_product_attention as jax_dpa
from bigdl_tpu.optim.train_step import make_train_step as jax_train_step
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_opt_state, load_jax_params
from bigdl_tpu_torch.interop.jax_params import to_port_tree
from bigdl_tpu_torch.models import run, synthetic_corpus
from bigdl_tpu_torch.ops import flash_attention as fa

VOCAB, HIDDEN, HEADS, LAYERS, SEQ = 512, 64, 4, 2, 16


def _flat(tree, prefix=""):
    """Nested dict -> ``{"block0.attn.qkv_weight": np.ndarray}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(scan=False, seed=0):
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=SEQ, scan_layers=scan)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32),
             rng=jax.random.PRNGKey(seed))
    tm = nn.TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=SEQ,
                          device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _crits():
    return (jcrit.TimeDistributedCriterion(
                jcrit.FusedSoftmaxCrossEntropyCriterion()),
            nn.TimeDistributedCriterion(
                nn.FusedSoftmaxCrossEntropyCriterion()))


def _close_params(tm, jax_params, tol):
    want = _flat(jax.tree.map(np.asarray, jax_params))
    got = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)


# --------------------------------------------------------------------------- #
# K1's gradient
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("t", [16, 37])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_matches_jax_grad(t, causal):
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((2, t, 4, 16)).astype(np.float32)
               for _ in range(3))
    w = rng.standard_normal((2, t, 4, 16)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(jax_dpa(a, b, c, causal=causal)
                                            * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    before = dict(fa.LAUNCHES)
    (fa.flash_attention(qt, kt, vt, causal) * torch.from_numpy(w)).sum() \
        .backward()
    assert fa.LAUNCHES == before           # CPU: the Function's plain path
    for got, exp in zip((qt, kt, vt), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(exp),
                                   atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# Optim methods and clipping
# --------------------------------------------------------------------------- #

def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (rng.standard_normal(p.shape) * 0.1).astype(np.float32)
              for k, p in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("method", [
    ("SGD", dict(learning_rate=0.1)),
    ("SGD", dict(learning_rate=0.1, learning_rate_decay=0.3,
                 weight_decay=0.01, momentum=0.9, dampening=0.2)),
    ("SGD", dict(learning_rate=0.05, momentum=0.9, dampening=0.0,
                 nesterov=True)),
    ("Adam", dict(learning_rate=0.01)),
    ("Adam", dict(learning_rate=0.01, learning_rate_decay=0.5,
                  beta1=0.8, beta2=0.99, epsilon=1e-6, weight_decay=0.02)),
])
def test_optim_method_update_matches_jax(method):
    name, kw = method
    params, grads = _params_and_grads(len(kw))
    jm, tm = getattr(joptim, name)(**kw), getattr(optim, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jm.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tm.init_state(tp)
    for g in grads:
        jp, js = jm.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tm.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert ts["neval"] == int(js["neval"])
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tm.get_learning_rate(ts),
                               float(jm.get_learning_rate(js))
                               if name == "SGD" else
                               kw["learning_rate"] / (1 + 3 * kw.get(
                                   "learning_rate_decay", 0.0)), rtol=1e-6)


def test_clipping_matches_jax():
    _, grads = _params_and_grads(9)
    g = grads[0]
    want = joptim.optim_method.clip_by_value(
        {k: jnp.asarray(v) for k, v in g.items()}, -0.05, 0.04)
    got = optim.clip_by_value({k: torch.from_numpy(v.copy())
                               for k, v in g.items()}, -0.05, 0.04)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for max_norm in (0.1, 100.0):               # scaled, and left alone
        want = joptim.optim_method.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got = optim.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, max_norm)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-7, rtol=1e-6)


def test_unported_schedules_and_options_raise():
    # every schedule is ported: SGD takes any (tests/test_torch_optim_methods)
    step = optim.Step(2, 0.5)
    assert optim.SGD(learning_rate_schedule=step).schedule is step
    m = nn.TransformerLM(64, 32, 2, 1, max_len=8, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        optim.make_train_step(m, nn.CrossEntropyCriterion(), optim.SGD(),
                              health_stats=True)
    ds = array_dataset(np.zeros((4, 8), np.int32), np.zeros((4, 8), np.int32))
    # distributed=True is the data-parallel DistriOptimizer (ROADMAP A4,
    # ported: tests/test_torch_distri_optimizer.py)
    opt = optim.Optimizer(m, ds, nn.CrossEntropyCriterion(),
                          distributed=True, device="cpu")
    assert isinstance(opt, optim.DistriOptimizer)
    assert opt.device == torch.device("cpu") and opt.sync_bn is False
    # tp, sp, ep and pp are ported (tests/test_torch_strategy_facade.py,
    # test_torch_pp.py); pp needs a "pipe" axis on its mesh
    with pytest.raises(ValueError, match="pipe_axis='pipe' is not an axis"):
        optim.Optimizer(m, ds, nn.CrossEntropyCriterion(), strategy="pp",
                        device="cpu")


# --------------------------------------------------------------------------- #
# One train step, and optimize()
# --------------------------------------------------------------------------- #

def test_train_step_matches_jax_value_and_grad():
    """The loss and every parameter's gradient of one step, then the SGD
    update, against JAX on the same weights and batch (ragged T 13)."""
    jm, tm = _pair()
    jc, tc = _crits()
    x, y = synthetic_corpus(3, 13, VOCAB, seed=4)
    params = jm.parameters()[0]

    def loss_fn(p):
        out, _ = jm.apply(p, (), jnp.asarray(x), training=True,
                          rng=jax.random.PRNGKey(0))
        return jc.apply(out, jnp.asarray(y))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    sgd = optim.SGD(learning_rate=0.5)
    step = optim.make_train_step(tm, tc, sgd)
    state, loss = step(sgd.init_state(dict(tm.named_parameters())),
                       torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want_grads = _flat(want_grads)
    for k, p in tm.named_parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, k
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k],
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    assert state["neval"] == 1
    jstep = jax.jit(jax_train_step(jm, jc, joptim.SGD(learning_rate=0.5)))
    new_params, *_ = jstep(params, (), joptim.SGD().init_state(params),
                           jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(0))
    _close_params(tm, new_params, 1e-5)


def test_eval_step_is_the_forward_without_gradient():
    _, tm = _pair()
    x, _ = synthetic_corpus(2, SEQ, VOCAB, seed=9)
    out = optim.make_eval_step(tm)(torch.from_numpy(x))
    assert not out.requires_grad and not tm.training
    with torch.no_grad():
        np.testing.assert_array_equal(out.numpy(),
                                      tm(torch.from_numpy(x)).numpy())


class _Recorder:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append(float(value))


def _train_both(method, kw, iters, clip, n_seq=8, batch=4):
    """JAX's and the port's Optimizer on the same weights and data, with
    the same gradient clipping (``clip``: setter name and arguments): 2
    batches an epoch, so the run crosses epoch boundaries and reshuffles
    on both sides."""
    jm, tm = _pair(seed=3)
    jc, tc = _crits()
    x, y = synthetic_corpus(n_seq, SEQ, VOCAB, seed=5)
    runs = {}
    for side, model, crit, pkg, dset, to_batch in (
            ("jax", jm, jc, joptim, jax_array_dataset, JaxToMiniBatch),
            ("port", tm, tc, optim, array_dataset, SampleToMiniBatch)):
        kwargs = {} if side == "jax" else {"device": "cpu"}
        opt = pkg.Optimizer(model=model, dataset=dset(x, y) >> to_batch(batch),
                            criterion=crit,
                            optim_method=getattr(pkg, method)(**kw), **kwargs)
        opt.set_end_when(pkg.Trigger.max_iteration(iters))
        getattr(opt, clip[0])(*clip[1:])
        rec = _Recorder()
        opt.set_train_summary(rec)
        opt.optimize()
        runs[side] = (rec.scalars["Loss"], opt.driver_state)
    return jm, tm, runs


def test_local_optimizer_sgd_matches_jax():
    jm, tm, runs = _train_both(
        "SGD", dict(learning_rate=0.5, momentum=0.9, dampening=0.0), 4,
        ("set_gradient_clipping_by_l2_norm", 0.1))
    _close_params(tm, jm.parameters()[0], 1e-5)
    (jl, js), (tl, ts) = runs["jax"], runs["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert (ts["epoch"], ts["neval"]) == (js["epoch"], js["neval"]) == (3, 5)


def test_local_optimizer_adam_losses_match_jax():
    _, _, runs = _train_both("Adam", dict(learning_rate=3e-3), 4,
                             ("set_gradient_clipping_by_value", -0.02, 0.02))
    jl, tl = runs["jax"][0], runs["port"][0]
    assert len(tl) == 4
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def test_datasets_shuffle_in_the_same_order():
    x, y = synthetic_corpus(10, 4, VOCAB, seed=6)
    jd = jax_array_dataset(x, y, seed=3) >> JaxToMiniBatch(3)
    td = array_dataset(x, y, seed=3) >> SampleToMiniBatch(3)
    for _ in range(3):
        jd.shuffle()
        td.shuffle()
        ji, ti = jd.data(train=True), td.data(train=True)
        for _ in range(4):
            jb, tb = next(ji), next(ti)
            np.testing.assert_array_equal(tb.get_input(), jb.get_input())
            np.testing.assert_array_equal(tb.get_target(), jb.get_target())
    assert td.size() == jd.size() == 10


def test_triggers_match_jax():
    states = [{"epoch": e, "neval": n} for e in (1, 2, 3) for n in (1, 4, 9)]
    for name, arg in (("max_epoch", 2), ("max_iteration", 4),
                      ("several_iteration", 3)):
        jt, tt = getattr(joptim.Trigger, name)(arg), \
            getattr(optim.Trigger, name)(arg)
        assert [tt(s) for s in states] == [jt(s) for s in states]
    jt, tt = joptim.Trigger.every_epoch(), optim.Trigger.every_epoch()
    assert tt.stateful
    assert [tt(s) for s in states] == [jt(s) for s in states]


# --------------------------------------------------------------------------- #
# The optimizer-state bridge
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("scan", [False, True])
def test_load_jax_opt_state_by_key(scan):
    """A JAX Adam state, in either parameter layout, loads by key: one
    tensor per port parameter, of its shape, equal to the JAX leaf."""
    jm, tm = _pair(scan=scan)
    params = jm.parameters()[0]
    adam = joptim.Adam(learning_rate=1e-2)
    state = adam.init_state(params)
    update = jax.jit(adam.update)
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params)
        params, state = update(grads, state, params)
    method = optim.Adam(learning_rate=1e-2)
    got = load_jax_opt_state(method, state, device="cpu")
    assert method.state is got and got["neval"] == 2
    shapes = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    for slot in ("m", "v"):
        want = _flat(to_port_tree(jax.tree.map(np.asarray, state[slot])))
        assert set(got[slot]) == set(want) == set(shapes)
        for k, t in got[slot].items():
            assert tuple(t.shape) == shapes[k]
            np.testing.assert_array_equal(t.numpy(), want[k])
    with pytest.raises(KeyError, match="velocity"):
        load_jax_opt_state(optim.SGD(momentum=0.9), state, device="cpu")


def test_training_carries_across_from_jax_mid_run():
    """Two JAX Adam steps, then the port continues from the JAX weights and
    optimizer state: its third step equals JAX's third step.  The key
    part of ``qkv_bias`` has an exactly zero gradient (softmax ignores a
    shift shared by a row's scores), so both sides see only rounding
    noise there; a large ``epsilon`` keeps Adam from scaling that noise
    up to full-size steps in opposite directions."""
    jm, tm = _pair(seed=1)
    jc, tc = _crits()
    x, y = synthetic_corpus(4, SEQ, VOCAB, seed=8)
    kw = dict(learning_rate=1e-2, epsilon=1e-3)
    jstep = jax.jit(jax_train_step(jm, jc, joptim.Adam(**kw)))
    params = jm.parameters()[0]
    state = joptim.Adam().init_state(params)
    for i in range(2):
        params, _, state, _ = jstep(params, (), state, jnp.asarray(x[i:i + 2]),
                                    jnp.asarray(y[i:i + 2]),
                                    jax.random.PRNGKey(i))
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    adam = optim.Adam(**kw)
    load_jax_opt_state(adam, state, device="cpu")
    params, _, _, want_loss = jstep(params, (), state, jnp.asarray(x[2:4]),
                                    jnp.asarray(y[2:4]),
                                    jax.random.PRNGKey(2))
    step = optim.make_train_step(tm, tc, adam)
    new_state, loss = step(adam.state, torch.from_numpy(x[2:4]),
                           torch.from_numpy(y[2:4]))
    assert new_state["neval"] == 3
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _close_params(tm, params, 1e-5)


# --------------------------------------------------------------------------- #
# The recipe
# --------------------------------------------------------------------------- #

def test_transformer_train_recipe_runs_on_the_cpu():
    opt = run.main(["transformer-train", "--device", "cpu", "--size", "tiny",
                    "--vocab", "512", "--seq-len", "32", "-b", "4",
                    "--maxIteration", "3", "--synthN", "64"])
    assert opt.driver_state["neval"] == 4
    assert np.isfinite(opt.driver_state["loss"])
    # --sp and --pp are ported (tests/test_torch_strategy_facade.py,
    # test_torch_pp.py); --pp 2 needs two ranks, and this is a world of one
    from bigdl_tpu_torch.utils.engine import Engine

    try:
        with pytest.raises(ValueError, match=r"device count 1 % degree 2"):
            run.main(["transformer-train", "--device", "cpu", "--pp", "2"])
    finally:
        Engine.reset()


def test_transformer_train_recipe_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["transformer-train", "--size", "tiny", "--vocab", "512",
                  "--seq-len", "32", "-b", "4", "--maxIteration", "1",
                  "--synthN", "8"])
