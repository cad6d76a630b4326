"""Every optim method, learning-rate schedule, ``Fused``,
``CompositeOptimMethod`` (and ``set_optim_methods``), the optimizer-state
bridge, the output-reading triggers and ``set_sync_every`` of the port
against the JAX package's (``bigdl_tpu/optim/optim_method.py``,
``trigger.py``, ``local_optimizer.py``), on the CPU.

Inputs come from numpy seeds.  An update runs 12 steps, enough to cross
every milestone, epoch (3 steps an epoch) and segment edge of the
schedules below; after each step the parameters, every state slot,
``neval`` and the learning rate are held to 1e-6 relative (fp32, the
same formulas; ``pow`` and the divisions may round one ulp apart).
Training through ``LocalOptimizer`` is held to 1e-5 (sums through a
model in another order).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.flatten_util import ravel_pytree

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
from bigdl_tpu.dataset import array_dataset as jax_array_dataset
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.optim import LocalOptimizer as JaxLocalOptimizer
from bigdl_tpu.optim import Trigger as JaxTrigger
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_opt_state, load_jax_params
from bigdl_tpu_torch.optim import optim_method as tom
from bigdl_tpu_torch.utils.errors import ConfigurationError

TOL = dict(atol=1e-6, rtol=1e-6)
STEPS, STEPS_PER_EPOCH = 12, 3

#: (class name, kwargs): every method, with its options switched on
METHODS = [
    ("SGD", dict(learning_rate=0.1)),
    ("SGD", dict(learning_rate=0.1, learning_rate_decay=0.3,
                 weight_decay=0.01, momentum=0.9, dampening=0.2)),
    ("SGD", dict(learning_rate=0.05, momentum=0.9, dampening=0.0,
                 nesterov=True)),
    ("Adam", dict(learning_rate=0.01, learning_rate_decay=0.5, beta1=0.8,
                  beta2=0.99, epsilon=1e-6, weight_decay=0.02)),
    ("ParallelAdam", dict(learning_rate=0.01)),
    ("Adagrad", dict(learning_rate=0.1)),
    ("Adagrad", dict(learning_rate=0.1, learning_rate_decay=0.2,
                     weight_decay=0.01)),
    ("Adadelta", dict()),
    ("Adadelta", dict(decay_rate=0.8, epsilon=1e-6)),
    ("RMSprop", dict(learning_rate=0.01)),
    ("RMSprop", dict(learning_rate=0.01, learning_rate_decay=0.1,
                     decay_rate=0.9, epsilon=1e-6)),
    ("Adamax", dict(learning_rate=0.02)),
    ("Adamax", dict(learning_rate=0.02, beta1=0.8, beta2=0.99,
                    epsilon=1e-8)),
    ("Ftrl", dict(learning_rate=0.1)),
    ("Ftrl", dict(learning_rate=0.1, learning_rate_power=-0.7,
                  initial_accumulator_value=0.2,
                  l1_regularization_strength=0.01,
                  l2_regularization_strength=0.02,
                  l2_shrinkage_regularization_strength=0.03)),
]
METHOD_IDS = [f"{n}-{i}" for i, (n, _) in enumerate(METHODS)]


def _schedules(mod):
    """Every schedule of ``mod`` (the JAX or the port module), built
    alike, crossing its edges within 12 steps of 3 an epoch."""
    seq = mod.SequentialSchedule()
    seq.add(mod.Warmup(0.02), 4).add(mod.Poly(1.0, 6), 6) \
        .add(mod.Step(2, 0.5), 100)
    return {
        "Default": mod.Default(0.1),
        "Step": mod.Step(4, 0.5),
        "MultiStep": mod.MultiStep([3, 7, 10], 0.5),
        "Poly": mod.Poly(2.0, 10),
        "Exponential": mod.Exponential(4, 0.5),
        "Exponential-stair": mod.Exponential(4, 0.5, stair_case=True),
        "NaturalExp": mod.NaturalExp(3, 0.3),
        "EpochDecayWithWarmUp": mod.EpochDecayWithWarmUp(
            4, 0.01, STEPS_PER_EPOCH, decay_epochs=(2, 3)),
        "EpochSchedule": mod.EpochSchedule(
            [(1, 1, 0.1), (2, 3, 0.05), (4, 10, 0.01)], STEPS_PER_EPOCH),
        "EpochDecay": mod.EpochDecay(lambda e: e // 2, STEPS_PER_EPOCH,
                                     max_epoch=10),
        "EpochStep": mod.EpochStep(2, 0.5, STEPS_PER_EPOCH),
        "Plateau": mod.Plateau(),
        "Warmup": mod.Warmup(0.01),
        "SequentialSchedule": seq,
    }


SCHEDULES = list(_schedules(jom))


def _params(seed, nested=False):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    if nested:
        params = {"block10": params,
                  "block2": {"w": rng.standard_normal((3, 2)).astype(
                      np.float32)},
                  "a": rng.standard_normal(4).astype(np.float32)}
    return params


def _grads(params, rng):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.1)
                        .astype(np.float32), params)


def _named(tree, prefix=""):
    """Nested dict -> ``{"block10.w": leaf}`` (the port's names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            _named(tree).items()}


def _close_state(ts, js, prefix=""):
    """Every slot of a port state against the JAX state tree (a
    composite's subtree: its slots under the subtree's ``prefix``)."""
    assert set(ts) == set(js)
    assert ts["neval"].dtype == torch.int32 and ts["neval"].dim() == 0
    for slot, want in js.items():
        got = ts[slot]
        if isinstance(want, dict):
            want = _named(want, prefix)
            assert set(got) == set(want), slot
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(
                    want[k]), err_msg=f"{slot}.{k}", **TOL)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=slot, **TOL)


def _close_params(tp, jp):
    want = _named(jp)
    for k in want:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def _jax_lr(name, kw, jmeth, js):
    """The rate the JAX update uses: ``get_learning_rate`` for SGD, the
    decayed rate of Adam, Adagrad and RMSprop (their JAX
    ``get_learning_rate`` returns the base rate), the base otherwise."""
    if name == "SGD":
        return float(jmeth.get_learning_rate(js))
    if name in ("Adam", "ParallelAdam", "Adagrad", "RMSprop"):
        return float(kw.get("learning_rate", 1e-3) / (
            1.0 + js["neval"].astype(jnp.float32)
            * kw.get("learning_rate_decay", 0.0)))
    return float(jmeth.get_learning_rate(js))


def _run_pair(jmeth, tmeth, params, seed, lr_of=None):
    """12 updates on the same gradients through both; everything held
    after each."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(jnp.asarray, params)
    js = jmeth.init_state(jp)
    tp = _port(params)
    ts = tmeth.init_state(tp)
    update = jax.jit(jmeth.update)
    for _ in range(STEPS):
        if lr_of is not None:
            got = tmeth.get_learning_rate(ts)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), lr_of(js), **TOL)
        g = _grads(params, rng)
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        tmeth.update(_port(g), ts, tp)
        assert int(ts["neval"]) == int(js["neval"])
        _close_params(tp, jp)
        _close_state(ts, jax.tree.map(np.asarray, js))
    return tp, ts, jp, js


# --------------------------------------------------------------------------- #
# Methods and schedules
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("method", METHODS, ids=METHOD_IDS)
def test_method_matches_jax_over_12_steps(method):
    name, kw = method
    jm = getattr(jom, name)(**kw)
    _run_pair(jm, getattr(tom, name)(**kw), _params(len(kw)), 3,
              lambda js: _jax_lr(name, kw, jm, js))


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_matches_jax_over_12_steps(sched):
    """SGD with momentum under each schedule: the rate before every step
    (epoch, milestone and segment edges crossed) and the update."""
    jm = jom.SGD(learning_rate=0.1, momentum=0.9,
                 learning_rate_schedule=_schedules(jom)[sched])
    tm = tom.SGD(learning_rate=0.1, momentum=0.9,
                 learning_rate_schedule=_schedules(tom)[sched])
    _run_pair(jm, tm, _params(7), 5,
              lambda js: float(jm.get_learning_rate(js)))


@pytest.mark.parametrize("sched", SCHEDULES)
def test_schedule_values_at_every_step(sched):
    """The schedule alone at steps 0-40, past every table's end, as a
    function of a 0-d fp32 step tensor."""
    js, ts = _schedules(jom)[sched], _schedules(tom)[sched]
    ts.place("cpu")
    for step in range(41):
        want = float(js(jnp.float32(step), 0.1))
        got = ts(torch.tensor(float(step)), 0.1)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, err_msg=str(step),
                                   **TOL)


def test_sgd_takes_a_schedule_and_no_host_scalar():
    """The rate and neval are device tensors: the update reads no Python
    number that changes from step to step."""
    tm = tom.SGD(learning_rate=0.1,
                 learning_rate_schedule=tom.MultiStep([1, 2], 0.5))
    params = _port(_params(1))
    state = tm.init_state(params)
    assert state["neval"].dtype == torch.int32
    neval = state["neval"]
    rates = []
    for _ in range(3):
        rates.append(float(tm.get_learning_rate(state)))
        tm.update({k: torch.ones_like(p) for k, p in params.items()}, state,
                  params)
    assert state["neval"] is neval and int(neval) == 3   # in place
    np.testing.assert_allclose(rates, [0.1, 0.05, 0.025], **TOL)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_record_matches_jax(mode):
    """``record`` sequences: the factor in the state (written in place on
    the port) and the rate after each, against JAX's returned states."""
    values = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.8, 0.85, 0.86, 0.9, 0.9,
              0.9, 0.9, 0.95, 0.99]
    if mode == "max":
        values = [-v for v in values]
    kw = dict(factor=0.5, patience=2, mode=mode, cooldown=1, min_lr=0.02)
    jm = jom.SGD(learning_rate=0.1,
                 learning_rate_schedule=jom.Plateau(**kw))
    tm = tom.SGD(learning_rate=0.1,
                 learning_rate_schedule=tom.Plateau(**kw))
    params = _params(2)
    js = jm.init_state(jax.tree.map(jnp.asarray, params))
    ts = tm.init_state(_port(params))
    factor = ts["lr_factor"]
    jm.get_learning_rate(js)      # the schedule records its base rate
    tm.get_learning_rate(ts)
    for v in values:
        js = jm.schedule.record(v, js)
        assert tm.schedule.record(v, ts) is ts
        assert ts["lr_factor"] is factor      # the same device tensor
        np.testing.assert_allclose(float(factor), float(js["lr_factor"]),
                                   **TOL)
        np.testing.assert_allclose(float(tm.get_learning_rate(ts)),
                                   float(jm.get_learning_rate(js)), **TOL)
        assert (tm.schedule.wait, tm.schedule.cooldown_counter) == \
            (jm.schedule.wait, jm.schedule.cooldown_counter)
    assert float(factor) < 1.0


def test_optimize_facade_matches_jax():
    """``optimize(feval, x)`` on one tensor: a quadratic's loss and x."""
    a = np.linspace(-1, 1, 6).astype(np.float32)

    def jf(x):
        return jnp.sum((x - a) ** 2), 2 * (x - a)

    def tf(x):
        return float(((x - torch.from_numpy(a)) ** 2).sum()), \
            2 * (x - torch.from_numpy(a))

    jm, tm = jom.Adam(learning_rate=0.1), tom.Adam(learning_rate=0.1)
    jx, tx = jnp.zeros(6), torch.zeros(6)
    for _ in range(5):
        jx, jl = jm.optimize(jf, jx)
        tx, tl = tm.optimize(tf, tx)
        np.testing.assert_allclose(tl, float(jl), **TOL)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


# --------------------------------------------------------------------------- #
# Fused
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("method", METHODS, ids=METHOD_IDS)
def test_fused_matches_jax_flat_layout(method):
    """``Fused(inner)`` on a nested tree whose keys sort differently from
    their insertion order ("block10" < "block2"): the flat state equals
    JAX's ``ravel_pytree`` layout position by position."""
    name, kw = method
    params = _params(11, nested=True)
    flat, _ = ravel_pytree(params)
    names = _named(params)
    order = tom.ravel_order(names)
    np.testing.assert_array_equal(
        np.concatenate([np.ravel(names[k]) for k in order]),
        np.asarray(flat))
    jm = jom.Fused(getattr(jom, name)(**kw))
    tm = tom.Fused(getattr(tom, name)(**kw))
    _, ts, _, js = _run_pair(jm, tm, params, 4)
    for slot in tm.slots:
        assert ts[slot].shape == (flat.size,)


def test_fused_refusals_match_jax():
    for mod in (jom, tom):
        with pytest.raises(TypeError, match="elementwise OptimMethod, got "
                                            "Fused"):
            mod.Fused(mod.Fused(mod.SGD()))
        with pytest.raises(TypeError, match="elementwise OptimMethod, got "
                                            "CompositeOptimMethod"):
            mod.Fused(mod.CompositeOptimMethod([]))
    with pytest.raises(TypeError, match="uniform param dtype"):
        jom.Fused(jom.Adam()).init_state(
            {"a": jnp.zeros(3), "b": jnp.zeros(2, jnp.bfloat16)})
    with pytest.raises(TypeError, match="uniform param dtype"):
        tom.Fused(tom.Adam()).init_state(
            {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.bfloat16)})


# --------------------------------------------------------------------------- #
# CompositeOptimMethod and set_optim_methods
# --------------------------------------------------------------------------- #

class _Net(nn.Container):
    """The JAX tests' ``Sequential(features: Linear + ReLU, classifier:
    Linear)``, under its parameter keys."""

    def __init__(self):
        super().__init__()
        self.add("0", nn.Container(name="features")).add(
            "0", nn.Linear(8, 16))
        self.add("1", nn.Container(name="classifier")).add(
            "0", nn.Linear(16, 4))

    def forward(self, x):
        h = torch.relu(getattr(self, "0").get_submodule("0")(x))
        return getattr(self, "1").get_submodule("0")(h)


def _jax_net():
    m = (jnn.Sequential()
         .add(jnn.Sequential(name="features").add(jnn.Linear(8, 16))
              .add(jnn.ReLU()))
         .add(jnn.Sequential(name="classifier").add(jnn.Linear(16, 4))))
    m.build(jax.ShapeDtypeStruct((2, 8), jnp.float32),
            rng=jax.random.PRNGKey(3))
    return m


class _Summary:
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append(float(value))


def _jax_run(model, crit, data, batch, method, steps, methods=None,
             sync_every=1, trigger=None):
    opt = JaxLocalOptimizer(
        model, jax_array_dataset(*data) >> JaxToMiniBatch(batch), crit,
        method)
    if methods:
        opt.set_optim_methods(methods)
    if sync_every != 1:
        opt.set_sync_every(sync_every)
    opt.set_end_when(trigger or JaxTrigger.max_iteration(steps))
    summary = _Summary()
    opt.set_train_summary(summary)
    opt.optimize()
    return opt, summary


def _port_run(model, crit, data, batch, method, steps, methods=None,
              sync_every=1, trigger=None):
    opt = optim.Optimizer(
        model, array_dataset(*data) >> SampleToMiniBatch(batch), crit,
        method, device="cpu")
    if methods:
        opt.set_optim_methods(methods)
    if sync_every != 1:
        opt.set_sync_every(sync_every)
    opt.set_end_when(trigger or optim.Trigger.max_iteration(steps))
    summary = _Summary()
    opt.set_train_summary(summary)
    opt.optimize()
    return opt, summary


def _close_trees(tm, jax_params, tol):
    want = {k: v for k, v in _named(jax.tree.map(np.asarray,
                                                 jax_params)).items()
            if isinstance(v, np.ndarray)}       # a ReLU's empty entry
    got = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=tol,
                                   err_msg=k)


def test_set_optim_methods_matches_jax():
    """SGD with momentum for "features", Adam for "classifier", resolved
    by name on both: per-step losses, rates and the weights after 4
    steps."""
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((16, 8)).astype(np.float32),
            rng.integers(0, 4, 16).astype(np.int32))
    jm = _jax_net()
    tm = _Net()
    tree = jax.tree.map(np.asarray, jm.parameters()[0])
    del tree["0"]["1"]                  # the ReLU's empty entry
    tm.load_parameters_tree(tree)

    def methods(mod):
        return {"features": mod.SGD(learning_rate=0.2, momentum=0.9,
                                    dampening=0.0),
                "classifier": mod.Adam(learning_rate=0.01)}

    jopt, js = _jax_run(jm, jnn.CrossEntropyCriterion(), data, 4, None, 4,
                        methods(jom))
    topt, ts = _port_run(tm, nn.CrossEntropyCriterion(), data, 4, None, 4,
                         methods(tom))
    assert isinstance(topt.optim_method, tom.CompositeOptimMethod)
    assert [(n, p) for n, p, _ in topt.optim_method.assignments] == \
        [(n, p) for n, p, _ in jopt.optim_method.assignments]
    assert set(ts.scalars) == set(js.scalars) >= {
        "LearningRate/features", "LearningRate/classifier"}
    for tag in ("Loss", "LearningRate/features", "LearningRate/classifier"):
        np.testing.assert_allclose(ts.scalars[tag], js.scalars[tag],
                                   rtol=1e-5, atol=1e-6, err_msg=tag)
    _close_trees(tm, jm.parameters()[0], 1e-5)


def _lm_pair(seed=0):
    jm = JaxLM(64, 32, 4, 2, max_len=16)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32),
             rng=jax.random.PRNGKey(seed))
    tm = nn.TransformerLM(64, 32, 4, 2, max_len=16, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _lm_data(n=8, t=16, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (n, t)).astype(np.int32),
            rng.integers(0, 64, (n, t)).astype(np.int32))


def _lm_crits():
    return (jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion()),
            nn.TimeDistributedCriterion(nn.CrossEntropyCriterion()))


def test_composite_on_transformer_lm_matches_jax():
    """SGD for the embedding table ``wte``, Adam for every other subtree:
    ``wte``, ``wpe`` and ``head`` are the model's own leaves, which no
    submodule name addresses, so the method is built from paths.  Losses,
    the per-assignment rates and the weights after 4 steps, to 1e-5."""
    jm, tm = _lm_pair()
    jc, tc = _lm_crits()

    def composite(mod):
        # the key part of qkv_bias has an exactly zero gradient, so both
        # sides see rounding noise there; a large epsilon keeps Adam from
        # scaling it up to full-size steps
        adam = mod.Adam(learning_rate=1e-2, epsilon=1e-3)
        return mod.CompositeOptimMethod(
            [("embedding", ("wte",), mod.SGD(learning_rate=0.5,
                                             momentum=0.9)),
             *((k, (k,), adam) for k in ("wpe", "head", "block0", "block1",
                                         "ln_f"))])

    _, js = _jax_run(jm, jc, _lm_data(), 2, composite(jom), 4)
    topt, ts = _port_run(tm, tc, _lm_data(), 2, composite(tom), 4)
    assert set(ts.scalars) == set(js.scalars)
    for tag in js.scalars:
        if tag != "Throughput":
            np.testing.assert_allclose(ts.scalars[tag], js.scalars[tag],
                                       rtol=1e-5, atol=1e-6, err_msg=tag)
    _close_trees(tm, jm.parameters()[0], 1e-5)
    state = topt.optim_method.state
    assert sorted(state) == sorted(["wte", "wpe", "head", "block0",
                                    "block1", "ln_f"])
    assert isinstance(state["wte"]["velocity"], torch.Tensor)


def _refusal_cases(mod, model):
    block = model.blocks[0]
    others = {str(b.name): mod.Adam() for b in model.blocks}
    return {
        "unknown": ({"nope": mod.SGD()}, "no submodule named 'nope'"),
        "overlap": ({str(block.name): mod.SGD(),
                     str(block.attn.name): mod.SGD()}, "overlap"),
        "cover": ({**others, str(model.ln_f.name): mod.SGD()},
                  "cover 26 of 29 parameter leaves"),
        "plateau_inside": ({str(model.ln_f.name): mod.SGD(
            learning_rate_schedule=mod.Plateau())},
            "Plateau-style schedule inside"),
    }


@pytest.mark.parametrize("case", ["unknown", "overlap", "cover",
                                  "plateau_inside", "plateau_beside"])
def test_set_optim_methods_refusals_match_jax(case):
    """On a tiny TransformerLM both packages refuse alike.  The embedding
    tables are the model's own leaves, so no set of submodule names
    covers it."""
    jm, tm = _lm_pair()
    jc, tc = _lm_crits()
    if case == "plateau_beside":
        want = "silently never fire"
        jmethods = {str(jm.ln_f.name): jom.SGD()}
        tmethods = {str(tm.ln_f.name): tom.SGD()}
        jmeth = jom.SGD(learning_rate_schedule=jom.Plateau())
        tmeth = tom.SGD(learning_rate_schedule=tom.Plateau())
    else:
        jmethods, want = _refusal_cases(jom, jm)[case]
        tmethods, _ = _refusal_cases(tom, tm)[case]
        jmeth = tmeth = None
    with pytest.raises(ValueError, match=want):
        _jax_run(jm, jc, _lm_data(), 2, jmeth, 1, jmethods)
    with pytest.raises(ConfigurationError, match=want):
        _port_run(tm, tc, _lm_data(), 2, tmeth, 1, tmethods)


# --------------------------------------------------------------------------- #
# The optimizer-state bridge
# --------------------------------------------------------------------------- #

def _bridge_methods(mod):
    return {
        "SGD-momentum": mod.SGD(learning_rate=0.1, momentum=0.9),
        "SGD-plateau": mod.SGD(learning_rate=0.1,
                               learning_rate_schedule=mod.Plateau()),
        "Adam": mod.Adam(learning_rate=0.01),
        "ParallelAdam": mod.ParallelAdam(learning_rate=0.01),
        "Adagrad": mod.Adagrad(learning_rate=0.1),
        "Adadelta": mod.Adadelta(),
        "RMSprop": mod.RMSprop(learning_rate=0.01),
        "Adamax": mod.Adamax(),
        "Ftrl": mod.Ftrl(learning_rate=0.1, l1_regularization_strength=0.01),
        "Fused-Adam": mod.Fused(mod.Adam(learning_rate=0.01)),
        "Fused-SGD": mod.Fused(mod.SGD(learning_rate=0.1, momentum=0.9)),
        "Composite": mod.CompositeOptimMethod(
            [("a", ("a",), mod.SGD(learning_rate=0.1, momentum=0.9)),
             ("big", ("block10",), mod.Fused(mod.Adam(learning_rate=0.01))),
             ("small", ("block2",), mod.Adagrad(learning_rate=0.1))]),
    }


@pytest.mark.parametrize("name", list(_bridge_methods(jom)))
def test_state_bridge_continues_like_jax(name):
    """A JAX state after 3 updates loads (``neval`` a device int32, every
    slot by name, ``Fused``'s flat vectors by position, a composite's
    states per subtree, ``lr_factor``) and 4 more updates through the port
    equal JAX continuing."""
    params = _params(21, nested=True)
    jmeth, tmeth = _bridge_methods(jom)[name], _bridge_methods(tom)[name]
    rng = np.random.default_rng(9)
    jp = jax.tree.map(jnp.asarray, params)
    js = jmeth.init_state(jp)
    update = jax.jit(jmeth.update)
    for _ in range(3):
        jp, js = update(jax.tree.map(jnp.asarray, _grads(params, rng)), js,
                        jp)
    if name == "SGD-plateau":
        jmeth.get_learning_rate(js)
        for v in (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                  1.0):
            js = jmeth.schedule.record(v, js)
        assert float(js["lr_factor"]) < 1.0
    tp = _port(jax.tree.map(np.asarray, jp))
    ts = load_jax_opt_state(tmeth, jax.tree.map(np.asarray, js),
                            device="cpu")
    assert tmeth.state is ts
    sub = [ts[k] for k in ts] if name == "Composite" else [ts]
    assert all(s["neval"].dtype == torch.int32 and int(s["neval"]) == 3
               for s in sub)
    for _ in range(4):
        g = _grads(params, rng)
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        tmeth.update(_port(g), ts, tp)
        _close_params(tp, jp)
        if name == "Composite":
            for key in js:
                _close_state(ts[key], jax.tree.map(np.asarray, js[key]),
                             key.replace("/", ".") + ".")
        else:
            _close_state(ts, jax.tree.map(np.asarray, js))


@pytest.mark.parametrize("scan_layers", [False, True],
                         ids=["unrolled", "scan_layers"])
def test_fused_state_bridge_on_transformer_lm_continues_like_jax(
        scan_layers):
    """``Fused(Adam)`` on a tiny JAX ``TransformerLM`` in either layout:
    after 3 updates its state loads with the parameter tree
    (``jax_params``), and 4 more updates through the port on the unrolled
    parameters equal JAX continuing, the flat ``m`` and ``v`` equal to
    JAX's laid out over the unrolled tree.  In the ``scan_layers`` layout
    the flat order differs from the unrolled one, so loading by position
    alone would pair the moments with the wrong parameters."""
    from bigdl_tpu_torch.interop.jax_params import _reravel, to_port_tree

    def _unrolled_ravel(flat, tree):
        return _reravel(flat, tree, scanned=False)

    jm = JaxLM(64, 16, 2, 3, max_len=8, scan_layers=scan_layers)
    jm.build(jax.ShapeDtypeStruct((2, 8), jnp.int32),
             rng=jax.random.PRNGKey(4))
    jp = jm.parameters()[0]
    params = jax.tree.map(np.asarray, jp)
    jmeth = jom.Fused(jom.Adam(learning_rate=0.01))
    tmeth = tom.Fused(tom.Adam(learning_rate=0.01))
    rng = np.random.default_rng(5)
    js = jmeth.init_state(jp)
    update = jax.jit(jmeth.update)
    for _ in range(3):
        jp, js = update(jax.tree.map(jnp.asarray, _grads(params, rng)), js,
                        jp)
    unrolled = {k: np.asarray(v) for k, v in
                _named(to_port_tree(jax.tree.map(np.asarray, jp))).items()}
    in_unrolled_order = np.concatenate(
        [unrolled[k].ravel() for k in tom.ravel_order(unrolled)])
    flat_p = np.asarray(ravel_pytree(jp)[0])
    assert np.array_equal(flat_p, in_unrolled_order) != scan_layers
    np.testing.assert_array_equal(_unrolled_ravel(flat_p, jp),
                                  in_unrolled_order)
    tp = {k: torch.from_numpy(v.copy()) for k, v in unrolled.items()}
    ts = load_jax_opt_state(tmeth, jax.tree.map(np.asarray, js),
                            device="cpu", jax_params=jp)
    assert int(ts["neval"]) == 3
    for _ in range(4):
        g = _grads(params, rng)
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        tmeth.update(_port(to_port_tree(g)), ts, tp)
        _close_params(tp, to_port_tree(jax.tree.map(np.asarray, jp)))
        for slot in ("m", "v"):
            np.testing.assert_allclose(
                ts[slot].numpy(), _unrolled_ravel(js[slot], jp),
                err_msg=slot, **TOL)
        assert int(ts["neval"]) == int(js["neval"])


def test_state_bridge_refuses_a_mismatched_state():
    js = jom.Adagrad().init_state({"w": jnp.zeros(3)})
    with pytest.raises(KeyError, match=r"missing \['accum_dx', 'accum_g'\]"):
        load_jax_opt_state(tom.Adadelta(), js, device="cpu")
    js = jom.SGD(learning_rate_schedule=jom.Plateau()).init_state(
        {"w": jnp.zeros(3)})
    with pytest.raises(KeyError, match=r"unexpected \['lr_factor'\]"):
        load_jax_opt_state(tom.SGD(), js, device="cpu")


# --------------------------------------------------------------------------- #
# Triggers and set_sync_every
# --------------------------------------------------------------------------- #

def _trigger_cases(T):
    return {
        "min_loss": T.min_loss(0.5),
        "max_score": T.max_score(0.9),
        "and": T.and_(T.max_iteration(3), T.min_loss(0.5)),
        "or": T.or_(T.max_epoch(2), T.max_score(0.9)),
        "or_stateful": T.or_(T.every_epoch(), T.max_iteration(5)),
        "and_count": T.and_(T.several_iteration(2), T.max_epoch(1)),
    }


@pytest.mark.parametrize("case", list(_trigger_cases(optim.Trigger)))
def test_output_triggers_match_jax(case):
    jt = _trigger_cases(JaxTrigger)[case]
    tt = _trigger_cases(optim.Trigger)[case]
    assert (tt.stateful, tt.uses_outputs) == (jt.stateful, jt.uses_outputs)
    states = [{"epoch": e, "neval": n, "loss": lo, "score": sc}
              for e in (1, 2, 3) for n in (1, 4, 6)
              for lo in (0.3, 0.7) for sc in (0.5, 0.95)]
    states += [{"epoch": 1, "neval": 1}]     # no loss or score yet
    assert [tt(s) for s in states] == [jt(s) for s in states]


@pytest.mark.parametrize("sync_every", [1, 3])
def test_sync_every_matches_jax(sync_every):
    """``set_sync_every(k)``: the published losses (stale between syncs,
    as JAX's) and the weights equal JAX's, and the last driver loss is
    the drained, fresh one."""
    jm, tm = _lm_pair(1)
    jc, tc = _lm_crits()
    jopt, js = _jax_run(jm, jc, _lm_data(), 2, jom.SGD(learning_rate=0.5),
                        7, sync_every=sync_every)
    topt, ts = _port_run(tm, tc, _lm_data(), 2, tom.SGD(learning_rate=0.5),
                         7, sync_every=sync_every)
    assert topt._effective_sync_every() == sync_every
    np.testing.assert_allclose(ts.scalars["Loss"], js.scalars["Loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(topt.driver_state["loss"],
                               jopt.driver_state["loss"], rtol=1e-5)
    _close_trees(tm, jm.parameters()[0], 1e-5)
    if sync_every == 3:   # steps 2, 3 repeat step 1's loss; 5, 6 step 4's
        lo = ts.scalars["Loss"]
        assert lo[0] == lo[1] == lo[2] and lo[3] == lo[4] == lo[5]


def test_sync_every_falls_back_to_1_under_min_loss():
    jm, tm = _lm_pair(1)
    jc, tc = _lm_crits()
    trig = optim.Trigger.or_(optim.Trigger.max_iteration(5),
                             optim.Trigger.min_loss(-1.0))
    jtrig = JaxTrigger.or_(JaxTrigger.max_iteration(5),
                           JaxTrigger.min_loss(-1.0))
    jopt, js = _jax_run(jm, jc, _lm_data(), 2, jom.SGD(learning_rate=0.5),
                        5, sync_every=3, trigger=jtrig)
    topt, ts = _port_run(tm, tc, _lm_data(), 2, tom.SGD(learning_rate=0.5),
                         5, sync_every=3, trigger=trig)
    assert topt._effective_sync_every() == jopt._effective_sync_every() == 1
    lo = ts.scalars["Loss"]
    assert len(set(lo)) == len(lo) == 5        # every step fresh
    np.testing.assert_allclose(lo, js.scalars["Loss"], rtol=1e-5)
    with pytest.raises(ValueError, match="sync_every must be >= 1"):
        topt.set_sync_every(0)
    assert math.isfinite(topt.driver_state["loss"])
