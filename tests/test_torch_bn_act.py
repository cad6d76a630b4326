"""K7's plain version (``ops/bn_act.py``: eval-mode BatchNorm, an optional
residual add and an optional ReLU in one call) against the JAX package's
``SpatialBatchNormalization.apply`` (eval), ``ReLU`` and ``CAddTable``, on
the CPU, from numpy seeds; the int8 twin's fused eval plan
(``nn/fused.py``) against the same twin unfused; the wrapper's card path
through a stand-in library (no card here).

Tolerances:

- fp32: 1e-6 relative, with a floor of 1e-6 of the output's largest
  magnitude (where ``x * s`` and ``t`` cancel): the two packages take
  ``rsqrt`` from different CPU libraries, an ulp apart at most;
- bf16: 1e-2 relative of the largest magnitude: the port rounds to bf16
  after every operation, as PyTorch's bf16 kernels do, while XLA on the
  CPU may compute a chain of bf16 operations in fp32 and round once, so
  the two differ by about one bf16 ulp (2^-8);
- the fused plan against the unfused twin: bitwise (on the CPU the plan
  runs K7's plain version, the modules' own operations).
"""

import copy
import pickle
import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import fused
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import act_quant as k6q
from bigdl_tpu_torch.ops import bn_act as k7

#: the forms K7 takes: (residual, the residual's own BatchNorm, ReLU)
FORMS = {"bn": (False, False, False), "bn_relu": (False, False, True),
         "bn_add_relu": (True, False, True),
         "bn_bn_add_relu": (True, True, True)}


def _stats(c, rng):
    return {"running_mean": rng.standard_normal(c).astype(np.float32),
            "running_var": rng.uniform(0.05, 3.0, c).astype(np.float32),
            "weight": rng.uniform(-2, 2, c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}


def _port_bn(c, st):
    bn = nn.SpatialBatchNormalization(c)
    with torch.no_grad():
        for k, v in st.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    return bn.to("cpu").eval()


def _jax_bn(x, st):
    bn = jnn.SpatialBatchNormalization(st["weight"].shape[0])
    params = {k: jnp.asarray(st[k]) for k in ("weight", "bias")}
    state = {k: jnp.asarray(st[k]) for k in ("running_mean", "running_var")}
    y, _ = bn.apply(params, state, x, training=False)
    return y


def _jax_k7(x, st, r, rst, relu):
    y = _jax_bn(x, st)
    if r is not None:
        y, _ = jnn.CAddTable().apply((), (), (y, r if rst is None else
                                              _jax_bn(r, rst)))
    if relu:
        y, _ = jnn.ReLU().apply((), (), y)
    return y


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    scale = np.abs(want[~nan]).max() if (~nan).any() else 1.0
    if dtype == "float32":
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-6,
                                   atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=0,
                                   atol=1e-2 * scale)


def _k7_against_jax(x, st, r, rst, relu, dtype):
    c = x.shape[-1]
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    rt = None if r is None else torch.from_numpy(r).to(tdt)
    with torch.no_grad():
        y = k7.bn_act(xt, _port_bn(c, st), rt,
                      None if rst is None else _port_bn(c, rst), relu,
                      absmax=True)
    jdt = getattr(jnp, dtype)
    want = _jax_k7(jnp.asarray(x).astype(jdt), st,
                   None if r is None else jnp.asarray(r).astype(jdt), rst,
                   relu)
    assert y.dtype == tdt and y.shape == xt.shape
    _close(y.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype)
    # the absmax K7 hands to K6q is the plain max |y|
    route, absmax = k6q.select_route(y)
    assert route == "act_quant_given"
    assert absmax.view(torch.float32).item() == \
        y.float().abs().amax().item() or torch.isnan(y).any()
    return y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 64, 100])
@pytest.mark.parametrize("form", list(FORMS))
def test_plain_k7_matches_jax(form, c, dtype):
    has_r, has_rbn, relu = FORMS[form]
    rng = np.random.default_rng([list(FORMS).index(form), c,
                                 dtype == "bfloat16"])
    x = (rng.standard_normal((2, 5, 7, c)) * 3).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32) if has_r else None
    _k7_against_jax(x, _stats(c, rng), r,
                    _stats(c, rng) if has_rbn else None, relu, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_and_negative_zero_through_the_relu(dtype):
    """A NaN stays NaN through the ReLU (``fmaxf`` alone would drop it);
    mean 0 and bias -0.0 give a shift of -0.0, so x = -0.0 reaches the
    ReLU as -0.0 in the channels whose weight is positive."""
    rng = np.random.default_rng(11)
    c = 16
    st = _stats(c, rng)
    st["running_mean"][:] = 0.0
    st["bias"][:] = -0.0
    x = rng.standard_normal((2, 3, 3, c)).astype(np.float32)
    x[0, 1, 2, 3] = np.nan
    x[1, 2] = -0.0
    for relu in (True, False):
        y = _k7_against_jax(x, st, None, None, relu, dtype)
        assert torch.isnan(y[0, 1, 2, 3])
        assert (y[1, 2] == 0).all()


def test_plain_k7_is_the_modules_bitwise():
    """The plain version is BatchNorm's forward, CAddTable's add (main
    branch first) and ReLU, op for op."""
    rng = np.random.default_rng(3)
    c = 24
    bn, rbn = _port_bn(c, _stats(c, rng)), _port_bn(c, _stats(c, rng))
    x = torch.from_numpy(rng.standard_normal((3, 4, 4, c), np.float32))
    r = torch.from_numpy(rng.standard_normal((3, 4, 4, c), np.float32))
    with torch.no_grad():
        want = nn.ReLU()(nn.CAddTable()((bn(x), rbn(r))))
        assert torch.equal(k7.bn_act(x, bn, r, rbn), want)
        assert torch.equal(k7.bn_act(x, bn, relu=False), bn(x))


# --------------------------------------------------------------------------- #
# The fused eval plan
# --------------------------------------------------------------------------- #

def _twin(model, shape, seed=0):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.train()(torch.from_numpy(rng.standard_normal(shape,
                                                           np.float32)))
    model.eval()
    twin, _ = tq.quantize_model(model)
    return twin, torch.from_numpy(rng.standard_normal(shape, np.float32))


@pytest.fixture
def k7_calls(monkeypatch):
    calls = []
    real = k7.bn_act

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(k7, "bn_act", spy)
    return calls


def test_resnet50_plan_site_counts():
    """ResNet-50's twin, built on the CPU and not run: the stem, two
    BatchNorm + ReLU sites a bottleneck and its tail (the four projection
    shortcuts' BatchNorms folded into their tails) -- 49 K7 launches, no
    BatchNorm left to its module; the fp32 model has no plan."""
    model = tmodels.ResNet(50, 1000, device="cpu", seed=0)
    twin, _ = tq.quantize_model(model)
    n_bn = sum(isinstance(m, nn.BatchNormalization) for m in twin.modules())
    assert n_bn == 53
    assert fused.site_counts(twin) == {"fused_sites": 49, "unfused_sites": 0}
    assert fused.site_counts(model) == {"fused_sites": 0, "unfused_sites": 53}


def test_the_plan_leaves_the_trees_alone(k7_calls):
    model = tmodels.ResNetCifar(8, device="cpu", seed=0)
    twin, x = _twin(model, (2, 32, 32, 3))
    keys = (list(twin.parameters_tree()), list(twin.state_tree()),
            list(twin.state_dict()))
    with torch.no_grad():
        twin(x)
    assert k7_calls
    assert (list(twin.parameters_tree()), list(twin.state_tree()),
            list(twin.state_dict())) == keys
    assert not any("plan" in k for k in twin.state_dict())
    assert tq.model_bytes(twin.parameters_tree()) == \
        tq.model_bytes(tq.quantize_params(model))
    assert sorted(twin.parameters_tree()) == sorted(
        tq.quantize_params(model))


def test_training_mode_and_the_fp32_model_run_unfused(k7_calls):
    model = tmodels.ResNetCifar(8, device="cpu", seed=0)
    twin, x = _twin(model, (2, 32, 32, 3))
    with torch.no_grad():
        model.eval()(x)
        assert not k7_calls                  # the fp32 model: no plan
        twin.train()(x)
        assert not k7_calls                  # training mode: the modules
        twin.eval()(x)
    assert len(k7_calls) == fused.site_counts(twin)["fused_sites"] == 7


def test_statistics_loaded_in_place_change_the_next_output():
    twin, x = _twin(tmodels.ResNetCifar(8, device="cpu", seed=0),
                    (2, 32, 32, 3))
    with torch.no_grad():
        first = twin(x)
        rng = np.random.default_rng(5)
        state = {k: (v.numpy() * rng.uniform(0.5, 1.5, v.shape)).astype(
            np.float32) for k, v in dict(twin.named_buffers()).items()}
        twin.load_state_tree(_nest(state))
        second = twin(x)
        with fused.unfused():
            want = twin(x)
    assert not torch.equal(first, second)
    assert torch.equal(second, want)


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("how", ["deepcopy", "pickle"])
def test_a_copy_rebuilds_its_plan(how, k7_calls):
    twin, x = _twin(tmodels.ResNetCifar(8, device="cpu", seed=0),
                    (2, 32, 32, 3))
    with torch.no_grad():
        want = twin(x)
    other = copy.deepcopy(twin) if how == "deepcopy" else \
        pickle.loads(pickle.dumps(twin))
    plans = [m.__dict__["_fused_plan"] for m in other.modules()
             if "_fused_plan" in m.__dict__]
    assert plans and all(p.steps is None for p in plans)
    del k7_calls[:]
    with torch.no_grad():
        got = other(x)
    assert torch.equal(got, want) and len(k7_calls) == 7
    mine = {id(m) for m in other.modules()}
    for m in other.modules():
        plan = m.__dict__.get("_fused_plan")
        if plan is not None and plan.steps is not None:
            assert plan.owner() is m
            assert all(id(c) in mine for c in plan.children)


def test_a_hooked_site_runs_its_modules_and_is_counted(k7_calls):
    twin, x = _twin(tmodels.ResNetCifar(8, device="cpu", seed=0),
                    (2, 32, 32, 3))
    with torch.no_grad():
        want = twin(x)
    seen = []
    bn = next(m for m in twin.modules()
              if isinstance(m, nn.BatchNormalization))
    handle = bn.register_forward_hook(lambda m, i, o: seen.append(o.shape))
    assert fused.site_counts(twin) == {"fused_sites": 6, "unfused_sites": 1}
    del k7_calls[:]
    with torch.no_grad():
        got = twin(x)
    handle.remove()
    assert torch.equal(got, want) and len(seen) == 1 and len(k7_calls) == 6
    # a hook on a block's ConcatTable: the block runs its modules, its
    # branches' BatchNorms through their own Sequentials' plans
    concat = next(m for m in twin.modules() if type(m) is nn.ConcatTable)
    handle = concat.register_forward_hook(lambda m, i, o: None)
    counts = fused.site_counts(twin)
    del k7_calls[:]
    with torch.no_grad():
        got = twin(x)
    handle.remove()
    assert torch.equal(got, want)
    assert counts == {"fused_sites": 7, "unfused_sites": 0}
    assert len(k7_calls) == 7


def test_a_non_contiguous_input_still_takes_k7(k7_calls):
    """The route is chosen from the structure: a channels-last view that
    is not contiguous goes to K7 too (its plain version on the CPU)."""
    bn = _port_bn(8, _stats(8, np.random.default_rng(0)))
    seq = fused.attach(nn.Sequential().add(bn).add(nn.ReLU())).eval()
    x = torch.randn(4, 8, 3)
    with torch.no_grad():
        got = seq(x.permute(0, 2, 1))       # channels last, not contiguous
    assert torch.equal(got, torch.relu(bn(x.permute(0, 2, 1))))
    assert len(k7_calls) == 1


def test_a_site_on_the_card_raises_on_what_k7_does_not_take(card):
    """No way back to the modules on the card: a site whose tensor K7
    does not take raises, and launches nothing."""
    rng = np.random.default_rng(3)
    bn = _port_bn(8, _stats(8, rng))
    seq = fused.attach(nn.Sequential().add(bn).add(nn.ReLU())).eval()
    x = torch.randn(4, 8, 3)
    with torch.no_grad():
        with pytest.raises(ValueError):                   # not contiguous
            seq(x.permute(0, 2, 1))
        with pytest.raises(TypeError):                    # fp64
            seq(x.permute(0, 2, 1).contiguous().double())
        with pytest.raises(ValueError):                   # channels
            seq(torch.randn(4, 3, 8).transpose(1, 2).contiguous())
        seq(x.permute(0, 2, 1).contiguous())
    assert len(card) == 1


# --------------------------------------------------------------------------- #
# The card path, through a stand-in library
# --------------------------------------------------------------------------- #

@pytest.fixture
def card(monkeypatch):
    """The wrapper's card path on CPU tensors: every launch recorded."""
    seen = []

    def launch(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(k7, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(k7, "_stream", lambda: None)
    monkeypatch.setattr(k7, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        bigdl_bn_act=launch))
    monkeypatch.setitem(k7.LAUNCHES, "bn_act", 0)
    return seen


def test_the_wrapper_launches_k7_once(card):
    rng = np.random.default_rng(1)
    bn, rbn = _port_bn(16, _stats(16, rng)), _port_bn(16, _stats(16, rng))
    x = torch.zeros((2, 3, 5, 16), dtype=torch.bfloat16)
    y = k7.bn_act(x, bn, x.clone(), rbn, relu=True, absmax=True)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert len(card) == 1 and k7.LAUNCHES["bn_act"] == 1
    (x_ptr, r_ptr, y_ptr, n, c, dtype, mean, var, w, b, eps, r_mean, r_var,
     r_w, r_b, r_eps, relu, absmax, sms, stream) = card[0]
    assert (n, c, dtype, relu, sms) == (x.numel(), 16, 1, 1, 132)
    assert (x_ptr, y_ptr, mean, r_mean) == (
        x.data_ptr(), y.data_ptr(), bn.running_mean.data_ptr(),
        rbn.running_mean.data_ptr())
    assert eps == bn.eps and absmax == k6q.handed_off_absmax(y).data_ptr()
    k7.bn_act(x, bn)
    assert card[1][1] is None and card[1][11] is None and card[1][17] is None
    assert k6q.handed_off_absmax(k7.bn_act(x, bn)) is None


def test_the_wrapper_refuses_what_k7_does_not_take(card):
    rng = np.random.default_rng(2)
    bn = _port_bn(16, _stats(16, rng))
    x = torch.zeros((2, 3, 5, 16))
    with pytest.raises(TypeError):
        k7.bn_act(x.double(), bn)
    with pytest.raises(ValueError):                       # channels
        k7.bn_act(torch.zeros((2, 3, 5, 8)), bn)
    with pytest.raises(ValueError):                       # residual shape
        k7.bn_act(x, bn, torch.zeros((2, 3, 4, 16)))
    with pytest.raises(ValueError):                       # residual dtype
        k7.bn_act(x, bn, x.to(torch.bfloat16))
    with pytest.raises(ValueError):                       # not contiguous
        k7.bn_act(x.transpose(1, 2), bn)
    with pytest.raises(ValueError):
        k7.bn_act(x, bn, residual_bn=bn)
    wide = _port_bn(k7.MAX_CHANNELS + 4, _stats(k7.MAX_CHANNELS + 4, rng))
    with pytest.raises(ValueError):
        k7.bn_act(torch.zeros((1, k7.MAX_CHANNELS + 4)), wide)
    assert not card


def test_the_wrapper_refuses_a_device_mix():
    bn = _port_bn(4, _stats(4, np.random.default_rng(0)))
    with pytest.raises(ValueError):
        k7.bn_act(torch.zeros((2, 4), device="meta"), bn)


def test_ctypes_arity_of_bn_act():
    src = (_build.CSRC / "bn_act.cu").read_text()
    params = re.search(r"\bint bigdl_bn_act\(([^)]*)\)", src).group(1)

    class Library:
        def __getattr__(self, attr):
            fn = types.SimpleNamespace()
            setattr(self, attr, fn)
            return fn

    fn = _build._declare([Library()]).bigdl_bn_act
    assert len(fn.argtypes) == len(params.split(",")) == 20
    assert params.split(",")[-1].split() == ["void*", "stream"]
    assert _build.CSRC / "bn_act.cu" in _build.SOURCES
