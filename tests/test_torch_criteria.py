"""The criteria of ``bigdl_tpu/nn/criterion.py`` (the 14 the training
path did not need) and all 21 of ``bigdl_tpu/nn/criterion_extras.py``,
against the JAX package's on the CPU (``bigdl_tpu_torch/nn/criterion.py``,
``nn/criterion_extras.py``).

Each case draws its input and target from a numpy seed, once at random
and once with the input equal to the target (or at the loss's kink where
"equal" has no meaning: a hinge at its margin, a distance at 0), and for
every class with ``size_average`` under both settings.  The loss is held
within 1e-5 of JAX's, and ``backward`` (the gradient with respect to the
input, a tuple for table inputs) within 1e-5 of ``jax.grad``: at the
kinks that holds JAX's rules (``jnp.abs`` +1 at 0, ``jnp.maximum`` and
``jnp.clip`` splitting a tie).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn import criterion as jc
from bigdl_tpu.nn import criterion_extras as jce
from bigdl_tpu.nn import linear as jlinear
from bigdl_tpu_torch import nn

TOL = dict(rtol=1e-5, atol=1e-5)
N, F = 4, 5


def _probs(rng, *shape):
    p = rng.uniform(0.05, 1.0, shape).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _signs(rng, n=N):
    return np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _regression(rng, equal):
    x = _normal(rng, N, F)
    if equal:
        return x, x.copy()
    return x, _normal(rng, N, F)


def _unit(rng, equal):
    x = rng.uniform(0.05, 0.95, (N, F)).astype(np.float32)
    return x, x.copy() if equal else \
        rng.uniform(0.05, 0.95, (N, F)).astype(np.float32)


def _positive(rng, equal):
    x = rng.uniform(0.1, 3.0, (N, F)).astype(np.float32)
    return x, x.copy() if equal else \
        rng.uniform(0.1, 3.0, (N, F)).astype(np.float32)


def _probs_pair(rng, equal):
    x = _probs(rng, N, F)
    return x, x.copy() if equal else _probs(rng, N, F)


def _logprob_target(rng, equal):
    t = _probs(rng, N, F)
    t[0, 0] = 0.0                      # a zero target: the masked branch
    x = np.log(np.maximum(t, 1e-3)) if equal else np.log(_probs(rng, N, F))
    return x.astype(np.float32), t


def _margin(rng, equal):
    y = np.tile(_signs(rng)[:, None], (1, F))
    # equal: y * x = margin 1 exactly, the hinge's kink
    x = y.copy() if equal else _normal(rng, N, F)
    return x, y


def _hinge_embedding(rng, equal):
    y = np.tile(_signs(rng)[:, None], (1, F))
    x = np.ones((N, F), np.float32) if equal else _normal(rng, N, F)
    return x, y


def _l1cost(rng, equal):
    x = _normal(rng, N, F)
    if equal:
        x[::2] = 0.0                   # |x| at its kink
    return x, None


def _pair_table(rng, equal):
    x1 = _normal(rng, N, F)
    x2 = x1.copy() if equal else _normal(rng, N, F)
    return (x1, x2), _signs(rng)


def _multilabel(rng, equal):
    x = _normal(rng, N, F)
    t = (rng.random((N, F)) < 0.5).astype(np.float32)
    return (t.copy() if equal else x), t


def _table_regression(rng, equal):
    (a, b), (c, d) = _regression(rng, equal), _regression(rng, equal)
    return (a, c), (b, d)


def _ranking(rng, equal):
    x1 = _normal(rng, N)
    # equal: x1 == x2 puts max(0, margin - y*0) at margin 0's kink
    x2 = x1.copy() if equal else _normal(rng, N)
    return (x1, x2), _signs(rng)


def _multilabel_margin(rng, equal):
    x = _normal(rng, N, F)
    t = np.full((N, 3), -1, np.int32)
    t[:, 0] = rng.integers(0, F, N)
    t[::2, 1] = (t[::2, 0] + 1) % F
    if equal:                           # margins at 0: x_t - x_j = 1
        x = np.zeros((N, F), np.float32)
        x[np.arange(N), t[:, 0]] = 1.0
    return x, t


def _classes(rng, equal):
    t = rng.integers(0, F, N).astype(np.int32)
    x = _normal(rng, N, F)
    if equal:                           # every other class at the margin
        x = np.zeros((N, F), np.float32)
        x[np.arange(N), t] = 1.0
    return x, t


def _mean_logvar(rng, equal):
    mean, logv = _normal(rng, N, F), 0.5 * _normal(rng, N, F)
    return (mean, logv), (mean.copy() if equal else _normal(rng, N, F))


def _kld(rng, equal):
    (mean, logv), _ = _mean_logvar(rng, equal)
    if equal:
        mean, logv = np.zeros_like(mean), np.zeros_like(logv)
    return (mean, logv), None


def _masked_steps(rng, equal):
    logp = np.log(_probs(rng, 2, 3, F)).astype(np.float32)
    t = rng.integers(1, F, (2, 3)).astype(np.int32)
    t[0, 1] = t[1, 2] = 0               # padding
    return logp, t


def _simplex(rng, equal):
    t = rng.integers(0, F, N).astype(np.int32)
    x = np.eye(F, dtype=np.float32)[t] if equal else _normal(rng, N, F + 1)
    return x, t


def _box(rng, equal):
    x, t = _regression(rng, equal)
    w_in = rng.uniform(0.5, 2.0, (N, F)).astype(np.float32)
    w_out = rng.uniform(0.5, 2.0, (N, F)).astype(np.float32)
    return x, (t, w_in, w_out)


def _spatial(rng, equal):
    x = _normal(rng, 2, 3, 3, F)
    t = rng.integers(0, F, (2, 3, 3)).astype(np.int32)
    t[0, 0, 0] = 2
    return x, t


def _pg(rng, equal):
    p = _probs(rng, N, F)
    a = np.eye(F, dtype=np.float32)[rng.integers(0, F, N)]
    return p, a * _normal(rng, N, 1)


def _composite(pkg, kind):
    m = jc if pkg == "jax" else nn
    c = m.MultiCriterion() if kind == "multi" else m.ParallelCriterion()
    c.add(m.MSECriterion(), 0.5)
    c.add(m.AbsCriterion(), 2.0)
    return c


#: (class name, constructor kwargs, maker, has size_average)
CASES = [
    ("MSECriterion", {}, _regression, True),
    ("AbsCriterion", {}, _regression, True),
    ("BCECriterion", {"weights": np.linspace(0.5, 1.5, F)}, _unit, True),
    ("BCEWithLogitsCriterion", {}, _regression, True),
    ("SmoothL1Criterion", {}, _regression, True),
    ("DistKLDivCriterion", {}, _logprob_target, True),
    ("MarginCriterion", {}, _margin, True),
    ("MarginCriterion", {"squared": True, "margin": 0.5}, _margin, True),
    ("HingeEmbeddingCriterion", {}, _hinge_embedding, True),
    ("L1Cost", {}, _l1cost, False),
    ("CosineEmbeddingCriterion", {"margin": 0.1}, _pair_table, True),
    ("KullbackLeiblerDivergenceCriterion", {}, _probs_pair, False),
    ("MultiLabelSoftMarginCriterion", {"weights": np.linspace(1, 2, F)},
     _multilabel, True),
    ("MultiCriterion", {}, _regression, False),
    ("ParallelCriterion", {}, _table_regression, False),
    ("CategoricalCrossEntropy", {}, _probs_pair, False),
    ("CosineDistanceCriterion", {}, _regression, True),
    ("CosineProximityCriterion", {}, _regression, False),
    ("DiceCoefficientCriterion", {}, _unit, True),
    ("DotProductCriterion", {}, _regression, True),
    ("L1HingeEmbeddingCriterion", {"margin": 2.0}, _pair_table, False),
    ("MarginRankingCriterion", {"margin": 0.0}, _ranking, True),
    ("MeanAbsolutePercentageCriterion", {}, _regression, False),
    ("MeanSquaredLogarithmicCriterion", {}, _positive, False),
    ("MultiLabelMarginCriterion", {}, _multilabel_margin, True),
    ("MultiMarginCriterion", {}, _classes, True),
    ("MultiMarginCriterion", {"p": 2, "weights": [1, 2, 3, 4, 5],
                              "margin": 0.5}, _classes, True),
    ("PoissonCriterion", {}, _positive, False),
    ("SoftMarginCriterion", {}, _margin, True),
    ("KLDCriterion", {}, _kld, True),
    ("GaussianCriterion", {}, _mean_logvar, False),
    ("TransformerCriterion", {}, _regression, False),
    ("TimeDistributedMaskCriterion", {}, _masked_steps, False),
    ("ClassSimplexCriterion", {"n_classes": F}, _simplex, False),
    ("SmoothL1CriterionWithWeights", {"sigma": 2.0, "num": 3}, _box, False),
    ("SoftmaxWithCriterion", {"ignore_label": 2}, _spatial, False),
    ("SoftmaxWithCriterion", {"normalize_mode": "NONE"}, _spatial, False),
    ("PGCriterion", {}, _pg, True),
]


def _build(pkg, name, kwargs, size_average):
    kw = dict(kwargs)
    if size_average is not None:
        kw["size_average"] = size_average
    if name in ("MultiCriterion", "ParallelCriterion"):
        return _composite(pkg, "multi" if name == "MultiCriterion"
                          else "parallel")
    if name == "TransformerCriterion":
        return _transformer(pkg)
    if name == "TimeDistributedMaskCriterion":
        m = jc if pkg == "jax" else nn
        return (jce if pkg == "jax" else nn).TimeDistributedMaskCriterion(
            m.ClassNLLCriterion(size_average=True), padding_value=0)
    if pkg == "jax":
        cls = getattr(jc, name, None) or getattr(jce, name)
        return cls(**kw)
    return getattr(nn, name)(**kw)


_LIN_KEY = jax.random.PRNGKey(11)


def _transformer(pkg):
    """MSE between ``Linear(input)`` and ``target``, JAX's weights in
    both packages' Linear."""
    jl = jlinear.Linear(F, F)
    jl.build(jax.ShapeDtypeStruct((N, F), jnp.float32), rng=_LIN_KEY)
    if pkg == "jax":
        return jce.TransformerCriterion(jc.MSECriterion(), jl)
    tl = nn.Linear(F, F)
    tl.load_parameters_tree(jax.tree.map(np.asarray, jl.parameters()[0]))
    return nn.TransformerCriterion(nn.MSECriterion(), tl)


def _to(pkg, x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_to(pkg, e) for e in x)
    return jnp.asarray(x) if pkg == "jax" else torch.from_numpy(np.array(x))


def _ids():
    seen = {}
    out = []
    for name, *_ in CASES:
        seen[name] = seen.get(name, 0) + 1
        out.append(name if seen[name] == 1 else f"{name}-{seen[name]}")
    return out


@pytest.mark.parametrize("equal", [False, True], ids=["random", "equal"])
@pytest.mark.parametrize("case", range(len(CASES)), ids=_ids())
def test_criterion_loss_and_backward_match_jax(case, equal):
    name, kwargs, maker, has_avg = CASES[case]
    for size_average in ((True, False) if has_avg else (None,)):
        rng = np.random.default_rng(case)
        x, t = maker(rng, equal)
        jcrit = _build("jax", name, kwargs, size_average)
        tcrit = _build("port", name, kwargs, size_average)
        jl = jcrit.forward(_to("jax", x), _to("jax", t))
        tl = tcrit.forward(_to("port", x), _to("port", t))
        msg = f"{name} size_average={size_average}"
        np.testing.assert_allclose(float(tl.detach()), float(jl), err_msg=msg,
                                   **TOL)
        jg = jcrit.backward(_to("jax", x), _to("jax", t))
        tg = tcrit.backward(_to("port", x), _to("port", t))
        jg = jg if isinstance(jg, tuple) else (jg,)
        tg = tg if isinstance(tg, tuple) else (tg,)
        assert len(tg) == len(jg), msg
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=msg, **TOL)


def test_every_class_of_both_jax_files_has_a_case():
    import inspect

    names = {n for mod in (jc, jce) for n, c in vars(mod).items()
             if inspect.isclass(c) and issubclass(c, jc.Criterion)
             and c.__module__ == mod.__name__}
    first_four = {"ClassNLLCriterion", "CrossEntropyCriterion",
                  "FusedSoftmaxCrossEntropyCriterion",
                  "TimeDistributedCriterion"}
    assert names - first_four == {name for name, *_ in CASES}
    assert len(names) == 18 + 21
    for n in names:
        assert issubclass(getattr(nn, n), nn.Criterion), n


def test_abs_gradient_is_jax_s_at_zero():
    x = torch.zeros(3)
    assert torch.equal(nn.L1Cost().backward(x, None), torch.ones(3))
    assert torch.equal(nn.AbsCriterion(size_average=False).backward(
        x, x), torch.ones(3))
