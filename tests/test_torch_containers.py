"""``LookupTable`` and the table containers of the port
(``bigdl_tpu_torch/nn/embedding.py``, ``nn/containers.py``) against the
JAX package's (``bigdl_tpu/nn/embedding.py:14``,
``bigdl_tpu/nn/containers.py:15-226``), on the CPU.

Each container is built in both packages around ``Linear`` children (the
port's loaded with JAX's weights by key: children are ``"0"``, ``"1"``,
...), run on numpy-seeded inputs, and held to JAX's outputs and to the
gradients of a sum of squares with respect to every parameter and every
input, within 1e-5.  ``LookupTable`` is held the same way with
``max_norm`` (functional renormalisation: the weight is never written),
``padding_value`` (a zero output row) and indices outside the table
(clipped).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.nn import containers as jcont
from bigdl_tpu.nn import embedding as jemb
from bigdl_tpu.nn import linear as jlinear
from bigdl_tpu_torch import nn

TOL = dict(rtol=1e-5, atol=1e-5)
N, F = 3, 4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif not (isinstance(v, tuple) and not v):    # () : no parameters
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for e in x for leaf in _leaves(e)]
    return [x]


def _table(rng, n, shape=(N, F)):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(n))


def _lin(pkg, out=F):
    return jlinear.Linear(F, out) if pkg == "jax" else nn.Linear(F, out)


#: name -> (builder(pkg), input maker(rng))
CASES = {
    "Sequential": (lambda p: (jcont if p == "jax" else nn).Sequential()
                   .add(_lin(p)).add(_lin(p, 3)),
                   lambda rng: _table(rng, 1)[0]),
    "ConcatTable": (lambda p: (jcont if p == "jax" else nn).ConcatTable()
                    .add(_lin(p)).add(_lin(p, 3)),
                    lambda rng: _table(rng, 1)[0]),
    "ParallelTable": (lambda p: (jcont if p == "jax" else nn)
                      .ParallelTable().add(_lin(p)).add(_lin(p, 3)),
                      lambda rng: _table(rng, 2)),
    "MapTable": (lambda p: (jcont if p == "jax" else nn).MapTable(_lin(p)),
                 lambda rng: _table(rng, 3)),
    "Concat": (lambda p: (jcont if p == "jax" else nn).Concat(1)
               .add(_lin(p)).add(_lin(p, 3)),
               lambda rng: _table(rng, 1)[0]),
    "Concat-dim0": (lambda p: (jcont if p == "jax" else nn).Concat(0)
                    .add(_lin(p)).add(_lin(p)),
                    lambda rng: _table(rng, 1)[0]),
    "CAddTable": (lambda p: (jcont if p == "jax" else nn).CAddTable(),
                  lambda rng: _table(rng, 3)),
    "CMulTable": (lambda p: (jcont if p == "jax" else nn).CMulTable(),
                  lambda rng: _table(rng, 3)),
    "CSubTable": (lambda p: (jcont if p == "jax" else nn).CSubTable(),
                  lambda rng: _table(rng, 2)),
    "CDivTable": (lambda p: (jcont if p == "jax" else nn).CDivTable(),
                  lambda rng: _table(rng, 2)),
    "CMaxTable": (lambda p: (jcont if p == "jax" else nn).CMaxTable(),
                  lambda rng: _tied(rng)),
    "CMinTable": (lambda p: (jcont if p == "jax" else nn).CMinTable(),
                  lambda rng: _tied(rng)),
    "JoinTable": (lambda p: (jcont if p == "jax" else nn).JoinTable(1),
                  lambda rng: _table(rng, 3)),
    "JoinTable-dim0": (lambda p: (jcont if p == "jax" else nn).JoinTable(0),
                       lambda rng: _table(rng, 2)),
    "SelectTable": (lambda p: (jcont if p == "jax" else nn).SelectTable(1),
                    lambda rng: _table(rng, 3)),
    "SelectTable-last": (lambda p: (jcont if p == "jax" else nn)
                         .SelectTable(-1),
                         lambda rng: _table(rng, 3)),
    "FlattenTable": (lambda p: (jcont if p == "jax" else nn).FlattenTable(),
                     lambda rng: (_table(rng, 1)[0],
                                  (_table(rng, 2), _table(rng, 1)[0]))),
    "Sequential-of-tables": (
        lambda p: (jcont if p == "jax" else nn).Sequential()
        .add((jcont if p == "jax" else nn).ConcatTable()
             .add(_lin(p)).add(_lin(p)))
        .add((jcont if p == "jax" else nn).CAddTable()),
        lambda rng: _table(rng, 1)[0]),
}


def _tied(rng):
    """A table with ties between elements (the gradient splits)."""
    a, b, c = _table(rng, 3)
    b[0] = a[0]
    c[1] = a[1]
    return a, b, c


def _spec(x):
    if isinstance(x, tuple):
        return tuple(_spec(e) for e in x)
    return jax.ShapeDtypeStruct(x.shape, jnp.float32)


def _to(pkg, x, grad=False):
    if isinstance(x, tuple):
        return tuple(_to(pkg, e, grad) for e in x)
    if pkg == "jax":
        return jnp.asarray(x)
    return torch.from_numpy(x.copy()).requires_grad_(grad)


@pytest.mark.parametrize("name", list(CASES))
def test_container_matches_jax(name):
    build, make = CASES[name]
    x = make(np.random.default_rng(len(name)))
    jm = build("jax")
    jm.build(_spec(x), rng=jax.random.PRNGKey(2))
    jp = jm.parameters()[0]
    tm = build("port")
    if jp:
        tm.load_parameters_tree(jax.tree.map(np.asarray, jp))
    assert sorted(_flat(tm.parameters_tree())) == sorted(
        _flat(jax.tree.map(np.asarray, jp)) if jp else {})

    def jloss(p, xin):
        y, _ = jm.apply(p, jm._state, xin)
        return sum(jnp.sum(jnp.square(leaf)) for leaf in _leaves(y)), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jp, _to("jax", x))
    tx = _to("port", x, grad=True)
    ty = tm(tx)
    for a, b in zip(_leaves(ty), _leaves(jy), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **TOL)
    sum(leaf.square().sum() for leaf in _leaves(ty)).backward()
    for a, b in zip(_leaves(tx), _leaves(jgx), strict=True):
        # an input the output does not reach has no torch gradient
        g = torch.zeros_like(a) if a.grad is None else a.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(b), **TOL)
    want = _flat(jax.tree.map(np.asarray, jgp)) if jp else {}
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], err_msg=k,
                                   **TOL)


def test_map_table_shares_one_module_and_routes_marks():
    lin = nn.Linear(F, F)
    m = nn.MapTable(lin)
    assert [k for k, _ in m.named_parameters()] == ["weight", "bias"]
    m.freeze([lin.name])
    assert nn.frozen_param_mask(m) == {"weight": False, "bias": False}
    m.eval()
    assert not lin.training


@pytest.mark.parametrize("max_norm,norm_type,padding",
                         [(None, 2.0, None), (0.8, 2.0, 3), (1.5, 1.0, 0),
                          (0.5, 3.0, None)])
def test_lookup_table_matches_jax(max_norm, norm_type, padding):
    n_index, n_out = 7, 5
    idx = np.array([[0, 3, 6, 9], [-2, 3, 1, 7]], np.int32)   # out of range
    jm = jemb.LookupTable(n_index, n_out, padding_value=padding,
                          max_norm=max_norm, norm_type=norm_type)
    jm.build(jax.ShapeDtypeStruct(idx.shape, jnp.int32),
             rng=jax.random.PRNGKey(1))
    jp = jm.parameters()[0]
    tm = nn.LookupTable(n_index, n_out, padding_value=padding,
                        max_norm=max_norm, norm_type=norm_type)
    tm.load_parameters_tree(jax.tree.map(np.asarray, jp))
    before = tm.weight.detach().clone()

    def jloss(p):
        y, _ = jm.apply(p, (), jnp.asarray(idx))
        return jnp.sum(jnp.square(y) * jnp.arange(n_out)), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    ty = tm(torch.from_numpy(idx))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    (ty.square() * torch.arange(n_out)).sum().backward()
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(jg["weight"]), **TOL)
    assert torch.equal(tm.weight.detach(), before)   # never renormed in place
    if padding is not None:
        rows = torch.from_numpy(idx == padding)
        assert rows.any() and not ty[rows].any()
