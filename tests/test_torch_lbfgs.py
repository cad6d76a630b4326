"""L-BFGS of the port (``bigdl_tpu_torch/optim/lbfgs.py``) side by side
with the JAX package's (``bigdl_tpu/optim/lbfgs.py``), on the CPU.

JAX's ``TestLBFGS`` cases (``tests/test_optim.py:194-225``) -- a
quadratic, Rosenbrock without tolerances, a fixed step without the line
search -- each run by both packages from the same start: the points and
the loss histories agree (1e-5 relative; Rosenbrock's first 10 losses,
its end points to 1e-3), the iteration counts exactly, and each reaches
JAX's own acceptance.  Also: the history carried across
``optimize`` calls and dropped by ``clear_history``, ``line_search_wolfe``
alone, and a ``feval`` through the "tiny" TransformerLM (JAX's weights,
vocab 256, seq 64) against ``jax.value_and_grad`` of the JAX model's
loss (losses 1e-5, points 1e-4).
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads a test: workers running these tests side by side
    would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

A = np.diag([1.0, 10.0, 100.0]).astype(np.float32)
B = np.asarray([1.0, -2.0, 3.0], np.float32)


def _quadratic(lib):
    if lib == "jax":
        import jax.numpy as jnp
        a, b = jnp.asarray(A), jnp.asarray(B)
    else:
        a, b = torch.from_numpy(A), torch.from_numpy(B)

    def feval(x):
        return 0.5 * x @ a @ x - b @ x, a @ x - b
    return feval


def _rosenbrock(lib):
    if lib == "jax":
        import jax

        def f(v):
            return 100.0 * (v[1] - v[0] ** 2) ** 2 + (1 - v[0]) ** 2
        return lambda x: (f(x), jax.grad(f)(x))

    def feval(x):
        f = 100.0 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
        g = torch.stack([-400.0 * x[0] * (x[1] - x[0] ** 2)
                         - 2.0 * (1 - x[0]), 200.0 * (x[1] - x[0] ** 2)])
        return f, g
    return feval


def _bowl(lib):
    if lib == "jax":
        import jax.numpy as jnp
        return lambda x: (jnp.sum(x ** 2), 2 * x)
    return lambda x: (torch.sum(x ** 2), 2 * x)


CASES = {
    "quadratic": (_quadratic, dict(max_iter=50), np.zeros(3, np.float32)),
    "rosenbrock": (_rosenbrock, dict(max_iter=100, tolerance_fun=0.0,
                                     tolerance_x=1e-12),
                   np.asarray([-1.2, 1.0], np.float32)),
    "no-line-search": (_bowl, dict(max_iter=30, line_search=False,
                                   learning_rate=0.3),
                       np.asarray([4.0, -3.0], np.float32)),
}


def _run_jax(name, calls=1):
    import jax.numpy as jnp

    from bigdl_tpu.optim import LBFGS as JLBFGS

    make, kw, x0 = CASES[name]
    opt, x, hists = JLBFGS(**kw), jnp.asarray(x0), []
    for _ in range(calls):
        x, hist = opt.optimize(make("jax"), x)
        hists.append(hist)
    return np.asarray(x), hists


def _run_port(name, calls=1):
    make, kw, x0 = CASES[name]
    opt, x, hists = optim.LBFGS(**kw), torch.from_numpy(x0.copy()), []
    for _ in range(calls):
        x, hist = opt.optimize(make("torch"), x)
        hists.append(hist)
    return x.numpy(), hists, opt


@pytest.mark.parametrize("name", list(CASES))
def test_lbfgs_matches_jax(name):
    """Rosenbrock's curved valley amplifies a last-bit difference of the
    gradient (JAX's autodiff against the analytic one) over its 36
    iterations: there the first 10 losses are held to 1e-5 and the end
    points to 1e-3 of each other; elsewhere every loss and the point to
    1e-5."""
    want_x, want_h = _run_jax(name)
    got_x, got_h, _ = _run_port(name)
    assert len(got_h[0]) == len(want_h[0])
    held = 10 if name == "rosenbrock" else len(want_h[0])
    np.testing.assert_allclose(got_h[0][:held], want_h[0][:held], rtol=1e-5,
                               atol=1e-6)
    tol = 1e-3 if name == "rosenbrock" else 1e-5
    np.testing.assert_allclose(got_x, want_x, rtol=tol, atol=tol)
    # and JAX's own acceptance
    if name == "quadratic":
        np.testing.assert_allclose(got_x, np.linalg.solve(A, B), atol=1e-4)
    elif name == "rosenbrock":
        np.testing.assert_allclose(got_x, [1.0, 1.0], atol=1e-3)
    else:
        assert got_h[0][-1] < 1e-3
    assert got_h[0][-1] < got_h[0][0]


def test_history_persists_across_calls_like_jax():
    """Two ``optimize`` calls of 3 iterations on Rosenbrock: the second
    goes on from the first's curvature pairs, as JAX's does; after
    ``clear_history`` the history is empty again."""
    import jax.numpy as jnp

    from bigdl_tpu.optim import LBFGS as JLBFGS

    make, _, x0 = CASES["rosenbrock"]
    kw = dict(max_iter=3, tolerance_fun=0.0, tolerance_x=1e-12)
    jopt, topt = JLBFGS(**kw), optim.LBFGS(**kw)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0.copy())
    for _ in range(2):
        jx, jh = jopt.optimize(make("jax"), jx)
        tx, th = topt.optimize(make("torch"), tx)
        np.testing.assert_allclose(th, jh, rtol=1e-5, atol=1e-6)
    assert len(topt._state["old_dirs"]) == len(jopt._state["old_dirs"]) > 0
    assert topt.history_bytes() > 0
    topt.clear_history()
    assert topt._state is None and topt.history_bytes() == 0


def test_line_search_wolfe_matches_jax():
    """One strong-Wolfe search along the steepest descent of Rosenbrock
    from a step of 1 (which overshoots and brackets): the same step,
    loss and number of evaluations as JAX's."""
    import jax.numpy as jnp

    from bigdl_tpu.optim import line_search_wolfe as jsearch

    make, _, x0 = CASES["rosenbrock"]
    results = []
    for lib, search, arr in (
            ("jax", jsearch, jnp.asarray),
            ("torch", optim.line_search_wolfe, torch.from_numpy)):
        feval = make(lib)
        x = arr(x0.copy())
        f0, g0 = feval(x)
        d = -g0
        gtd0 = float((g0 * d).sum())
        f, g, t, n = search(feval, x, 1e-3, d, f0, g0, gtd0)
        results.append((float(f), np.asarray(g), float(t), n))
    (jf, jg, jt, jn), (tf, tg, tt, tn) = results
    assert tn == jn
    np.testing.assert_allclose([tf, tt], [jf, jt], rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)


def test_lbfgs_on_a_transformer_lm_matches_jax():
    """3 iterations on the flat parameters of the tiny TransformerLM (one
    batch of 2 sequences), ``feval`` a forward and backward: the loss
    histories to 1e-5 and the points to 1e-4 of JAX's (a flat gradient
    through the model, summed in another order)."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from bigdl_tpu.nn import criterion as jcrit
    from bigdl_tpu.nn.attention import TransformerLM as JaxLM
    from bigdl_tpu.optim import LBFGS as JLBFGS
    from bigdl_tpu_torch.interop import load_jax_params
    from bigdl_tpu_torch.models import synthetic_corpus, transformer_lm
    from bigdl_tpu_torch.optim.optim_method import ravel_order

    vocab, seq = 256, 64
    x, y = synthetic_corpus(2, seq, vocab, seed=2)
    jm = JaxLM(vocab, 256, 4, 4, max_len=seq)
    jm.build(jax.ShapeDtypeStruct((2, seq), jnp.int32),
             rng=jax.random.PRNGKey(0))
    params0 = jm.parameters()[0]
    flat0, unravel = ravel_pytree(params0)
    jc = jcrit.TimeDistributedCriterion(
        jcrit.FusedSoftmaxCrossEntropyCriterion())

    def jloss(flat):
        out, _ = jm.apply(unravel(flat), jm.state(), jnp.asarray(x),
                          training=False)
        return jc.apply(out, jnp.asarray(y))

    jfeval = jax.jit(jax.value_and_grad(jloss))
    kw = dict(max_iter=3, n_correction=4)
    jx, jh = JLBFGS(**kw).optimize(jfeval, flat0)

    tm = transformer_lm("tiny", vocab, max_len=seq, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params0))
    named = dict(tm.named_parameters())
    order = ravel_order(named)            # ravel_pytree's order
    params = [named[k] for k in order]
    sizes = [p.numel() for p in params]
    tc = nn.TimeDistributedCriterion(nn.FusedSoftmaxCrossEntropyCriterion())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def tfeval(flat):
        with torch.no_grad():
            for p, s in zip(params, torch.split(flat, sizes)):
                p.copy_(s.view(p.shape))
        tm.zero_grad(set_to_none=True)
        loss = tc.apply(tm(xt), yt)
        loss.backward()
        return loss.detach(), torch.cat([p.grad.reshape(-1) for p in params])

    tx0 = torch.from_numpy(np.asarray(flat0).copy())
    tx, th = optim.LBFGS(**kw).optimize(tfeval, tx0)
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    assert th[-1] < th[0]
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
