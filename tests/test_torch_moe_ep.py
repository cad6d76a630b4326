"""The port's Mixture-of-Experts layers (``bigdl_tpu_torch/nn/moe.py``)
and expert parallelism (``parallel/ep.py``) against the JAX package's on
the CPU.

In this process: ``MoE``'s output, aux loss and gradients against JAX's
``MoE.apply`` (hidden 16, 4 experts, k 2) at the default capacity factor,
at one small enough to drop tokens, and with a zero router (every
probability tied: ``lax.top_k`` picks the lower indices); the
``MoETransformerLM`` bridge both ways (bitwise) and its logits and aux
loss.  1e-5 relative, 1e-6 absolute (fp32 sums in another order).

In spawned gloo worlds of 2 and 4 ranks (``tests/_torch_strategy_
worker.py``): ``Optimizer(strategy="ep")`` on ``(1, 2)`` and ``(2, 2)``
``("data", "expert")`` meshes against JAX's ``StrategyOptimizer`` on
the same mesh shape (MoETransformerLM(64, 32, 4 heads, 2 layers, 4
experts), T 8, global batch 4, SGD with momentum; on ``(2, 2)`` a
capacity factor of 0.5, so tokens are dropped and a token's slot depends
on the other data shard's tokens): per-step task losses within 1e-5
relative, parameters by relative L2 within 1e-5 over 3 steps; and the
expert-parallel forward on ``(2, 2)`` with drops against JAX's forward
of the global batch.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_strategy_worker import (REL, jax_fit, jax_model, jax_params,
                                    lm_data, rel_l2, spawn_world, step_rel,
                                    train_case)

from bigdl_tpu.nn.moe import MoE as JaxMoE
from bigdl_tpu.utils.random_generator import RNG as JRNG
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
from bigdl_tpu_torch.nn.moe import MoE, MoETransformerLM

SPEC = {"kind": "moe", "vocab": 64, "hidden": 32, "heads": 4, "layers": 2,
        "experts": 4, "max_len": 32}
DROPS = dict(SPEC, capacity_factor=0.5)


def _jax_moe(cf, zero_gate=False, seed=0):
    JRNG.set_seed(seed)
    m = JaxMoE(16, 4, k=2, capacity_factor=cf)
    x = np.random.default_rng(seed).standard_normal((2, 12, 16)).astype(
        np.float32)
    m.build(jax.ShapeDtypeStruct(x.shape, jnp.float32))
    params = jax.tree.map(np.asarray, m.parameters()[0])
    if zero_gate:
        params["gate"] = np.zeros_like(params["gate"])
    return m, params, x


@pytest.mark.parametrize("cf,zero_gate", [(1.25, False), (0.4, False),
                                          (1.25, True)])
def test_moe_forward_aux_and_gradients_match_jax(cf, zero_gate):
    jm, params, x = _jax_moe(cf, zero_gate)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        out, st = jm.apply(p, (), xx)
        return (out * w).sum() + st["aux_loss"], (out, st["aux_loss"])

    (_, (want, want_aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    m = MoE(16, 4, k=2, capacity_factor=cf)
    m.load_parameters_tree(params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = m(xt)
    ((out * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    dropped = int((np.abs(np.asarray(want)).sum(-1) < 1e-7).sum())
    if cf < 1:
        assert dropped > 0          # the small capacity drops tokens


def test_moe_lm_bridge_both_ways_and_forward():
    x, _ = lm_data(2, 8, 64, seed=4)
    jm = jax_model(SPEC, x, seed=4)
    params = jax.tree.map(np.asarray, jm.parameters()[0])
    m = MoETransformerLM(64, 32, 4, 2, 4, max_len=32, device="cpu")
    load_jax_params(m, params)
    back = to_jax_params(m)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    want, st = jax.jit(lambda p, xx: jm.apply(p, (), xx))(
        jm.parameters()[0], jnp.asarray(x))
    with torch.no_grad():
        logits, aux = m(torch.from_numpy(x), return_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(st["aux_loss"]),
                               rtol=1e-6)
    assert m(torch.from_numpy(x)).shape == (2, 8, 64)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = [train_case("ep_1x2", SPEC, "ep", (1, 2), ("data", "expert"),
                        t=8)]
    return {c["name"]: c for c in cases}, spawn_world(
        tmp_path_factory.mktemp("ep2"), 2, cases)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    x, _ = lm_data(4, 8, 64, seed=5)
    cases = [train_case("ep_2x2", DROPS, "ep", (2, 2), ("data", "expert"),
                        t=8, seed=1),
             {"kind": "moe", "name": "moe_2x2", "mesh": (2, 2),
              "axes": ("data", "expert"), "model": DROPS, "x": x,
              "params": jax_params(DROPS, x, seed=5)}]
    return {c["name"]: c for c in cases}, spawn_world(
        tmp_path_factory.mktemp("ep4"), 4, cases)


def _held(case, ranks):
    losses, params, neval, _ = jax_fit(case)
    for res in ranks:
        assert res["neval"] == neval == case["steps"] + 1
        assert np.all(step_rel(res["losses"], losses) < REL), (
            res["losses"], losses)
        assert rel_l2(res["params"], params) < REL


def test_ep_training_matches_jax_world2(world2):
    cases, out = world2
    _held(cases["ep_1x2"], out["ep_1x2"])


def test_ep_training_with_drops_and_a_data_axis_matches_jax(world4):
    cases, out = world4
    _held(cases["ep_2x2"], out["ep_2x2"])


def test_ep_forward_routes_the_global_batch(world4):
    cases, out = world4
    case = cases["moe_2x2"]
    jm = jax_model(DROPS, case["x"], seed=5)
    want, st = jax.jit(lambda p, xx: jm.apply(p, (), xx))(
        jm.parameters()[0], jnp.asarray(case["x"]))
    want = np.asarray(want)
    for r, res in enumerate(out["moe_2x2"]):
        rows = slice((r // 2) * 2, (r // 2 + 1) * 2)   # its data shard
        np.testing.assert_allclose(res["logits"], want[rows], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(res["aux"], float(st["aux_loss"]),
                                   rtol=1e-6)
