"""The port's sequence parallelism (``bigdl_tpu_torch/parallel/
ring_attention.py``, ``ulysses.py``, ``sequence.py`` and the
``seq_axis_name`` hooks of ``nn/attention.py``) against the JAX
package's on the CPU.

The port's side runs in spawned gloo worlds of 2 and 4 ranks
(``tests/_torch_strategy_worker.py``), one world per size with every
case inside it; the JAX side on meshes of the same shape over
``tests/conftest.py``'s 8 CPU devices.

Held:

- ring and Ulysses attention, causal and not, forward and the gradient
  of ``sum(out * w)`` with respect to q, k and v, against JAX's
  ``sequence_shard_attention`` and ``shard_map``'d
  ``ulysses_self_attention`` on a 2-device ``"seq"`` mesh (B 2, T 16, 4
  heads of 8): 1e-5 relative, 1e-6 absolute (fp32, another order of
  the online softmax's sums);
- ``Optimizer(strategy="sp")`` training, both ``seq_mode``s, on ``(1,
  2)`` and ``(2, 2)`` ``("data", "seq")`` meshes against JAX's
  ``StrategyOptimizer`` (TransformerLM(64, 32, 4 heads, 2 layers), T 16,
  global batch 4, SGD with momentum): per-step losses within 1e-5
  relative, parameters by relative L2 within 1e-5 over 3 steps;
- ``transformer-train --sp 2 --device cpu`` against the port's own
  ``StrategyOptimizer`` on the same ``(1, 2)`` mesh, weights and data
  (the same program: equal bits).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from _torch_strategy_worker import (REL, jax_fit, jax_mesh, rel_l2,
                                    spawn_world, step_rel, train_case)

from bigdl_tpu.parallel.ring_attention import sequence_shard_attention
from bigdl_tpu.parallel.ulysses import ulysses_self_attention
from bigdl_tpu.utils.compat import shard_map

SPEC = {"kind": "lm", "vocab": 64, "hidden": 32, "heads": 4, "layers": 2,
        "max_len": 32, "seq_axis_name": "seq"}
ATTN = [(mode, causal) for mode in ("ring", "ulysses")
        for causal in (False, True)]
RECIPE = ["transformer-train", "--device", "cpu", "--sp", "2", "--size",
          "tiny", "--vocab", "256", "--seq-len", "32", "-b", "4",
          "--maxIteration", "3", "--synthN", "16"]


def _attn_case(mode, causal):
    r = np.random.default_rng(7)
    mk = lambda: r.standard_normal((2, 16, 4, 8)).astype(np.float32)
    return {"kind": "attention", "name": f"attn_{mode}_{causal}",
            "mesh": (2,), "axes": ("seq",), "mode": mode, "causal": causal,
            "q": mk(), "k": mk(), "v": mk(), "w": mk()}


def _recipe_twin():
    """The ``train`` case the recipe runs: its model's weights, corpus,
    batch and Adam."""
    from bigdl_tpu_torch.interop import to_jax_params
    from bigdl_tpu_torch.models.transformer import (synthetic_corpus,
                                                    transformer_lm)

    x, y = synthetic_corpus(16, 32, 256)
    model = transformer_lm("tiny", 256, max_len=32, device="cpu",
                           seq_axis_name="seq")
    return {"kind": "train", "name": "recipe_twin",
            "model": {"kind": "lm", "vocab": 256, "hidden": 256, "heads": 4,
                      "layers": 4, "max_len": 32, "seq_axis_name": "seq"},
            "strategy": "sp", "mesh": (1, 2), "axes": ("data", "seq"),
            "x": x, "y": y, "batch": 4, "steps": 3,
            "method": ("adam", {"learning_rate": 1e-3}),
            "criterion": "fused", "params": to_jax_params(model)}


def _sp(name, mode, mesh):
    return train_case(name, dict(SPEC, seq_mode=mode), "sp", mesh,
                      ("data", "seq"))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    cases = [_attn_case(m, c) for m, c in ATTN] + [
        _sp("sp_ring_1x2", "ring", (1, 2)),
        _sp("sp_ulysses_1x2", "ulysses", (1, 2)),
        _recipe_twin(),
        {"kind": "recipe", "name": "recipe", "argv": RECIPE}]
    return {c["name"]: c for c in cases}, spawn_world(
        tmp_path_factory.mktemp("sp2"), 2, cases)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [_sp("sp_ring_2x2", "ring", (2, 2)),
             _sp("sp_ulysses_2x2", "ulysses", (2, 2))]
    return {c["name"]: c for c in cases}, spawn_world(
        tmp_path_factory.mktemp("sp4"), 4, cases)


def _jax_attention(case):
    mesh = jax_mesh((2,), ("seq",))
    causal = case["causal"]
    if case["mode"] == "ring":
        fn = lambda q, k, v: sequence_shard_attention(q, k, v, mesh,
                                                      causal=causal)
    else:
        fn = shard_map(
            lambda a, b, c: ulysses_self_attention(a, b, c, "seq",
                                                   causal=causal),
            mesh=mesh, in_specs=(P(None, "seq"),) * 3,
            out_specs=P(None, "seq"), check_vma=False)
    q, k, v, w = (jnp.asarray(case[n]) for n in "qkvw")
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda a, b, c: (fn(a, b, c) * w).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("mode,causal", ATTN)
def test_attention_and_gradient_match_jax(mode, causal, world2):
    cases, out = world2
    case = cases[f"attn_{mode}_{causal}"]
    want, grads = _jax_attention(case)
    ranks = out[case["name"]]
    got = np.concatenate([r["out"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for key, g in zip(("dq", "dk", "dv"), grads):
        got = np.concatenate([r[key] for r in ranks], axis=1)
        np.testing.assert_allclose(got, g, rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def _held(case, ranks):
    losses, params, neval, _ = jax_fit(case)
    for res in ranks:
        assert res["neval"] == neval == case["steps"] + 1
        assert np.all(step_rel(res["losses"], losses) < REL), (
            res["losses"], losses)
        assert rel_l2(res["params"], params) < REL


@pytest.mark.parametrize("name", ["sp_ring_1x2", "sp_ulysses_1x2"])
def test_sp_training_matches_jax_world2(name, world2):
    cases, out = world2
    _held(cases[name], out[name])


@pytest.mark.parametrize("name", ["sp_ring_2x2", "sp_ulysses_2x2"])
def test_sp_training_matches_jax_world4(name, world4):
    cases, out = world4
    _held(cases[name], out[name])


def test_recipe_sp_trains_as_the_strategy_optimizer(world2):
    _, out = world2
    for rec, twin in zip(out["recipe"], out["recipe_twin"]):
        assert rec["strategy"] == "sp"
        assert rec["mesh"] == {"data": 1, "seq": 2}
        assert len(rec["losses"]) == 3
        assert rec["losses"] == twin["losses"]
        assert rel_l2(rec["params"], twin["params"]) == 0.0
