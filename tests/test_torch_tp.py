"""The port's tensor parallelism (``bigdl_tpu_torch/parallel/tp.py``, the
vocabulary-parallel K4/K5 of ``ops/cross_entropy.py``) against the JAX
package's on the CPU.

The port's side runs in spawned gloo worlds of 2 and 4 ranks
(``tests/_torch_strategy_worker.py``: one process a rank, ``file://``
rendezvous, one thread each, killed and waited for under the parent's
time limit), one world per size with every case inside it; the JAX side
on meshes of the same shape over ``tests/conftest.py``'s 8 CPU devices
(``StrategyOptimizer(strategy="tp")``, GSPMD).  Both start from the same
weights (the JAX model's, loaded through ``interop``) and data:
TransformerLM(64, 32, 4 heads, 2 layers, max_len 32), T 16, global batch
4, SGD with momentum.

Held: the rules and specs against JAX's; the shard by heads inside q, k
and v and the shard/gather round trip (bitwise); the vocabulary-parallel
cross-entropy's loss, lse and gradient against the full-vocabulary plain
version (1e-6 relative: the lse is combined from per-shard sums); the tp
training on ``(1, 2)``, ``(1, 4)`` and ``(2, 2)`` ``("data", "model")``
meshes, and with clipping by global norm, against JAX: per-step losses
within 1e-5 relative and the parameters by relative L2 within 1e-5 over
3 steps (fp32 sums in another order drift about 1e-7 a step, ROADMAP
C's CPU caveat).
"""

import numpy as np
import pytest

import torch

from _torch_strategy_worker import (REL, jax_fit, jax_mesh, jax_params,
                                    rel_l2, spawn_world, step_rel,
                                    train_case)

from bigdl_tpu.parallel.tp import TRANSFORMER_TP_RULES as JAX_RULES
from bigdl_tpu.parallel.tp import sharding_for_params as jax_sharding
from bigdl_tpu_torch.ops.cross_entropy import (
    fused_softmax_cross_entropy_grad_reference,
    fused_softmax_cross_entropy_reference)
from bigdl_tpu_torch.parallel import tp

SPEC = {"kind": "lm", "vocab": 64, "hidden": 32, "heads": 4, "layers": 2,
        "max_len": 32}

def _ce_case(name, n=12, v=64, seed=3):
    r = np.random.default_rng(seed)
    logits = (3 * r.standard_normal((n, v))).astype(np.float32)
    labels = r.integers(0, v, n).astype(np.int64)
    labels[:4] = [0, v // 2 - 1, v // 2, v - 1]     # shard edges
    return {"kind": "vocab_ce", "name": name, "mesh": (1, 2),
            "axes": ("data", "model"), "logits": logits, "labels": labels,
            "g": r.standard_normal(n).astype(np.float32)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    x = np.zeros((2, 16), np.int32)
    cases = [
        {"kind": "shard", "name": "shard", "mesh": (1, 2),
         "axes": ("data", "model"), "params": jax_params(SPEC, x, seed=1)},
        _ce_case("ce"),
        train_case("tp_1x2", SPEC, "tp", (1, 2), ("data", "model")),
        train_case("tp_clip", SPEC, "tp", (1, 2), ("data", "model"),
                   clip_norm=0.5, seed=2),
    ]
    return {c["name"]: c for c in cases}, spawn_world(
        tmp_path_factory.mktemp("tp2"), 2, cases)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    cases = [train_case("tp_1x4", SPEC, "tp", (1, 4), ("data", "model")),
             train_case("tp_2x2", SPEC, "tp", (2, 2), ("data", "model"))]
    return {c["name"]: c for c in cases}, spawn_world(
        tmp_path_factory.mktemp("tp4"), 4, cases)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, (*path, k))
        else:
            yield (*path, k), v


def test_rules_and_specs_match_jax():
    assert tp.TRANSFORMER_TP_RULES == JAX_RULES
    params = jax_params(SPEC, np.zeros((2, 16), np.int32))
    want = jax_sharding(params, jax_mesh((1, 2), ("data", "model")))
    got = tp.sharding_for_params(params)
    for path, spec in _flat(got):
        node = want
        for k in path:
            node = node[k]
        assert tuple(node.spec) == spec, path
    assert got["block0"]["attn"]["qkv_weight"] == ("model", None)
    assert got["block1"]["fc2"]["weight"] == (None, "model")
    assert got["head"] == ("model", None) and got["wte"] == ()


def test_qkv_shards_by_heads_and_round_trip_is_bitwise(world2):
    cases, out = world2
    logical = cases["shard"]["params"]
    d = SPEC["hidden"]
    for r, res in enumerate(out["shard"]):
        local = res["local"]["block0"]["attn"]
        w = logical["block0"]["attn"]["qkv_weight"]
        half = d // 2
        want = np.concatenate([w[j * d + r * half:j * d + (r + 1) * half]
                               for j in range(3)])
        np.testing.assert_array_equal(local["qkv_weight"], want)
        np.testing.assert_array_equal(
            local["out_weight"],
            logical["block0"]["attn"]["out_weight"][:, r * half:
                                                    (r + 1) * half])
        np.testing.assert_array_equal(
            res["local"]["head"], logical["head"][r * 32:(r + 1) * 32])
        for path, leaf in _flat(res["back"]):
            node = logical
            for k in path:
                node = node[k]
            np.testing.assert_array_equal(leaf, node, err_msg=str(path))


def test_vocab_parallel_cross_entropy_matches_the_full_vocabulary(world2):
    cases, out = world2
    case = cases["ce"]
    logits = torch.from_numpy(case["logits"])
    labels = torch.from_numpy(case["labels"])
    loss, lse = fused_softmax_cross_entropy_reference(logits, labels)
    grad = fused_softmax_cross_entropy_grad_reference(
        logits, labels, lse, torch.from_numpy(case["g"])).numpy()
    v = logits.shape[1] // 2
    for res in out["ce"]:
        np.testing.assert_allclose(res["loss"], loss.numpy(), rtol=1e-6)
        np.testing.assert_allclose(res["lse"], lse.numpy(), rtol=1e-6)
        off = res["offset"]
        inside = (case["labels"] >= off) & (case["labels"] < off + v)
        # the shard's labels: in range or the sentinel, never outside
        assert np.all(res["local"][~inside] == -1)
        np.testing.assert_array_equal(res["local"][inside],
                                      case["labels"][inside] - off)
        np.testing.assert_allclose(res["grad"], grad[:, off:off + v],
                                   rtol=1e-5, atol=1e-7)


def _held(case, ranks):
    losses, params, neval, _ = jax_fit(case)
    for res in ranks:
        assert res["neval"] == neval == case["steps"] + 1
        assert res["route"] == "eager"          # gloo is never captured
        assert np.all(step_rel(res["losses"], losses) < REL), (
            res["losses"], losses)
        assert rel_l2(res["params"], params) < REL


@pytest.mark.parametrize("name", ["tp_1x2", "tp_clip"])
def test_tp_training_matches_jax_world2(name, world2):
    cases, out = world2
    _held(cases[name], out[name])


@pytest.mark.parametrize("name", ["tp_1x4", "tp_2x2"])
def test_tp_training_matches_jax_world4(name, world4):
    cases, out = world4
    _held(cases[name], out[name])
