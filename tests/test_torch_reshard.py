"""The port's redistribution (``bigdl_tpu_torch/parallel/reshard.py``:
``redistribute``, ``convert_shapes``, ``flat_to_tree``, ``tree_to_flat``,
``to_model_layout``, ``pp_tree_to_blocks`` / ``blocks_to_pp_tree``)
against the JAX package's on the same numpy trees: JAX's
``tests/test_reshard.py`` classes ``TestStructuralRoundTrips``,
``TestDpRoundTrips``, ``TestExpertRecut`` and ``TestLayoutSpec``'s pp
rows, each conversion held **bitwise** against JAX's output, with JAX's
A -> B -> A property and its refusals (an uneven re-cut, dp -> tp) and
messages.  Also: tensor leaves convert as numpy ones do and stay
tensors; ``telemetry=`` is refused naming ROADMAP A8; the data-parallel
optimizer refuses a tp snapshot with JAX's message.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.parallel.reshard as jr
from bigdl_tpu.nn.attention import stack_block_params as jax_stack_blocks
from bigdl_tpu.parallel.zero import FlatParamSpace as JaxFlatParamSpace
from bigdl_tpu.parallel.zero import repartition_ef_residual
from bigdl_tpu.utils.random_generator import RNG as JaxRNG
from bigdl_tpu_torch.parallel import reshard as pr
from bigdl_tpu_torch.utils.errors import UnsupportedFeatureError


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _same(got, want):
    """Bitwise, structure included (tensor leaves read as numpy).  JAX's
    dp conversion passes every leaf through ``jnp.asarray``, which makes
    an int64 scalar int32 (64-bit types off); the port keeps the numpy
    leaf, so dtypes compare as JAX would hold them."""
    got = jax.tree.map(lambda a: a.numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a), got)
    want = _np(want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert jax.dtypes.canonicalize_dtype(a.dtype) == \
            jax.dtypes.canonicalize_dtype(b.dtype)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _both(tree, src, dst):
    """The port's and JAX's ``redistribute`` of one numpy tree, held
    bitwise; returns the port's."""
    src, dst = src.to_manifest(), dst.to_manifest()
    got = pr.redistribute(tree, src, dst)
    _same(got, jr.redistribute(tree, src, dst))
    return got


def _block_tree(rng, n_layers, width=4):
    tree = {"wte": rng.standard_normal((9, width)).astype(np.float32),
            "wpe": rng.standard_normal((5, width)).astype(np.float32),
            "ln_f": {"g": np.ones(width, np.float32)},
            "head": rng.standard_normal((9, width)).astype(np.float32)}
    for i in range(n_layers):
        tree[f"block{i}"] = {
            "fc": rng.standard_normal((width, width)).astype(np.float32)}
    return tree


# --------------------------------------------------------------------------- #
# LayoutSpec's pp rows
# --------------------------------------------------------------------------- #


def test_pp_layout_spec_is_jax():
    for axes, n in (({"data": 2, "pipe": 4}, 4), ({"pipe": 2}, 2)):
        want = jr.LayoutSpec.pp(axes, n).to_manifest()
        spec = pr.LayoutSpec.pp(axes, n)
        assert spec.to_manifest() == want
        wire = json.loads(json.dumps(want))
        assert pr.LayoutSpec.from_manifest(wire) == spec
        assert spec.describe() == jr.LayoutSpec.pp(axes, n).describe()
        assert spec.n_stages == n
    assert "stages=4" in pr.LayoutSpec.pp({"pipe": 4}, 4).describe()


# --------------------------------------------------------------------------- #
# dp round trips
# --------------------------------------------------------------------------- #


def _dp_payload(rng, tree, space, with_ef=True):
    flat = np.asarray(space.flatten(tree))
    payload = {"params_flat": flat,
               "opt_state": {"m": flat * np.float32(0.1),
                             "v": flat * np.float32(0.01),
                             "step": np.asarray(3)}}
    if with_ef:
        raw = rng.standard_normal(
            (space.num_chunks, space.padded_size)).astype(np.float32)
        payload["ef_residual"] = repartition_ef_residual(
            raw, space.true_size, space.num_chunks, space.padded_size)
    return payload


def _dp_spec(space, with_ef=True):
    return jr.LayoutSpec.dp(
        space.num_chunks, space.padded_size, space.true_size,
        space.block_size,
        ef_shape=(space.num_chunks, space.padded_size) if with_ef
        else None)


@pytest.mark.parametrize("n_a,n_b", [(1, 2), (2, 4), (4, 8), (8, 1),
                                     (8, 2)])
def test_dp_round_trip_is_jax(n_a, n_b):
    rng = np.random.default_rng(n_a * 10 + n_b)
    tree = {"w": rng.standard_normal((13, 7)).astype(np.float32)}
    sa = JaxFlatParamSpace(tree, n_a, block_size=4)
    sb = JaxFlatParamSpace(tree, n_b, block_size=4)
    payload = _dp_payload(rng, tree, sa)
    a, b = _dp_spec(sa), _dp_spec(sb)
    there = _both(payload, a, b)
    assert np.shape(there["ef_residual"]) == (n_b, sb.padded_size)
    _same(_both(there, b, a), payload)


def test_dp_ef_correction_block_rounding_and_refusals():
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((13, 7)).astype(np.float32)}
    s8, s2 = JaxFlatParamSpace(tree, 8), JaxFlatParamSpace(tree, 2)
    ef = rng.standard_normal((8, s8.padded_size)).astype(np.float32)
    ef[:, s8.true_size:] = 0
    out = _both({"ef_residual": ef}, _dp_spec(s8), _dp_spec(s2))
    np.testing.assert_array_equal(
        np.asarray(out["ef_residual"]).sum(0)[:s8.true_size],
        ef.sum(0)[:s8.true_size])
    tree = {"w": rng.standard_normal((33, 5)).astype(np.float32)}
    s1 = JaxFlatParamSpace(tree, 4, block_size=1)
    s256 = JaxFlatParamSpace(tree, 4, block_size=256)
    payload = _dp_payload(rng, tree, s1, with_ef=False)
    a, b = _dp_spec(s1, False), _dp_spec(s256, False)
    _same(_both(_both(payload, a, b), b, a), payload)
    for src, dst, match in (
            (jr.LayoutSpec.dp(4, 128, 96), jr.LayoutSpec.dp(2, 64, 50),
             "different model"),
            (jr.LayoutSpec.dp(1, 4, 4), jr.LayoutSpec.tp({"model": 2}),
             "flat_to_tree")):
        tree = {"params_flat": np.zeros(128, np.float32)}
        with pytest.raises(ValueError, match=match) as want:
            jr.redistribute(tree, src, dst)
        with pytest.raises(ValueError, match=match) as got:
            pr.redistribute(tree, src.to_manifest(), dst.to_manifest())
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# Structural round trips
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_a,n_b", [(4, 2), (4, 1), (8, 2), (2, 8)])
def test_pp_recut_is_jax(n_a, n_b):
    rng = np.random.default_rng(n_a + n_b)
    pp = _np(jr.blocks_to_pp_tree(_block_tree(rng, 8), n_a))
    _same(pr.blocks_to_pp_tree(_block_tree(np.random.default_rng(
        n_a + n_b), 8), n_a), pp)
    payload = {"params": pp,
               "opt_state": {"m": jax.tree.map(lambda a: a * 0.1, pp),
                             "step": np.asarray(5)}}
    a = jr.LayoutSpec.pp({"pipe": n_a}, n_a)
    b = jr.LayoutSpec.pp({"pipe": n_b}, n_b)
    there = _both(payload, a, b)
    assert jax.tree.leaves(there["params"]["stages"])[0].shape[0] == n_b
    _same(_both(there, b, a), payload)


def test_pp_to_model_tree_scan_tp_identity_and_uneven():
    rng = np.random.default_rng(2)
    blocks = _block_tree(rng, 4)
    pp = _np(jr.blocks_to_pp_tree(blocks, 4))
    rep = jr.LayoutSpec.replicated(block_layout="unrolled")
    s4 = jr.LayoutSpec.pp({"pipe": 4}, 4)
    flat = _both(pp, s4, rep)
    assert "block3" in flat and "stages" not in flat
    _same(flat, blocks)
    _same(pr.pp_tree_to_blocks(pp), blocks)
    _same(_both(flat, rep, s4), pp)
    # scan <-> unrolled
    scan = _np(jax_stack_blocks(blocks))
    s = jr.LayoutSpec.replicated(block_layout="scan")
    un = _both(scan, s, rep)
    _same(un, blocks)
    _same(_both(un, rep, s), scan)
    # tp trees are the logical tree: a degree change is the identity
    a = jr.LayoutSpec.tp({"data": 2, "model": 4}, block_layout="unrolled")
    b = jr.LayoutSpec.tp({"data": 4, "model": 2}, block_layout="unrolled")
    _same(_both(_both(blocks, a, b), b, a), blocks)
    # tp <-> pp, both directions
    _same(_both(_both(blocks, a, s4), s4, a), blocks)
    same = pr.LayoutSpec.tp({"model": 2})
    assert pr.redistribute(blocks, same, same) is blocks
    with pytest.raises(ValueError, match="divide evenly"):
        pr.redistribute(pp, s4.to_manifest(),
                        jr.LayoutSpec.pp({"pipe": 3}, 3).to_manifest())
    with pytest.raises(ValueError, match="divide evenly"):
        pr.blocks_to_pp_tree(blocks, 3)


def test_tensor_leaves_convert_and_stay_tensors():
    rng = np.random.default_rng(7)
    blocks = _block_tree(rng, 4)
    tensors = jax.tree.map(torch.from_numpy, blocks)
    s2 = pr.LayoutSpec.pp({"pipe": 2}, 2)
    rep = pr.LayoutSpec.replicated("unrolled")
    got = pr.redistribute(tensors, rep, s2)
    assert all(isinstance(a, torch.Tensor) for a in jax.tree.leaves(got))
    _same(got, jr.redistribute(blocks, rep.to_manifest(), s2.to_manifest()))
    _same(pr.redistribute(got, s2, rep), blocks)


def test_flat_tree_round_trip_is_jax():
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((11, 3)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32),
            "sub": {"z": rng.standard_normal((2, 2)).astype(np.float32)}}
    space = JaxFlatParamSpace(tree, 4, block_size=8)
    spec = _dp_spec(space, with_ef=False)
    flat = pr.tree_to_flat(tree, spec.to_manifest())
    assert flat.shape == (space.padded_size,)
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jr.tree_to_flat(tree, spec)))
    back = pr.flat_to_tree(flat.numpy(), spec.to_manifest(), tree)
    _same(back, jr.flat_to_tree(flat.numpy(), spec, tree))
    _same(back, tree)
    with pytest.raises(ValueError, match="different model"):
        pr.flat_to_tree(flat, spec.to_manifest(),
                        {"w": np.zeros((2, 2), np.float32)})


def test_convert_shapes_and_to_model_layout_are_jax():
    from bigdl_tpu.nn.attention import TransformerLM as JaxLM
    from bigdl_tpu_torch.interop import load_jax_params
    from bigdl_tpu_torch.nn import TransformerLM

    JaxRNG.set_seed(0)
    jm = JaxLM(64, 32, 4, 4, max_len=32)
    jm.build(jax.ShapeDtypeStruct((2, 16), jnp.int32))
    params = _np(jm.parameters()[0])
    model = load_jax_params(
        TransformerLM(64, 32, 4, 4, max_len=32, device="cpu"), params)
    s2 = jr.LayoutSpec.pp({"data": 1, "pipe": 2}, 2)
    rep = jr.LayoutSpec.replicated(block_layout="unrolled")
    shapes = pr.convert_shapes(params, rep.to_manifest(), s2.to_manifest())
    want = jr.convert_shapes(params, rep, s2)
    assert jax.tree.structure(shapes) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(shapes), jax.tree.leaves(want)):
        assert a.is_meta and tuple(a.shape) == tuple(b.shape)
    pp = _np(jr.blocks_to_pp_tree(params, 2))
    _same(pr.to_model_layout(pp, s2.to_manifest(), model),
          jr.to_model_layout(pp, s2, jm))
    space = JaxFlatParamSpace(params, 2)
    dp = jr.LayoutSpec.dp(2, space.padded_size, space.true_size)
    flat = np.asarray(space.flatten(params))
    _same(pr.to_model_layout(flat, dp.to_manifest(), model),
          jr.to_model_layout(flat, dp, jm))
    with pytest.raises(UnsupportedFeatureError, match="A8"):
        pr.redistribute(params, rep, s2, telemetry=object())


# --------------------------------------------------------------------------- #
# ep expert-count re-cut
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def moe_params():
    from bigdl_tpu.nn.moe import MoETransformerLM

    JaxRNG.set_seed(0)
    m = MoETransformerLM(32, 16, 2, 2, num_experts=4, k=2, max_len=8)
    m.build(jax.ShapeDtypeStruct((2, 8), jnp.int32))
    return _np(m.parameters()[0])


def test_expert_recut_is_jax(moe_params):
    p = moe_params
    assert pr.detect_num_experts(p) == jr.detect_num_experts(p) == 4
    A = jr.LayoutSpec.ep({"expert": 2}, num_experts=4)
    B = jr.LayoutSpec.ep({"expert": 4}, num_experts=8)
    grown = _both(p, A, B)
    assert grown["block0"]["moe"]["w1"].shape[0] == 8
    assert grown["block0"]["moe"]["gate"].shape[-1] == 8
    _same(_both(grown, B, A), p)
    moments = {"m": jax.tree.map(lambda a: a * 0.1, p),
               "v": jax.tree.map(lambda a: a * 0.2, p)}
    _same(_both(_both(moments, A, B), B, A), moments)
    # shapes only, both directions
    for src, dst, tree in ((A, B, p), (B, A, grown)):
        got = pr.convert_shapes(tree, src.to_manifest(), dst.to_manifest())
        want = jr.convert_shapes(tree, src, dst)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == tuple(b.shape)
    for experts, match in ((2, "genuinely distinct"), (6, "divide evenly")):
        dst = jr.LayoutSpec.ep({}, num_experts=experts)
        src = jr.LayoutSpec.ep({}, num_experts=4)
        with pytest.raises(ValueError, match=match) as want:
            jr.redistribute(p, src, dst)
        with pytest.raises(ValueError, match=match) as got:
            pr.redistribute(p, src.to_manifest(), dst.to_manifest())
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# DistriOptimizer: a tree snapshot is not a flat plane
# --------------------------------------------------------------------------- #


def test_distri_optimizer_refuses_a_tp_snapshot(tmp_path):
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
    from bigdl_tpu_torch.interop import to_jax_params
    from bigdl_tpu_torch.utils import file_io
    from bigdl_tpu_torch.utils.engine import Engine

    model = nn.TransformerLM(64, 32, 4, 2, max_len=32, device="cpu")
    method = optim.SGD()
    layout = pr.LayoutSpec.tp({"data": 1, "model": 2},
                              block_layout="unrolled").to_manifest()
    file_io.save_checkpoint(str(tmp_path), 2, to_jax_params(model), (),
                            {"neval": np.asarray(1, np.int32)},
                            {"neval": 2, "epoch": 1},
                            manifest_meta={"layout": layout})
    x = np.zeros((4, 8), np.int32)
    try:
        opt = optim.Optimizer(model, array_dataset(x, x)
                              >> SampleToMiniBatch(4),
                              nn.TimeDistributedCriterion(
                                  nn.FusedSoftmaxCrossEntropyCriterion()),
                              method, distributed=True, device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(3))
        opt.resume_from_checkpoint(str(tmp_path))
        with pytest.raises(ValueError,
                           match=r"cannot redistribute tp -> dp directly"):
            opt.optimize()
    finally:
        Engine.reset()
