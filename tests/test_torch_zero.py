"""The port's ZeRO-1 flat plane (``bigdl_tpu_torch/parallel/zero.py``)
against the JAX package's (``bigdl_tpu/parallel/zero.py``), on the CPU:
``FlatParamSpace``'s sizes, padding and block rounding, its flat vector
byte for byte (the JAX tree's leaf order, for a TransformerLM in both
block layouts and for a ResNet), ``chunk``, ``refit_flat_plane`` and
``repartition_ef_residual`` bitwise, and ``bind``: parameters and
gradients as views of the flat storages."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu.models.resnet import ResNetCifar as JResNetCifar
from bigdl_tpu.nn.attention import TransformerLM as JLM
from bigdl_tpu.parallel import zero as jz
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.models.resnet import ResNetCifar
from bigdl_tpu_torch.nn import TransformerLM
from bigdl_tpu_torch.parallel import zero as tz


def _tree():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((13, 7)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "sub": {"k": rng.standard_normal((2, 3)).astype(np.float32)}}


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.from_numpy(v)
    return out


@pytest.mark.parametrize("chunks,block", [(1, 1), (2, 1), (8, 1), (8, 64),
                                          (4, 256), (3, 16)])
def test_flat_space_layout_as_jax(chunks, block):
    tree = _tree()
    j = jz.FlatParamSpace(jax.tree.map(jnp.asarray, tree), chunks,
                          block_size=block)
    t = tz.FlatParamSpace(_named(tree), chunks, block_size=block)
    assert (t.true_size, t.padded_size, t.chunk_size, t.block_size) == \
        (j.true_size, j.padded_size, j.chunk_size, j.block_size)
    flat = t.flatten(_named(tree))
    want = np.asarray(j.flatten(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_array_equal(flat.numpy(), want)
    for i in range(chunks):
        np.testing.assert_array_equal(t.chunk(flat, i).numpy(),
                                      np.asarray(j.chunk(jnp.asarray(want),
                                                         i)))
    back = t.unflatten(flat)
    for name, leaf in _named(tree).items():
        assert torch.equal(back[name], leaf)


@pytest.mark.parametrize("scan", [False, True])
def test_transformer_params_flat_bytes_as_jax(scan):
    jm = JLM(50, 32, 4, 3, max_len=16, scan_layers=scan)
    jm.build(jax.ShapeDtypeStruct((2, 8), jnp.int32),
             rng=jax.random.PRNGKey(1))
    tree = jm.parameters()[0]
    tm = load_jax_params(TransformerLM(50, 32, 4, 3, max_len=16,
                                       device="cpu", scan_layers=scan),
                         jax.tree.map(np.asarray, tree))
    want = np.asarray(jz.FlatParamSpace(tree, 4, 64).flatten(tree))
    got = tz.FlatParamSpace(dict(tm.named_parameters()), 4, 64).flatten(
        dict(tm.named_parameters()))
    assert got.numpy().tobytes() == want.tobytes()


def test_resnet_params_flat_bytes_as_jax():
    jm = JResNetCifar(depth=8, class_num=10)
    jm.build(jax.ShapeDtypeStruct((2, 16, 16, 3), jnp.float32))
    tree = jm.parameters()[0]
    tm = load_jax_params(ResNetCifar(depth=8, class_num=10, device="cpu"),
                         jax.tree.map(np.asarray, tree))
    want = np.asarray(jz.FlatParamSpace(tree, 2).flatten(tree))
    got = tz.FlatParamSpace(dict(tm.named_parameters()), 2).flatten(
        dict(tm.named_parameters()))
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("shape,padded,true", [
    ((100,), 128, 97), ((128,), 100, 97), ((3, 64), 96, 60),
    ((3, 96), 64, 60), ((), 64, 10), ((64,), 64, 60)])
def test_refit_flat_plane_as_jax(shape, padded, true):
    a = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jz.refit_flat_plane(jnp.asarray(a), padded, true))
    np.testing.assert_array_equal(tz.refit_flat_plane(a, padded, true), want)
    np.testing.assert_array_equal(
        tz.refit_flat_plane(torch.from_numpy(a), padded, true).numpy(), want)


def test_refit_refuses_to_drop_parameters():
    for fn in (jz.refit_flat_plane, tz.refit_flat_plane):
        with pytest.raises(ValueError, match="fewer parameters"):
            fn(np.zeros(128, np.float32), 64, 100)


@pytest.mark.parametrize("rows,true,chunks,padded", [
    (2, 250, 4, 256), (4, 250, 2, 256), (8, 1000, 2, 1024),
    (2, 100, 2, 128)])
def test_repartition_ef_residual_as_jax(rows, true, chunks, padded):
    rng = np.random.default_rng(rows)
    old_padded = (true + rows * 16 - 1) // (rows * 16) * (rows * 16)
    ef = rng.standard_normal((rows, old_padded)).astype(np.float32)
    ef[:, true:] = 0.0
    want = jz.repartition_ef_residual(ef, true, chunks, padded)
    got = tz.repartition_ef_residual(ef, true, chunks, padded)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(0)[:true], ef.sum(0)[:true],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="2-D"):
        tz.repartition_ef_residual(ef[0], true, chunks, padded)


def test_bind_views_and_gradient_accumulation():
    m = TransformerLM(50, 32, 4, 2, max_len=16, device="cpu")
    before = {k: p.detach().clone() for k, p in m.named_parameters()}
    space = tz.FlatParamSpace(dict(m.named_parameters()), 2, 64)
    params_flat, grad_flat = space.bind(m)
    for name, view in space.unflatten(params_flat).items():
        p = dict(m.named_parameters())[name]
        assert p.data_ptr() == view.data_ptr()
        assert torch.equal(p.detach(), before[name])
        assert p.grad.data_ptr() == \
            space.unflatten(grad_flat)[name].data_ptr()
    assert not params_flat[space.true_size:].any()
    x = torch.randint(0, 50, (2, 8))
    m(x).float().square().mean().backward()
    assert grad_flat[:space.true_size].abs().sum() > 0
    assert not grad_flat[space.true_size:].any()
    m.zero_grad(set_to_none=True)
    space.bind_grads()
    assert all(p.grad is not None for p in m.parameters())
    with torch.no_grad():
        params_flat.add_(1.0)
    assert torch.equal(m.wte.detach(), before["wte"] + 1.0)
    space.unbind_grads()
    assert all(p.grad is None for p in m.parameters())
    assert tz.rank_rows((np.arange(8), None), 1, 4)[0].tolist() == [2, 3]


def test_bind_once_keeps_the_plane_and_drops_stale_eval_graphs():
    """A second bind of the same layout keeps the planes (the tensors a
    captured graph reads stay put); the first, and one of another
    layout, move the parameters and drop the model's eval graphs."""
    import copy

    from bigdl_tpu_torch.optim.validation import compiled_eval_step

    m = TransformerLM(50, 32, 4, 2, max_len=16, device="cpu")
    x = torch.randint(0, 50, (2, 8))
    step = compiled_eval_step(m)
    want = step(x).clone()
    assert step.executables() == 1
    space = tz.FlatParamSpace(dict(m.named_parameters()), 2, 64)
    params_flat, grad_flat = space.bind(m)
    assert step.executables() == 0                 # moved: graphs dropped
    torch.testing.assert_close(step(x), want, rtol=0, atol=0)
    grad_flat.fill_(3.0)
    again = tz.FlatParamSpace(dict(m.named_parameters()), 2, 64)
    p2, g2 = again.bind(m)
    assert p2 is params_flat and g2 is grad_flat and not g2.any()
    assert step.executables() == 1                 # nothing moved
    wide = tz.FlatParamSpace(dict(m.named_parameters()), 4, 1000)
    assert wide.padded_size != space.padded_size
    other, _ = wide.bind(m)
    assert other is not params_flat and step.executables() == 0
    assert torch.equal(other[:space.true_size], params_flat[:space.true_size])
    twin = copy.deepcopy(m)
    assert not twin.__dict__["_flat_planes"]
    t_flat, _ = again.bind(twin)
    assert t_flat.data_ptr() != params_flat.data_ptr()
    assert torch.equal(t_flat, params_flat)
