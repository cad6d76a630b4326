"""The port's attention kernels' plain versions against the JAX package's
kernels, on the CPU (``bigdl_tpu_torch/ops/flash_attention.py`` vs
``bigdl_tpu/ops/flash_attention.py``).

K1 is held against ``flash_attention(interpret=True)`` and against
``dot_product_attention``; K2 against ``flash_decode_attention
(interpret=True)``; K3 against the XLA gather path of
``MultiHeadAttention._apply_paged`` (the Pallas paged kernel does not
trace on the installed JAX).  Inputs come from one numpy seed; the
tolerance is 1e-4 abs and rel in fp32 (same math, sums in another
order).  The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import ast
import pathlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.nn.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.flash_attention import (flash_attention as jax_flash,
                                           flash_decode_attention as
                                           jax_flash_decode)
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("t,block,causal", [(64, 32, True), (64, 64, False),
                                            (40, 40, True), (24, 8, False)])
def test_flash_attention_matches_pallas_interpret(t, block, causal):
    rng = np.random.default_rng(t + block)
    q, k, v = (_arr(rng, 2, t, 3, 16) for _ in range(3))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=block,
                               block_k=block, interpret=True)
    got = fa.flash_attention_reference(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("t", [1, 37, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_plain_jax_on_ragged_t(t, causal):
    rng = np.random.default_rng(t)
    q, k, v = (_arr(rng, 2, t, 4, 32) for _ in range(3))
    want = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    # the wrapper itself: CPU tensors take the plain version, no launch
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert fa.LAUNCHES == before
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("t", [16, 64])
def test_flash_decode_matches_pallas_interpret(t):
    rng = np.random.default_rng(t)
    b = 4
    q = _arr(rng, b, 1, 3, 16)
    k, v = _arr(rng, b, t, 3, 16), _arr(rng, b, t, 3, 16)
    pos = np.array([0, t - 1, 5, t // 2], np.int32)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(pos),
                                      interpret=True)
    got = fa.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("bs", [4, 16])
def test_flash_paged_decode_matches_jax_gather_path(bs):
    """The gather path of ``_apply_paged`` (nn/attention.py:420-426)."""
    rng = np.random.default_rng(bs)
    b, h, d, mb = 3, 4, 16, 6
    nb = b * mb + 1
    q = _arr(rng, b, 1, h, d)
    kp, vp = _arr(rng, nb, bs, h, d), _arr(rng, nb, bs, h, d)
    tables = rng.permutation(nb - 1)[:b * mb].reshape(b, mb).astype(np.int32)
    tables[2, 2:] = nb - 1                     # unmapped -> trash block
    pos = np.array([bs * 3 + 1, bs * mb - 1, bs + 2], np.int32)
    ctx = mb * bs
    ck = jnp.take(jnp.asarray(kp), jnp.asarray(tables), axis=0).reshape(
        b, ctx, h, d)
    cv = jnp.take(jnp.asarray(vp), jnp.asarray(tables), axis=0).reshape(
        b, ctx, h, d)
    mask = (jnp.arange(ctx)[None, :]
            <= jnp.asarray(pos)[:, None])[:, None, None, :]
    want = jax_dpa(jnp.asarray(q), ck, cv, mask=mask)
    got = fa.flash_paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_row_that_sees_no_key_is_zero_not_nan():
    """The kernels' -inf-safe normalisation (``max(l, 1e-30)``)."""
    q = torch.ones((1, 1, 1, 16))
    k = torch.ones((1, 4, 1, 16))
    out = fa.flash_decode_attention(q, k, k, torch.tensor([-1],
                                                          dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))


def test_wrapper_raises_off_cpu_and_cuda():
    """A tensor the kernel cannot take raises; nothing falls back."""
    q = torch.zeros((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, q, q)
    cpu = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(cpu, q, q)


def test_build_targets_hopper_and_needs_nvcc():
    for src in _build.SOURCES:
        cmd = _build.nvcc_command("nvcc", pathlib.Path("out.so"), src)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert str(src) in cmd and src.exists()
        assert _build.library_path(src).parent == _build.build_dir()
    # one library per source, each named by its own hash
    assert len({_build.library_path(s) for s in _build.SOURCES}) == \
        len(_build.SOURCES)
    try:
        _build.find_nvcc()
    except RuntimeError as e:              # no toolkit here: a clear error
        assert "nvcc not found" in str(e)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "bigdl_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              *sorted((ROOT / "tools").glob("torch_*.py"))]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "bigdl_tpu", "bigdl"), \
                f"{path.relative_to(ROOT)} imports {mod}"
