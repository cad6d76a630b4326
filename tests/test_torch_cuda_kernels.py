"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests are marked ``cuda`` and skip where no card is present;
the file imports no JAX, so it also runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-4 abs + 1e-4 rel (sums taken in another order than
the plain version); bf16 outputs round to 8 mantissa bits, 2e-2.
"""

import pytest
import torch

from bigdl_tpu_torch.ops import flash_attention as fa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


def require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def cuda():
    require_cuda()
    return torch.device("cuda")


def test_cuda_tests_skip_without_a_card():
    """Without a card a kernel test is skipped, never failed."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the kernel tests run")
    with pytest.raises(pytest.skip.Exception):
        require_cuda()


def _close(got, want, dtype):
    tol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _rand(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t,causal", [(1, True), (63, True), (200, True),
                                      (257, False)])
def test_flash_attention_kernel(cuda, dtype, d, t, causal):
    g = torch.Generator(device=cuda).manual_seed(t + d)
    h = 3
    # q, k, v as strided views of one fused projection buffer
    qkv = _rand(g, (2, t, 3 * h * d), dtype, cuda)
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    _close(got, fa.flash_attention_reference(q, k, v, causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("t", [1, 100, 1000])
def test_flash_decode_kernel(cuda, dtype, d, t):
    g = torch.Generator(device=cuda).manual_seed(t + d)
    b, h = 5, 3
    q = _rand(g, (b, 1, h, d), dtype, cuda)
    k, v = (_rand(g, (b, t, h, d), dtype, cuda) for _ in range(2))
    pos = torch.randint(0, t, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, t - 1
    before = fa.LAUNCHES["flash_decode_attention"]
    got = fa.flash_decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode_attention"] == before + 1
    _close(got, fa.flash_decode_attention_reference(q, k, v, pos), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("bs", [1, 5, 16, 128])
def test_flash_paged_decode_kernel(cuda, dtype, d, bs):
    g = torch.Generator(device=cuda).manual_seed(bs + d)
    b, h, max_len = 4, 3, 300
    mb = -(-max_len // bs)
    nb = b * mb + 1
    kp, vp = (_rand(g, (nb, bs, h, d), dtype, cuda) for _ in range(2))
    tables = torch.randperm(nb - 1, generator=g, device=cuda).reshape(
        b, mb).to(torch.int32)
    pos = torch.randint(0, max_len, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, max_len - 1
    q = _rand(g, (b, 1, h, d), dtype, cuda)
    before = fa.LAUNCHES["flash_paged_decode_attention"]
    got = fa.flash_paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_paged_decode_attention"] == before + 1
    _close(got, fa.flash_paged_decode_attention_reference(
        q, kp, vp, tables, pos), dtype)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 1, 2, 64), device=cuda)
    k = torch.zeros((2, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_decode_attention(q, k, k, torch.zeros(2, dtype=torch.int64,
                                                       device=cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_decode_attention(q, k.cpu(), k, torch.zeros(
            2, dtype=torch.int32, device=cuda))
