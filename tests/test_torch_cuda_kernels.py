"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests are marked ``cuda`` and skip where no card is present
(the finite-difference checks of the plain gradients run everywhere);
the file imports no JAX, so it also runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-4 abs + 1e-4 rel (sums taken in another order than
the plain version); bf16 outputs round to 8 mantissa bits, 2e-2.
"""

import pytest
import torch

from bigdl_tpu_torch.ops import cross_entropy as ce
from bigdl_tpu_torch.ops import flash_attention as fa
from bigdl_tpu_torch.ops.quantization import quantize_blockwise

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


def _close(got, want, dtype, msg=None):
    tol = TOL[dtype]
    assert got.dtype == want.dtype and got.shape == want.shape, msg
    assert torch.isfinite(got.float()).all(), msg
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=msg and (lambda m: f"{msg}: {m}"))


def _rand(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


#: sequence lengths that put ragged edges on both query tile sizes (16, 64)
#: and on the 64-row key tiles
ATTN_T = [1, 15, 16, 17, 63, 64, 65, 200, 1024]


def _qkv_views(buf, h, d):
    """q, k, v as strided views of one fused projection buffer."""
    return [x.unflatten(-1, (h, d)) for x in buf.split(h * d, dim=-1)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel(cuda, monkeypatch, causal, d, dtype, rows):
    """K1 on both query tile sizes (the wrapper's choice forced), at every
    length of ``ATTN_T``."""
    monkeypatch.setattr(fa, "query_tile_rows", lambda b, h, t, sms: rows)
    h = 3
    for t in ATTN_T:
        g = torch.Generator(device=cuda).manual_seed(t + d)
        q, k, v = _qkv_views(_rand(g, (2, t, 3 * h * d), dtype, cuda), h, d)
        before = fa.LAUNCHES["flash_attention"]
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == before + 1
        _close(got, fa.flash_attention_reference(q, k, v, causal), dtype,
               f"T {t}")


#: element offsets of q/k/v views that are not 16-byte aligned: fp32 at 1
#: (4-byte cp.async), bf16 at 2 (4-byte) and at 1 (2-byte plain loads)
MISALIGNED = [(torch.float32, 1), (torch.bfloat16, 2), (torch.bfloat16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", MISALIGNED)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernels_on_misaligned_views(cuda, dtype, offset,
                                                     causal):
    """K1 and K1-bwd on views whose base and row stride are not 16-byte
    aligned (the narrower copy paths), against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(offset)
    b, t, h, d = 2, 130, 3, 64
    width = 3 * h * d + offset
    buf = _rand(g, (b, t, width), dtype, cuda)[..., offset:]
    q, k, v = _qkv_views(buf, h, d)
    assert q.data_ptr() % 16 and q.stride(1) * q.element_size() % 16
    out, lse = fa._flash_forward(q, k, v, causal, with_lse=True)
    _close(out, fa.flash_attention_reference(q, k, v, causal), dtype)
    dout = _rand(g, (b, t, h, d), dtype, cuda)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, dout, causal)
    for a, w in zip(got, want):
        _close(a, w, dtype)


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


#: the split counts K2/K3/K3q are forced to: one cluster of S blocks a row
SPLITS = range(1, fa.DECODE_MAX_SPLITS + 1)
#: K2's cache lengths: one position, both sides of a 32-position tile,
#: a ragged and a whole multiple of the tile, and past the engine's 1024
DECODE_T = [1, 31, 32, 33, 1000, 1024, 4096]


def _decode_frontiers(g, b, t, cuda):
    """pos (B,) int32 for a cache of ``t``: -1 (nothing visible), 0, both
    sides of a tile edge, the last position, past it (the kernel clamps
    to ``t``), the rest random."""
    pos = torch.randint(0, t, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    edges = torch.tensor([-1, 0, 31, 32, 33, t - 1, t, t + 40], device=cuda)
    pos[:len(edges)] = edges.clamp(min=-1, max=t + 40).to(torch.int32)
    return pos


def _strided_cache(g, b, t, h, d, dtype, cuda):
    """k, v as views of one (B, T + 7, 2, H, D) buffer, rows 3 to T + 3:
    strided on every axis but the last, as a slice of a larger cache."""
    buf = _rand(g, (b, t + 7, 2, h, d), dtype, cuda)[:, 3:t + 3]
    return buf[:, :, 0], buf[:, :, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_decode_split_kernel(cuda, monkeypatch, dtype, d):
    """K2 against its plain version with the split count forced from 1 to
    8 (``decode_splits``), at every length of ``DECODE_T``, on a strided
    view of a cache, with frontiers at -1, 0, on a tile edge, at the last
    position and past it.  Positions past each row's frontier then hold
    NaN, which the kernel must never read.  One launch a call."""
    b, h = 10, 3
    for t in DECODE_T:
        for splits in SPLITS:
            monkeypatch.setattr(fa, "decode_splits",
                                lambda bh, limit, sms: splits)
            g = torch.Generator(device=cuda).manual_seed(t + d + splits)
            k, v = _strided_cache(g, b, t, h, d, dtype, cuda)
            pos = _decode_frontiers(g, b, t, cuda)
            q = _rand(g, (b, 1, h, d), dtype, cuda)
            want = fa.flash_decode_attention_reference(q, k, v, pos)
            hidden = torch.arange(t, device=cuda)[None, :] > pos[:, None]
            k[hidden], v[hidden] = float("nan"), float("nan")
            before = fa.LAUNCHES["flash_decode_attention"]
            got = fa.flash_decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
            assert fa.LAUNCHES["flash_decode_attention"] == before + 1
            _close(got, want, dtype, f"T {t} S {splits}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_decode_kernel_is_deterministic(cuda, monkeypatch, dtype):
    """K2 merges its splits in rank order inside the cluster: two calls
    agree bit for bit, at the engine's split count (B9 H12) and at 8."""
    g = torch.Generator(device=cuda).manual_seed(12)
    b, t, h, d = 9, 1024, 12, 64
    k, v = _strided_cache(g, b, t, h, d, dtype, cuda)
    pos = _decode_frontiers(g, b, t, cuda)
    q = _rand(g, (b, 1, h, d), dtype, cuda)
    for splits in (fa.decode_splits(b * h, t), 8):
        monkeypatch.setattr(fa, "decode_splits",
                            lambda bh, limit, sms: splits)
        assert torch.equal(fa.flash_decode_attention(q, k, v, pos),
                           fa.flash_decode_attention(q, k, v, pos))


@pytest.mark.cuda
def test_flash_decode_raises_when_the_cluster_launch_is_refused(
        cuda, monkeypatch):
    """K2 with 9 splits (past the portable cluster size) is refused, and
    the wrapper raises rather than fall back."""
    monkeypatch.setattr(fa, "decode_splits", lambda bh, limit, sms: 9)
    q = torch.zeros((2, 1, 2, 64), device=cuda)
    k = torch.zeros((2, 300, 2, 64), device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = dict(fa.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_decode_attention(q, k, k, pos)
    assert fa.LAUNCHES == before


@pytest.mark.cuda
def test_contiguous_engine_decodes_through_k2_and_never_k3(cuda):
    from bigdl_tpu_torch.nn import TransformerLM
    from bigdl_tpu_torch.serving import ServingEngine

    model = TransformerLM(64, 64, 4, 2, max_len=64, device=cuda)
    before = dict(fa.LAUNCHES)
    with ServingEngine(model, decode_slots=2, decode_max_len=48,
                       kv_cache="contiguous", device=cuda) as eng:
        out = eng.generate([1, 2, 3, 4, 5], max_new_tokens=6).result(120)
    assert len(out) == 6
    assert fa.LAUNCHES["flash_decode_attention"] >= \
        before["flash_decode_attention"] + 5
    for name in ("flash_paged_decode_attention",
                 "flash_paged_decode_attention_int8"):
        assert fa.LAUNCHES[name] == before[name]


def _frontiers(g, b, bs, limit, cuda):
    """pos (B,) int32: 0, both sides of a page edge and of a 32-position
    tile edge, the last addressable position, the rest random."""
    pos = torch.randint(0, limit, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    edges = torch.tensor([0, bs - 1, bs, 31, 32, limit - 1], device=cuda)
    pos[:len(edges)] = edges.clamp(max=limit - 1).to(torch.int32)
    return pos


def _tables(g, b, mb, nb, bs, pos, cuda):
    """Shuffled block tables whose entries past each row's frontier name
    the trash block ``nb - 1``."""
    tables = torch.randperm(nb - 1, generator=g, device=cuda)[:b * mb] \
        .reshape(b, mb).to(torch.int32)
    used = (pos.long() // bs + 1)[:, None]
    return torch.where(torch.arange(mb, device=cuda)[None, :] < used,
                       tables, torch.full_like(tables, nb - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("bs", [1, 5, 16, 128])
def test_flash_paged_decode_kernel(cuda, monkeypatch, dtype, d, bs):
    """K3 against its plain version with the split count forced from 1 to
    8 (``decode_splits``), frontiers at 0, on page and tile edges and at
    the last addressable position, pools of 300 positions a row and of one
    block (max_blocks 1); the trash block holds NaNs, which the kernel must
    never read (the plain version reads it on a copy holding zeros).  One
    launch a call."""
    b, h = 8, 3
    for max_len in (300, bs):
        mb = -(-max_len // bs)
        nb = b * mb + 1
        for splits in SPLITS:
            monkeypatch.setattr(fa, "decode_splits",
                                lambda bh, limit, sms: splits)
            g = torch.Generator(device=cuda).manual_seed(bs + d + splits)
            kp, vp = (_rand(g, (nb, bs, h, d), dtype, cuda)
                      for _ in range(2))
            pos = _frontiers(g, b, bs, mb * bs, cuda)
            tables = _tables(g, b, mb, nb, bs, pos, cuda)
            q = _rand(g, (b, 1, h, d), dtype, cuda)
            want = fa.flash_paged_decode_attention_reference(
                q, kp, vp, tables, pos)
            kp[nb - 1], vp[nb - 1] = float("nan"), float("nan")
            before = fa.LAUNCHES["flash_paged_decode_attention"]
            got = fa.flash_paged_decode_attention(q, kp, vp, tables, pos)
            torch.cuda.synchronize()
            assert fa.LAUNCHES["flash_paged_decode_attention"] == before + 1
            _close(got, want, dtype, f"max_len {max_len} S {splits}")


def _int8_pools(g, shape, cuda):
    """Random K and V pools quantized as the int8 pool stores them: one
    fp32 absmax scale per head_dim vector -> (k8, k_scale, v8, v_scale)."""
    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=g, device=cuda)
        q8, sc = quantize_blockwise(x.reshape(-1), shape[-1],
                                    scale_dtype=torch.float32)
        out += [q8.reshape(shape), sc.reshape(*shape[:-1], 1)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("bs", [1, 4, 5, 16, 128])
def test_flash_paged_decode_int8_kernel(cuda, monkeypatch, dtype, d, bs):
    """K3q against its plain version with the split count forced from 1
    to 8, frontiers at 0, on page and tile edges and at the end, pools of
    300 positions a row and of one block (max_blocks 1); unmapped table
    entries name the trash block, which holds garbage at the int8 rails
    and scale 1e4; one visible vector has payload 0 and scale 0 (the
    non-finite case).  The output is fp32 for fp32 and bf16 queries; one
    launch of K3q and none of K3 a call."""
    b, h = 8, 3
    for max_len in (300, bs):
        mb = -(-max_len // bs)
        nb = b * mb + 1
        trash = nb - 1
        for splits in SPLITS:
            monkeypatch.setattr(fa, "decode_splits",
                                lambda bh, limit, sms: splits)
            g = torch.Generator(device=cuda).manual_seed(3 * bs + d + splits)
            k8, ks, v8, vs = _int8_pools(g, (nb, bs, h, d), cuda)
            k8[trash], v8[trash] = 127, -127
            ks[trash], vs[trash] = 1e4, 1e4
            pos = _frontiers(g, b, bs, mb * bs, cuda)
            tables = _tables(g, b, mb, nb, bs, pos, cuda)
            first = tables[3, 0].long()
            k8[first, 0], ks[first, 0] = 0, 0.0
            v8[first, 0], vs[first, 0] = 0, 0.0
            q = _rand(g, (b, 1, h, d), dtype, cuda)
            before = dict(fa.LAUNCHES)
            got = fa.flash_paged_decode_attention(q, k8, v8, tables, pos,
                                                  k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            assert fa.LAUNCHES["flash_paged_decode_attention_int8"] == \
                before["flash_paged_decode_attention_int8"] + 1
            assert fa.LAUNCHES["flash_paged_decode_attention"] == \
                before["flash_paged_decode_attention"]
            want = fa.flash_paged_decode_attention_reference(
                q, k8, v8, tables, pos, ks, vs)
            assert want.dtype == torch.float32
            _close(got, want, torch.float32, f"max_len {max_len} S {splits}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_kernels_are_deterministic(cuda, monkeypatch, dtype):
    """K3 and K3q merge their splits in rank order inside the cluster (no
    workspace, no atomics): two calls agree bit for bit, at the engine's
    split count and at 8."""
    g = torch.Generator(device=cuda).manual_seed(11)
    b, h, d, bs, mb = 8, 12, 64, 16, 64
    nb = b * mb + 1
    kp, vp = (_rand(g, (nb, bs, h, d), dtype, cuda) for _ in range(2))
    k8, ks, v8, vs = _int8_pools(g, (nb, bs, h, d), cuda)
    pos = _frontiers(g, b, bs, mb * bs, cuda)
    tables = _tables(g, b, mb, nb, bs, pos, cuda)
    q = _rand(g, (b, 1, h, d), dtype, cuda)
    for splits in (fa.decode_splits(b * h, mb * bs), 8):
        monkeypatch.setattr(fa, "decode_splits",
                            lambda bh, limit, sms: splits)
        for call in (
                lambda: fa.flash_paged_decode_attention(q, kp, vp, tables,
                                                        pos),
                lambda: fa.flash_paged_decode_attention(
                    q, k8, v8, tables, pos, k_scale=ks, v_scale=vs)):
            assert torch.equal(call(), call())


@pytest.mark.cuda
def test_paged_decode_raises_when_the_cluster_launch_is_refused(
        cuda, monkeypatch):
    """A split count the kernel does not take (9: past the portable
    cluster size) is refused by the launch, and the wrapper raises rather
    than fall back."""
    monkeypatch.setattr(fa, "decode_splits", lambda bh, limit, sms: 9)
    q = torch.zeros((2, 1, 2, 64), device=cuda)
    pool = torch.zeros((3, 4, 2, 64), device=cuda)
    tables = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = dict(fa.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_paged_decode_attention(q, pool, pool, tables, pos)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_paged_decode_attention(
            q, pool.to(torch.int8), pool.to(torch.int8), tables, pos,
            k_scale=pool[..., :1], v_scale=pool[..., :1])
    assert fa.LAUNCHES == before


@pytest.mark.cuda
def test_int8_engine_decodes_through_k3q_and_never_k3(cuda):
    from bigdl_tpu_torch.nn import TransformerLM
    from bigdl_tpu_torch.serving import ServingEngine

    model = TransformerLM(64, 64, 4, 2, max_len=64, device=cuda)
    before = dict(fa.LAUNCHES)
    with ServingEngine(model, decode_slots=2, decode_max_len=48,
                       kv_block_size=4, kv_cache_dtype="int8",
                       device=cuda) as eng:
        out = eng.generate([1, 2, 3, 4, 5], max_new_tokens=6).result(120)
    assert len(out) == 6
    assert fa.LAUNCHES["flash_paged_decode_attention_int8"] >= \
        before["flash_paged_decode_attention_int8"] + 5
    assert fa.LAUNCHES["flash_paged_decode_attention"] == \
        before["flash_paged_decode_attention"]


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
    pool = torch.zeros((3, 4, 2, 64), device=cuda)
    scale = torch.zeros((3, 4, 2, 1), device=cuda)
    tables = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        fa.flash_paged_decode_attention(q, pool, pool, tables, pos,
                                        k_scale=scale, v_scale=scale)
    with pytest.raises(ValueError, match="fp32"):
        fa.flash_paged_decode_attention(
            q, pool.to(torch.int8), pool.to(torch.int8), tables, pos,
            k_scale=scale.double(), v_scale=scale.double())


# --------------------------------------------------------------------------- #
# K1-bwd, K4, K5 (the training path)
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernel(cuda, causal, d, dtype):
    """K1 forward (with lse) and K1-bwd through the autograd Function,
    on q/k/v views of one fused buffer, against autograd of the plain
    version, at every length of ``ATTN_T``."""
    h = 3
    for t in ATTN_T:
        g = torch.Generator(device=cuda).manual_seed(t + d + 1)
        qkv = _rand(g, (2, t, 3 * h * d), dtype, cuda).requires_grad_(True)
        dout = _rand(g, (2, t, h, d), dtype, cuda)
        before = dict(fa.LAUNCHES)
        out = fa.flash_attention(*_qkv_views(qkv, h, d), causal=causal)
        out.backward(dout)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == \
            before["flash_attention"] + 1
        assert fa.LAUNCHES["flash_attention_bwd"] == \
            before["flash_attention_bwd"] + 1
        want = fa.flash_attention_bwd_reference(
            *_qkv_views(qkv.detach(), h, d), dout, causal)
        _close(qkv.grad, torch.cat([w.flatten(-2) for w in want], dim=-1),
               dtype, f"T {t}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_bwd_is_deterministic(cuda, dtype):
    """Each gradient row is summed by one block in a fixed order (no
    atomics): two calls on the same inputs agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(5)
    b, t, h, d = 2, 300, 4, 64
    q, k, v = _qkv_views(_rand(g, (b, t, 3 * h * d), dtype, cuda), h, d)
    dout = _rand(g, (b, t, h, d), dtype, cuda)
    out, lse = fa._flash_forward(q, k, v, True, with_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, True)
    second = fa.flash_attention_bwd(q, k, v, out, lse, dout, True)
    for a, w in zip(first, second):
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_flash_attention_without_grad_writes_no_lse(cuda):
    """Serving (no grad) takes the plain K1 launch; only grad-enabled
    calls go through the Function and keep an lse."""
    q = torch.randn((1, 70, 2, 64), device=cuda, requires_grad=True)
    with torch.no_grad():
        out = fa.flash_attention(q, q, q)
    assert out.grad_fn is None
    assert fa.flash_attention(q, q, q).grad_fn is not None


def _labels(g, n, v, dev):
    y = torch.randint(0, v, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    if n > 2:
        y[0], y[1] = -1, v + 3       # outside [0, V): no logit, no one-hot
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,v", [(1, 1), (7, 1000), (33, 513), (5, 4099),
                                 (64, 32000)])
def test_cross_entropy_kernels(cuda, dtype, n, v):
    g = torch.Generator(device=cuda).manual_seed(n + v)
    x = (3 * _rand(g, (n, v), torch.float32, cuda)).to(dtype)
    y = _labels(g, n, v, cuda)
    before = dict(ce.LAUNCHES)
    loss, lse = ce.fused_softmax_cross_entropy_fwd(x, y)
    gr = torch.rand(n, generator=g, device=cuda)
    dx = ce.fused_softmax_cross_entropy_bwd(x, y, lse, gr)
    torch.cuda.synchronize()
    assert ce.LAUNCHES["fused_softmax_cross_entropy"] == \
        before["fused_softmax_cross_entropy"] + 1
    assert ce.LAUNCHES["fused_softmax_cross_entropy_bwd"] == \
        before["fused_softmax_cross_entropy_bwd"] + 1
    want_loss, want_lse = ce.fused_softmax_cross_entropy_reference(x, y)
    _close(loss, want_loss, torch.float32)
    _close(lse, want_lse, torch.float32)
    _close(dx, ce.fused_softmax_cross_entropy_grad_reference(
        x, y, want_lse, gr), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_entropy_kernels_on_unaligned_rows(cuda, dtype):
    """Rows whose start is not 16-byte aligned take the scalar loads."""
    g = torch.Generator(device=cuda).manual_seed(3)
    base = _rand(g, (9, 1001), torch.float32, cuda).to(dtype)
    x = base[:, 1:]                              # row stride 1001, offset 1
    y = _labels(g, 9, 1000, cuda)
    loss, lse = ce.fused_softmax_cross_entropy_fwd(x, y)
    dx = ce.fused_softmax_cross_entropy_bwd(x, y, lse,
                                            torch.ones(9, device=cuda))
    want_loss, want_lse = ce.fused_softmax_cross_entropy_reference(x, y)
    _close(loss, want_loss, torch.float32)
    _close(dx, ce.fused_softmax_cross_entropy_grad_reference(
        x, y, want_lse, torch.ones(9, device=cuda)), dtype)


@pytest.mark.cuda
def test_cross_entropy_function_on_the_card(cuda):
    """The autograd Function: a mean's gradient reaches K5 as 1/N rows."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = _rand(g, (100, 2000), torch.float32, cuda).requires_grad_(True)
    y = _labels(g, 100, 2000, cuda)
    ce.fused_softmax_cross_entropy(x, y).mean().backward()
    xr = x.detach().requires_grad_(True)
    ce.fused_softmax_cross_entropy_reference(xr, y)[0].mean().backward()
    # times N: the softmax terms are then of the order of p, not p / N
    _close(x.grad * 100, xr.grad * 100, torch.float32)


# --------------------------------------------------------------------------- #
# bf16 mixed precision (compute_dtype)
# --------------------------------------------------------------------------- #

@pytest.mark.cuda
def test_bf16_flash_attention_function_at_the_training_strides(cuda):
    """The bf16 autograd Function at the training step's layout: q, k, v
    bf16 views of one (B, T, 3 * 768) projection, H 12, D 64, T 1024,
    and a bf16 ``dout``; counted as bf16 launches."""
    g = torch.Generator(device=cuda).manual_seed(7)
    h, d, t = 12, 64, 1024
    qkv = _rand(g, (2, t, 3 * h * d), torch.bfloat16, cuda)
    qkv.requires_grad_(True)
    q, k, v = _qkv_views(qkv, h, d)
    assert q.stride() == (t * 3 * h * d, 3 * h * d, d, 1)
    dout = _rand(g, (2, t, h, d), torch.bfloat16, cuda)
    before, bf16 = dict(fa.LAUNCHES), dict(fa.BF16_LAUNCHES)
    out = fa.flash_attention(q, k, v, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention_bwd"):
        assert fa.LAUNCHES[name] == before[name] + 1
        assert fa.BF16_LAUNCHES[name] == bf16[name] + 1
    views = _qkv_views(qkv.detach(), h, d)
    _close(out, fa.flash_attention_reference(*views, True), torch.bfloat16)
    want = fa.flash_attention_bwd_reference(*views, dout, True)
    _close(qkv.grad, torch.cat([w.flatten(-2) for w in want], dim=-1),
           torch.bfloat16)


@pytest.mark.cuda
def test_bf16_train_step_runs_the_bf16_kernels(cuda):
    """A bf16 step of a 2-layer TransformerLM on the card: fp32 gradients
    on every fp32 master, the bf16 K1 and K1-bwd once a layer and no fp32
    launch of them, and a loss within bf16 precision of the fp32 step's
    (1e-2 relative)."""
    from bigdl_tpu_torch import nn, optim

    x = torch.randint(0, 256, (2, 64), device=cuda)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = nn.TransformerLM(256, 128, 2, 2, max_len=64, device=cuda)
        crit = nn.TimeDistributedCriterion(
            nn.FusedSoftmaxCrossEntropyCriterion())
        step = optim.make_train_step(model, crit, optim.SGD(0.0),
                                     compute_dtype=dtype)
        fa.reset_launch_counts()
        _, loss = step({"neval": 0}, x, x)
        torch.cuda.synchronize()
        losses[dtype] = loss.item()
        assert all(p.dtype == p.grad.dtype == torch.float32
                   and p.grad.abs().sum() > 0 for p in model.parameters())
    assert fa.LAUNCHES["flash_attention"] == \
        fa.BF16_LAUNCHES["flash_attention"] == 2
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        fa.BF16_LAUNCHES["flash_attention_bwd"] == 2
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) < \
        1e-2 * losses[torch.float32]


@pytest.mark.cuda
def test_fp16_is_refused_naming_the_roadmap(cuda):
    """No kernel takes fp16: the wrapper and a fp16 train step raise,
    naming ROADMAP A1; the plain path never serves it on the card."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="A1"):
        fa.flash_attention(q, q, q)
    from bigdl_tpu_torch import nn, optim

    model = nn.TransformerLM(64, 32, 2, 1, max_len=8, device=cuda)
    step = optim.make_train_step(model, nn.CrossEntropyCriterion(),
                                 optim.SGD(), compute_dtype=torch.float16)
    x = torch.zeros((1, 8), dtype=torch.long, device=cuda)
    with pytest.raises(TypeError, match="A1"):
        step({"neval": 0}, x, x)


def test_plain_attention_gradient_by_finite_differences():
    """The gradient K1-bwd is held to (autograd of the plain version),
    checked by finite differences in fp64, causal and full, ragged T."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 11, 2, 16), generator=gen,
                           dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda a, b, c: fa.flash_attention(a, b, c, causal), (q, k, v))


def test_plain_cross_entropy_gradient_by_finite_differences():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, 37), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    y = torch.tensor([0, 36, -2, 40])
    assert torch.autograd.gradcheck(
        lambda a: ce.fused_softmax_cross_entropy(a, y), (x,))
