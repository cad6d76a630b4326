"""The split-KV design of K2, K3 and K3q (``csrc/flash_attention.cu``
``paged_decode_kernel``), checked on the CPU.

The kernel reads each (b, h) row's visible positions with the S blocks
of one thread-block cluster: the block of rank r takes the row's tiles
of ``DECODE_TILE`` positions r, r + S, r + 2S, ...; each of its warps
keeps an online softmax over its keys of every tile, the warps'
``(m, l, acc)`` merge into the block's, and rank 0 merges the blocks' in
rank order.
For int8 pools the K scale multiplies the finished dot product and the
V scale is folded into p.  A plain-PyTorch emulation of that arithmetic
(``emulated_paged_decode``) is held within 1e-5 of the JAX package's
gather path, ``MultiHeadAttention._apply_paged``'s else-branch
(``nn/attention.py:420-426``: gather the tables, ``_paged_dequant`` for
int8, masked ``dot_product_attention``), as
``test_torch_flash_attention.py`` and ``test_torch_paged_int8.py`` hold
the plain versions (the Pallas paged kernel does not trace on the
installed JAX).  Inputs come from a numpy seed: frontiers at 0, at every
tile and page edge and at the last addressable position; rows so short
that most splits are empty; table entries past the frontier naming a
trash block of large values.

K2 (``PAGED=false``) reads a contiguous ``(B, T, H, D)`` cache with the
same tiles, warps and merge; its emulation (``emulated_decode``) is held
within 1e-5 of the JAX package's Pallas kernel,
``flash_decode_attention(..., interpret=True)``, for S 1-8 and caches
of 1 to 1024 positions, with frontiers at -1, at 0, on every tile edge,
at T - 1 and past the cache (where the kernel clamps to T).

The wrapper's split choice (``ops.flash_attention.decode_splits``) is
pinned at the engines' shapes for 132 SMs (the H100 SXM) and 114 (the
H100 PCIe), and the SM count is read from the card once per device.
The kernel itself is tested on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import collections
import functools
import math
import pathlib
import re
import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from bigdl_tpu.nn.attention import MultiHeadAttention as JaxMHA
from bigdl_tpu.nn.attention import dot_product_attention as jax_dpa
from bigdl_tpu.ops.flash_attention import flash_decode_attention as \
    jax_decode
from bigdl_tpu.ops.quantization import quantize_blockwise as jax_quant
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)
H, D = 2, 16
#: the kernel's warps a block: each owns TILE / WARPS keys of a tile
WARPS = 4
TILE = fa.DECODE_TILE
SOURCE = pathlib.Path(fa.__file__).resolve().parent.parent / "csrc" / \
    "flash_attention.cu"


def test_emulation_constants_match_the_kernel():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (kPg\w+) = (\d+);", src))
    assert int(consts["kPgTile"]) == TILE
    assert int(consts["kPgWarps"]) == WARPS
    assert int(consts["kPgMaxSplits"]) == fa.DECODE_MAX_SPLITS


@pytest.mark.parametrize("bh,limit,splits", [
    (96, 1024, 4),     # the engine: 8 slots x 12 heads, 1024 positions
    (96, 1024 * 4, 4),
    (108, 1024, 3),    # 9 rows x 12 heads
    (132, 1024, 3),
    (198, 1024, 2),
    (264, 1024, 1),
    (397, 1024, 1),    # three blocks an SM without splitting
    (24, 1024, 8),     # B2 H12: capped at the portable cluster size
    (12, 1024, 8),
    (1, 300, 8),
    (8, 48, 2),        # the card tests' int8 engine: 2 tiles addressable
    (96, 16, 1),       # one tile addressable
    (96, 0, 1),
])
def test_decode_splits(bh, limit, splits):
    """3 * 132 // bh, from 1 to 8, at most the addressable tiles."""
    assert fa.decode_splits(bh, limit) == splits


def split_tiles(n_vis, splits, rank):
    """The tiles rank ``rank`` of ``splits`` reads of a row with ``n_vis``
    visible positions, in order, as the kernel computes them: ``rank``,
    ``rank + splits``, ... below ``ceil(n_vis / TILE)``."""
    n_tiles = (n_vis + TILE - 1) // TILE
    n_mine = (n_tiles - rank + splits - 1) // splits if rank < n_tiles \
        else 0
    return [rank + i * splits for i in range(n_mine)]


@pytest.mark.parametrize("splits", range(1, fa.DECODE_MAX_SPLITS + 1))
def test_split_tiles_partition_the_visible_range(splits):
    """The ranks' tiles cover every visible tile once, their counts differ
    by at most one, and a row of one tile leaves every rank but the first
    empty."""
    for n_vis in (0, 1, 31, 32, 33, 64, 65, 300, 1000, 1024):
        mine = [split_tiles(n_vis, splits, r) for r in range(splits)]
        n_tiles = (n_vis + TILE - 1) // TILE
        assert sorted(t for ts in mine for t in ts) == list(range(n_tiles))
        assert max(map(len, mine)) - min(map(len, mine)) <= 1
        if n_vis and n_vis <= TILE:
            assert all(not ts for ts in mine[1:])


def _merge(m, l, acc):
    """Partials ``(m, l, acc)`` along dim 1 merged in index order, with the
    kernels' -inf-safe rescaling."""
    mg = m.amax(1)
    sm = torch.where(mg == -math.inf, torch.zeros_like(mg), mg)
    lt, at = torch.zeros_like(l[:, 0]), torch.zeros_like(acc[:, 0])
    for i in range(m.shape[1]):
        c = torch.where(m[:, i] == -math.inf, torch.zeros_like(sm),
                        torch.exp(m[:, i] - sm))
        lt = lt + l[:, i] * c
        at = at + acc[:, i] * c[..., None]
    return mg, lt, at


def _emulated_split_kv(q, n_vis, read_tile, splits, quant=False):
    """The split-KV arithmetic shared by ``paged_decode_kernel``'s K2, K3
    and K3q instantiations, in plain PyTorch (fp32): q ``(B, 1, H, D)``,
    ``n_vis (B,)`` visible positions a row, ``read_tile(kpos, vis)`` ->
    the tile's K and V ``(B, TILE, H, D)`` (zeros past the frontier, never
    read) and, for int8, their scales ``(B, TILE, H)``."""
    b, _, h, d = q.shape
    keys = TILE // WARPS
    n_tiles = (n_vis + TILE - 1) // TILE
    qs = q[:, 0].float() * (1.0 / math.sqrt(d))
    parts = []
    for rank in range(splits):
        m = torch.full((b, WARPS, h), -math.inf)
        l = torch.zeros((b, WARPS, h))
        acc = torch.zeros((b, WARPS, h, d))
        # rank r's tiles are r, r + S, ...: in the order it reads them
        for t in range(rank, int(n_tiles.max()), splits):
            live = (t < n_tiles)[:, None, None]
            kpos = t * TILE + torch.arange(TILE)
            vis = kpos[None, :] < n_vis[:, None]              # (B, TILE)
            kt, vt, ks, vs = read_tile(kpos, vis)
            s = torch.einsum("bhd,bthd->bth", qs, kt)
            if quant:   # the K scale on the finished dot product
                s = s * ks
            s = torch.where(vis[..., None], s, -math.inf)
            s = s.reshape(b, WARPS, keys, h)
            new_m = torch.maximum(m, s.amax(2))
            sm = torch.where(new_m == -math.inf, torch.zeros_like(new_m),
                             new_m)
            corr = torch.where(m == -math.inf, torch.zeros_like(m),
                               torch.exp(m - sm))
            p = torch.exp(s - sm[:, :, None])
            pv = p
            if quant:   # the V scale folded into p
                pv = p * vs.reshape(b, WARPS, keys, h)
            l2 = l * corr + p.sum(2)
            acc2 = acc * corr[..., None] + torch.einsum(
                "bwkh,bwkhd->bwhd", pv, vt.reshape(b, WARPS, keys, h, d))
            m = torch.where(live, new_m, m)
            l = torch.where(live, l2, l)
            acc = torch.where(live[..., None], acc2, acc)
        parts.append(_merge(m, l, acc))          # the block's warps
    m, l, acc = _merge(*(torch.stack(x, 1) for x in zip(*parts)))
    return (acc / l.clamp_min(1e-30)[..., None])[:, None]


def emulated_paged_decode(q, k_pool, v_pool, tables, pos, splits,
                          k_scale=None, v_scale=None):
    """``paged_decode_kernel``'s arithmetic (K3, K3q) in plain PyTorch
    (fp32): q ``(B, 1, H, D)``, pools ``(NB, bs, H, D)`` (int8 with
    ``(NB, bs, H, 1)`` scales), tables ``(B, MB)``, pos ``(B,)`` ->
    ``(B, 1, H, D)``."""
    nb, bs = k_pool.shape[:2]
    mb = tables.shape[1]
    quant = k_scale is not None

    def read_tile(kpos, vis):
        page = (kpos // bs).clamp(max=mb - 1)
        bid = tables.long()[:, page].clamp(0, nb - 1)
        off = kpos % bs
        # positions past the frontier are zero-filled, never read
        kt = torch.where(vis[..., None, None], k_pool[bid, off].float(), 0.0)
        vt = torch.where(vis[..., None, None], v_pool[bid, off].float(), 0.0)
        if not quant:
            return kt, vt, None, None
        return (kt, vt,
                torch.where(vis[..., None], k_scale[bid, off, :, 0], 0.0),
                torch.where(vis[..., None], v_scale[bid, off, :, 0], 0.0))

    n_vis = (pos.long() + 1).clamp(0, mb * bs)
    return _emulated_split_kv(q, n_vis, read_tile, splits, quant)


def emulated_decode(q, k, v, pos, splits):
    """``paged_decode_kernel<PAGED=false>``'s arithmetic (K2) in plain
    PyTorch (fp32): q ``(B, 1, H, D)`` against a contiguous cache ``k, v
    (B, T, H, D)`` at frontiers ``pos (B,)`` -> ``(B, 1, H, D)``.
    Position kp of row b is ``k[b, kp]``; no tables."""
    t = k.shape[1]

    def read_tile(kpos, vis):
        at = kpos.clamp(max=max(t - 1, 0))
        return (torch.where(vis[..., None, None], k[:, at].float(), 0.0),
                torch.where(vis[..., None, None], v[:, at].float(), 0.0),
                None, None)

    n_vis = (pos.long() + 1).clamp(0, t)
    return _emulated_split_kv(q, n_vis, read_tile, splits)


def _frontiers(bs, limit):
    """0, both sides of every tile and page edge, and limit - 1."""
    edges = {0, limit - 1}
    for step in (TILE, bs):
        for e in range(step, limit, step):
            edges |= {e - 1, e}
    return np.array(sorted(e for e in edges if e < limit), np.int32)


@functools.lru_cache(maxsize=None)
def _case(bs, quant, D=D):
    """One numpy-seeded batch for block size ``bs`` and head_dim ``D``:
    rows at every frontier of ``_frontiers``, tables into a shared pool
    whose entries past each row's frontier name the trash block, and the
    JAX gather path's output on it."""
    rng = np.random.default_rng(bs + 1000 * quant + D)
    mb = -(-300 // bs) if bs < 128 else 3
    limit = mb * bs
    pos = _frontiers(bs, limit)
    b = len(pos)
    nb = 2 * mb + 1
    trash = nb - 1
    tables = rng.integers(0, nb - 1, (b, mb)).astype(np.int32)
    used = pos // bs + 1
    tables = np.where(np.arange(mb)[None] < used[:, None], tables, trash)
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    ctx = mb * bs
    jt = jnp.asarray(tables)

    def gather(x, width):
        return jnp.take(jnp.asarray(x), jt, axis=0).reshape(b, ctx, H, width)

    if quant:
        pools = []
        for _ in range(2):
            x = rng.standard_normal((nb, bs, H, D)).astype(np.float32)
            q8, sc = jax_quant(jnp.asarray(x.reshape(-1)), D,
                               scale_dtype=jnp.float32)
            pools += [np.array(q8).reshape(x.shape),
                      np.array(sc).reshape(nb, bs, H, 1)]
        k8, ks, v8, vs = pools
        k8[trash], v8[trash], ks[trash], vs[trash] = 127, -127, 1e4, 1e4
        mha = JaxMHA(H * D, H)
        ck = mha._paged_dequant(gather(k8, D), gather(ks, 1), jnp.float32)
        cv = mha._paged_dequant(gather(v8, D), gather(vs, 1), jnp.float32)
        pools = (k8, v8, ks, vs)
    else:
        kp = rng.standard_normal((nb, bs, H, D)).astype(np.float32)
        vp = rng.standard_normal((nb, bs, H, D)).astype(np.float32)
        kp[trash], vp[trash] = 1e4, -1e4
        ck, cv = gather(kp, D), gather(vp, D)
        pools = (kp, vp)
    mask = (jnp.arange(ctx)[None, :] <= jnp.asarray(pos)[:, None])[
        :, None, None, :]
    want = np.asarray(jax_dpa(jnp.asarray(q), ck, cv, mask=mask))
    return q, pools, tables, pos, want


@pytest.mark.parametrize("splits", range(1, fa.DECODE_MAX_SPLITS + 1))
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bs,d", [(1, D), (5, D), (16, D), (128, D),
                                  (16, 96)])
def test_split_and_merge_match_the_jax_gather_path(bs, d, quant, splits):
    q, pools, tables, pos, want = _case(bs, quant, d)
    t = torch.from_numpy
    if quant:
        k8, v8, ks, vs = (t(x) for x in pools)
        got = emulated_paged_decode(t(q), k8, v8, t(tables), t(pos), splits,
                                    ks, vs)
        plain = fa.flash_paged_decode_attention(t(q), k8, v8, t(tables),
                                                t(pos), k_scale=ks,
                                                v_scale=vs)
    else:
        kp, vp = (t(x) for x in pools)
        got = emulated_paged_decode(t(q), kp, vp, t(tables), t(pos), splits)
        plain = fa.flash_paged_decode_attention(t(q), kp, vp, t(tables),
                                                t(pos))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    # some rows leave splits empty (pos 0 reads one tile) wherever S > 1
    n_vis = np.minimum(pos + 1, tables.shape[1] * bs)
    assert splits == 1 or any(not split_tiles(n, splits, splits - 1)
                              for n in n_vis)


# --------------------------------------------------------------------------- #
# K2: the contiguous cache
# --------------------------------------------------------------------------- #

#: K2's cache lengths: one position, both sides of a tile edge, a ragged
#: and a whole multiple of the tile (the engine's 1024)
DECODE_T = (1, 31, 32, 33, 1000, 1024)


def _decode_frontiers(t):
    """-1 (nothing visible), 0, both sides of every tile edge, T - 1, and
    past the cache (T, T + 5)."""
    edges = {-1, 0, t - 1, t, t + 5}
    for e in range(TILE, t, TILE):
        edges |= {e - 1, e}
    return np.array(sorted(edges), np.int32)


def _jax_block_k(t):
    """The largest key block up to the TPU kernel's 128 that divides T
    (the Pallas kernel needs ``T % block_k == 0``)."""
    return next(bk for bk in range(min(128, t), 0, -1) if t % bk == 0)


@functools.lru_cache(maxsize=None)
def _decode_case(t):
    """One numpy-seeded batch for a cache of ``t`` positions, a row at
    every frontier of ``_decode_frontiers``, and the Pallas kernel's
    output on it.  Past the cache the TPU kernel would read its last block
    again; the port clamps the frontier to T - 1 (every position
    visible), so the reference for those rows is the Pallas kernel at
    T - 1."""
    rng = np.random.default_rng(7000 + t)
    pos = _decode_frontiers(t)
    b = len(pos)
    q = rng.standard_normal((b, 1, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, H, D)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.minimum(pos, t - 1)), block_k=_jax_block_k(t),
        interpret=True))
    return q, k, v, pos, want


@pytest.mark.parametrize("splits", range(1, fa.DECODE_MAX_SPLITS + 1))
@pytest.mark.parametrize("t", DECODE_T)
def test_contiguous_split_and_merge_match_jax_flash_decode(t, splits):
    q, k, v, pos, want = _decode_case(t)
    args = [torch.from_numpy(x) for x in (q, k, v, pos)]
    got = emulated_decode(*args, splits)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(fa.flash_decode_attention(*args).numpy(),
                               want, **TOL)
    # rows of one tile or none leave every split but the first empty
    n_vis = np.clip(pos + 1, 0, t)
    assert splits == 1 or any(not split_tiles(n, splits, splits - 1)
                              for n in n_vis)


@pytest.mark.parametrize("b,t,sms,splits", [
    (9, 1024, 132, 3),   # the contiguous engine: 8 slots + the trash row
    (8, 1024, 132, 4),   # the paged engines
    (1, 1024, 132, 8),   # one request
    (9, 1024, 114, 3),   # H100 PCIe
    (8, 1024, 114, 3),   # short of the cliff that 4 would cross there
    (1, 1024, 114, 8),
    (9, 33, 132, 2),     # two tiles addressable
    (9, 32, 132, 1),
    (9, 1, 132, 1),
])
def test_decode_split_count_at_the_engine_shapes(b, t, sms, splits):
    """K2 and K3 take one rule, ``decode_splits(B * H, limit, sms)``, at
    H 12."""
    assert fa.decode_splits(b * 12, t, sms) == splits


def test_sm_count_is_read_from_the_card_once_per_device(monkeypatch):
    calls = []

    def properties(index):
        calls.append(index)
        return types.SimpleNamespace(
            multi_processor_count={0: 132, 1: 114}[index])

    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    fa._sm_count.cache_clear()
    try:
        assert fa.sm_count(torch.device("cuda", 1)) == 114
        assert fa.sm_count("cuda:0") == 132
        assert fa.sm_count("cuda") == 114      # the current device
        assert fa.sm_count("cuda:0") == 132
        assert calls == [1, 0]
    finally:
        fa._sm_count.cache_clear()


def _c_parameters(name):
    """The parameter count of a C entry point in ``csrc/``."""
    for src in _build.SOURCES:
        m = re.search(rf"\bint {name}\(([^)]*)\)", src.read_text())
        if m:
            return len(m.group(1).split(","))
    raise AssertionError(f"no entry point {name}")


def test_ctypes_signatures_match_the_c_entry_points():
    """Every binding declares as many arguments as its C entry point
    takes (K2's now ends in its split count and the stream)."""
    class Library:
        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    ns = _build._declare([Library()])
    for name, fn in vars(ns).items():
        assert len(fn.argtypes) == _c_parameters(name), name


def test_k2_wrapper_passes_the_card_split_count(monkeypatch):
    """On a card the wrapper launches K2 once with
    ``decode_splits(B * H, T, sm_count(device))`` blocks a row: a stand-in
    library records the launch (no card here)."""
    seen = []

    def launch(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(fa, "_on_cpu", lambda *ts: False)
    monkeypatch.setattr(fa, "_stream", lambda: None)
    monkeypatch.setattr(fa, "sm_count", lambda device: 114)
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        bigdl_flash_decode_attention=launch))
    monkeypatch.setitem(fa.LAUNCHES, "flash_decode_attention", 0)
    b, t, h, d = 8, 1024, 12, 16
    q = torch.zeros((b, 1, h, d))
    k = torch.zeros((b, t, h, d))
    fa.flash_decode_attention(q, k, k, torch.zeros(b, dtype=torch.int32))
    assert len(seen) == 1 and fa.LAUNCHES["flash_decode_attention"] == 1
    assert seen[0][9] == t and seen[0][-2] == 3     # 4 on 132 SMs


# --------------------------------------------------------------------------- #
# The row layout of a K row (LPK lanes a key), at every head_dim
# --------------------------------------------------------------------------- #

#: the kernel's pool element sizes: fp32 and bf16 K/V (K2, K3), int8 (K3q)
ELEMENT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def row_layout(elem_bytes, d):
    """``paged_decode_kernel``'s constants for a row of ``d`` elements:
    EPV elements a 16-byte vector, C vectors a row, LPK lanes that score
    one key (the largest divisor of both C and 32 up to 8), VPL vectors a
    lane reads, KPP keys a warp scores at once, DPL output columns a
    lane."""
    epv = 16 // elem_bytes
    c = d // epv
    lpk = max(n for n in (1, 2, 4, 8) if c % n == 0)
    return dict(epv=epv, c=c, lpk=lpk, vpl=c // lpk, kpp=32 // lpk,
                dpl=(d + 31) // 32)


def test_row_layout_formula_is_the_kernel_s():
    src = re.sub(r"\s+", " ", SOURCE.read_text())
    assert "LPK = C % 8 == 0 ? 8 : C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;" \
        in src
    assert "constexpr int DPL = (D + 31) / 32;" in src
    assert int(re.search(r"kPgKeys = kPgTile / kPgWarps", src) is not None)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(ELEMENT_BYTES))
def test_row_layout_covers_every_row_key_and_column(dtype, d):
    """Every vector of a K row is read by exactly one lane of its key's
    group, every key of a warp's 8 by exactly LPK lanes, and every output
    column by exactly one lane; D 96 gives LPK 8, 4 and 2 for fp32, bf16
    and int8, where ``C < 8 ? C : 8`` broke bf16 (C 12) and idled lanes
    on int8 (C 6)."""
    lay = row_layout(ELEMENT_BYTES[dtype], d)
    assert d % lay["epv"] == 0 and lay["c"] % lay["lpk"] == 0
    vectors = sorted(sub + lay["lpk"] * u for sub in range(lay["lpk"])
                     for u in range(lay["vpl"]))
    assert vectors == list(range(lay["c"]))
    keys = TILE // WARPS
    scored = collections.Counter(
        j0 + lane // lay["lpk"] for j0 in range(0, keys, lay["kpp"])
        for lane in range(32) if j0 + lane // lay["lpk"] < keys)
    assert scored == {j: lay["lpk"] for j in range(keys)}
    cols = sorted(lane * lay["dpl"] + jj for lane in range(32)
                  if lane * lay["dpl"] < d for jj in range(lay["dpl"]))
    assert cols == list(range(d))
    if d == 96:
        assert lay["lpk"] == {"fp32": 8, "bf16": 4, "int8": 2}[dtype]


@pytest.mark.parametrize("dtype", list(ELEMENT_BYTES))
def test_lane_partial_sums_give_the_dot_product_at_d96(dtype):
    """A key's score as the kernel sums it at D 96: each of the LPK lanes
    keeps four partial sums over its vectors (element e into sum e % 4),
    adds them pairwise, and xor shuffles finish the group's sum; held
    within 1e-5 of the plain dot product for 8 keys."""
    d = 96
    lay = row_layout(ELEMENT_BYTES[dtype], d)
    rng = np.random.default_rng(96)
    q = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((8, d)).astype(np.float32))
    for j in range(8):
        lanes = []
        for sub in range(lay["lpk"]):
            d4 = [torch.zeros(()) for _ in range(4)]
            for u in range(lay["vpl"]):
                base = (sub + lay["lpk"] * u) * lay["epv"]
                for e in range(lay["epv"]):
                    d4[e & 3] = d4[e & 3] + q[base + e] * k[j, base + e]
            lanes.append((d4[0] + d4[1]) + (d4[2] + d4[3]))
        off = lay["lpk"] // 2
        while off:
            lanes = [lanes[i] + lanes[i ^ off] for i in range(len(lanes))]
            off //= 2
        assert all(torch.equal(x, lanes[0]) for x in lanes)
        np.testing.assert_allclose(float(lanes[0]), float(q @ k[j]),
                                   rtol=1e-5, atol=1e-5)
