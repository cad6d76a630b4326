"""Remat, scanned layers and attention dropout of the port
(``bigdl_tpu_torch/nn/containers.py`` ``remat`` / ``Remat`` /
``ScanLayers``, ``TransformerLM(scan_layers=, remat_policy=)``,
``nn/dropout.py``) against the JAX package's, on the CPU.

- The policy names, and the refusals of a factory name and an unknown
  name, equal JAX's (message included).
- A tiny TransformerLM, scanned and unrolled, under every policy name and
  ``None``, on JAX's weights: loss and every gradient within 1e-5 of
  ``jax.value_and_grad`` of the JAX model in training mode; in the port,
  remat against no remat bitwise (the recompute runs the same ops).
- The bytes a forward keeps for backward (tensors still alive after it,
  parameters and output aside) order as everything > dots > dots without
  batch dims > nothing, and ``nothing`` keeps exactly N*T*d floats a
  block (one more layer, one more input).
- Scanned init equals the unrolled init stacked; the freezing quirk (the
  stacked tree follows layer 0: freezing layer 3 alone freezes nothing)
  against JAX's ``frozen_param_mask``.
- ``optimize()`` on a scanned model with a composite of ``Fused(Adam)``
  on ``"blocks"`` and Adam elsewhere, against JAX's ``LocalOptimizer``
  (1e-5); a JAX scanned checkpoint resumed in the port and a port one in
  JAX (1e-5); the weight bridge across the layouts.
- Serving a scanned model: ``init_cache`` / ``init_paged_cache`` layouts
  equal JAX's, greedy streams equal JAX's engine (paged fp32 and int8,
  contiguous); the scanned int8 twin against JAX's ``quantize_params``
  (payloads exact, scales within 1 ulp) and its logits (1e-5).
- Dropout: the keep rate within 5 sigma of the binomial, identity in
  eval, equal gradients with and without remat, a new mask each step,
  the same mask from the same key.
- The recipe's ``--scanLayers`` / ``--rematPolicy`` and the auto rule.
"""

import gc
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from bigdl_tpu.nn import containers as jcont
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.nn.criterion import CrossEntropyCriterion as JaxCE
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
from bigdl_tpu_torch.models import run as trun
from bigdl_tpu_torch.models import synthetic_corpus
from bigdl_tpu_torch.models import transformer as tmodels
from bigdl_tpu_torch.nn import containers as tcont
from bigdl_tpu_torch.nn import dropout as tdrop
from bigdl_tpu_torch.nn.module import frozen_param_mask
from bigdl_tpu_torch.optim import optim_method as tom
from bigdl_tpu_torch.utils.random_generator import RNG

V, D, H, L, T, B = 64, 32, 2, 3, 8, 2
TOL = dict(rtol=1e-5, atol=1e-5)
POLICIES = [None, *jcont.checkpoint_policy_names()]
LAYOUTS = {"unrolled": False, "scanned": True}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two CPU threads a test (xdist workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_lm(scan, policy=None, key=1, vocab=V, max_len=T, layers=L):
    jm = JaxLM(vocab, D, H, layers, max_len=max_len, scan_layers=scan,
               remat_policy=policy)
    jm.build(jax.ShapeDtypeStruct((B, max_len), jnp.int32),
             rng=jax.random.PRNGKey(key))
    return jm


def _port_lm(jm, scan, policy=None, **kw):
    tm = nn.TransformerLM(jm.vocab_size, D, H, len(jm.blocks),
                          max_len=jm.max_len, device="cpu", seed=9,
                          scan_layers=scan, remat_policy=policy, **kw)
    return load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (B, T)).astype(np.int32),
            rng.integers(0, V, (B, T)).astype(np.int32))


def _port_loss_and_grads(tm, x, y):
    tm.train()
    tm.zero_grad(set_to_none=True)
    out = tm(torch.from_numpy(x))
    loss = nn.CrossEntropyCriterion().apply(out.reshape(-1, V),
                                            torch.from_numpy(y).reshape(-1))
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in tm.named_parameters()}


# --------------------------------------------------------------------------- #
# Policies
# --------------------------------------------------------------------------- #

def _message(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e), str(e)
    return None


def test_policy_names_and_refusals_equal_jax():
    assert tcont.checkpoint_policy_names() == jcont.checkpoint_policy_names()
    for name in [*sorted(jcont._POLICY_FACTORIES), "bogus", 3]:
        want = _message(lambda: jcont.resolve_checkpoint_policy(name))
        assert want is not None
        assert _message(lambda: tcont.resolve_checkpoint_policy(name)) == \
            want, name
    for name in POLICIES:
        assert tcont.resolve_checkpoint_policy(name) == name
    # the constructors refuse eagerly, as JAX's do
    for ctor in (lambda p: nn.TransformerLM(V, D, H, 1, max_len=T,
                                            device="cpu", remat_policy=p),
                 lambda p: nn.Remat(nn.Linear(2, 2), p),
                 lambda p: nn.ScanLayers([nn.Linear(2, 2)], p)):
        with pytest.raises(ValueError, match="policy FACTORY"):
            ctor("save_only_these_names")
        with pytest.raises(ValueError, match="unknown checkpoint policy"):
            ctor("nothing_savable")


# --------------------------------------------------------------------------- #
# TransformerLM against JAX, every policy, both layouts
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("policy", POLICIES, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_transformer_lm_loss_and_gradients_match_jax(layout, policy):
    scan = LAYOUTS[layout]
    jm = _jax_lm(scan, policy)
    x, y = _batch()

    def loss(p):
        out, _ = jm.apply(p, (), jnp.asarray(x), training=True,
                          rng=jax.random.PRNGKey(5))
        return JaxCE().apply(out.reshape(-1, V), jnp.asarray(y).reshape(-1))

    jl, jg = jax.value_and_grad(loss)(jm.parameters()[0])
    tm = _port_lm(jm, scan, policy)
    tl, grads = _port_loss_and_grads(tm, x, y)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = _flat(jax.tree.map(np.asarray, jg))
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], err_msg=k, **TOL)
    # remat against no remat in the port: bitwise (same ops, recomputed)
    plain = _port_lm(jm, False, None)
    pl, pgrads = _port_loss_and_grads(plain, x, y)
    assert torch.equal(tl, pl)
    for k, g in grads.items():
        if scan and k.startswith("blocks."):
            want_g = torch.stack([pgrads[f"block{i}.{k[7:]}"]
                                  for i in range(L)])
        else:
            want_g = pgrads[k]
        assert torch.equal(g, want_g), k


class _Alive(TorchDispatchMode):
    """Weak references to every tensor an op returns inside the block."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs.extend(weakref.ref(t) for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
        return out


def _kept_bytes(scan, policy, layers):
    """Bytes of the tensors a training forward leaves alive (what
    backward keeps), the parameters and the output aside."""
    tm = nn.TransformerLM(V, D, H, layers, max_len=2 * T, device="cpu",
                          scan_layers=scan, remat_policy=policy,
                          use_flash="never").train()
    x = torch.from_numpy(_batch()[0]).repeat(1, 2)
    alive = _Alive()
    with alive:
        out = tm(x)
    gc.collect()
    skip = {p.untyped_storage().data_ptr() for p in tm.parameters()}
    skip.add(out.untyped_storage().data_ptr())
    kept = {}
    for ref in alive.refs:
        t = ref()
        if t is not None and t.untyped_storage().data_ptr() not in skip:
            kept[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
    return sum(kept.values())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bytes_kept_for_backward_order_by_policy(layout):
    scan = LAYOUTS[layout]
    kept = {p: _kept_bytes(scan, p, L) for p in (
        "everything_saveable", "dots_saveable",
        "dots_with_no_batch_dims_saveable", "nothing_saveable")}
    assert kept["everything_saveable"] > kept["dots_saveable"] > \
        kept["dots_with_no_batch_dims_saveable"] > kept["nothing_saveable"]
    # nothing_saveable: a block keeps its input alone, N x T x d floats
    per_block = _kept_bytes(scan, "nothing_saveable", L) - \
        _kept_bytes(scan, "nothing_saveable", L - 1)
    assert per_block == B * 2 * T * D * 4
    # None: the scanned layout keeps each layer's input; the unrolled one
    # does not remat at all, as in JAX
    assert _kept_bytes(scan, None, L) == (
        kept["nothing_saveable"] if scan else kept["everything_saveable"])


def test_remat_container_keys_its_child_and_bypasses_eval():
    lin = nn.Linear(4, 3, generator=torch.Generator().manual_seed(0))
    r = nn.Remat(lin, "dots_saveable")
    assert [k for k, _ in r.named_parameters()] == ["0.weight", "0.bias"]
    x = torch.randn(2, 4, requires_grad=True)
    alive = _Alive()
    r.eval()
    with alive:
        y = r(x)
    assert torch.equal(y, lin(x))
    r.train()
    g1, = torch.autograd.grad(r(x).square().sum(), x)
    g2, = torch.autograd.grad(lin(x).square().sum(), x)
    assert torch.equal(g1, g2)


# --------------------------------------------------------------------------- #
# Layout: init, freezing
# --------------------------------------------------------------------------- #

def test_scanned_init_is_the_unrolled_init_stacked():
    a = nn.TransformerLM(V, D, H, L, max_len=T, device="cpu", seed=4)
    b = nn.TransformerLM(V, D, H, L, max_len=T, device="cpu", seed=4,
                         scan_layers=True)
    want = nn.attention.stack_block_params(a.parameters_tree())
    got = b.parameters_tree()
    assert _flat(got).keys() == _flat(want).keys()
    for k, v in _flat(want).items():
        assert np.array_equal(_flat(got)[k], v), k
    assert len(b.blocks) == L and b.scan is b.blocks
    assert all(p.shape[0] == L for p in b.blocks.parameters())
    assert b.blocks[2].fc1.weight is None     # layers past 0 hold nothing


@pytest.mark.parametrize("target", ["layer3", "layer0", "layer0.attn",
                                    "scan", "layer0+unfreeze.ln1"])
def test_freezing_routes_the_stack_through_layer_zero(target):
    jm = JaxLM(V, D, H, 4, max_len=T, scan_layers=True)
    jm.build(jax.ShapeDtypeStruct((B, T), jnp.int32),
             rng=jax.random.PRNGKey(0))
    tm = nn.TransformerLM(V, D, H, 4, max_len=T, device="cpu",
                          scan_layers=True)

    def apply(model, scan, blocks):
        if target == "layer3":
            model.freeze([blocks[3].name])
        elif target == "layer0":
            model.freeze([blocks[0].name])
        elif target == "layer0.attn":
            model.freeze([blocks[0].attn.name])
        elif target == "scan":
            scan.freeze()
        else:
            model.freeze([blocks[0].name])
            model.unfreeze([blocks[0].ln1.name])

    apply(jm, jm.scan, jm.blocks)
    apply(tm, tm.scan, tm.blocks)
    from bigdl_tpu.nn.module import frozen_param_mask as jmask

    want = _flat(jmask(jm, jm.parameters()[0]))
    got = frozen_param_mask(tm)
    assert got == {k: bool(v) for k, v in want.items()}
    if target == "layer3":
        assert all(got.values())          # the quirk: nothing freezes


# --------------------------------------------------------------------------- #
# Training, checkpoints, the bridge
# --------------------------------------------------------------------------- #

SEQ = 16


def _corpus():
    return synthetic_corpus(24, SEQ, V, seed=3)


def _composite(o):
    """Fused(Adam) on the stacked blocks, Adam elsewhere."""
    return o.CompositeOptimMethod(
        [("blocks", ("blocks",), o.Fused(o.Adam(learning_rate=1e-2,
                                                 epsilon=1e-3))),
         *((k, (k,), o.Adam(learning_rate=1e-2, epsilon=1e-3))
           for k in ("wte", "wpe", "head", "ln_f"))])


def _jax_opt(jm, method, end, ckpt=None, every=None, resume=False):
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
    from bigdl_tpu.dataset import array_dataset as jarray_dataset
    from bigdl_tpu.nn import criterion as jcrit

    x, y = _corpus()
    opt = joptim.LocalOptimizer(
        jm, jarray_dataset(x, y) >> JaxToMiniBatch(4),
        jcrit.TimeDistributedCriterion(jcrit.CrossEntropyCriterion()),
        method)
    opt.set_end_when(joptim.Trigger.max_iteration(end))
    if ckpt:
        opt.set_checkpoint(str(ckpt), joptim.Trigger.several_iteration(every))
    if resume:
        opt.resume_from_checkpoint()
    opt.optimize()
    return opt


def _port_opt(tm, method, end, ckpt=None, every=None, resume=False):
    RNG.set_seed(7)
    x, y = _corpus()
    opt = optim.Optimizer(
        tm, array_dataset(x, y) >> SampleToMiniBatch(4),
        nn.TimeDistributedCriterion(nn.CrossEntropyCriterion()), method,
        device="cpu")
    opt.set_end_when(optim.Trigger.max_iteration(end))
    if ckpt:
        opt.set_checkpoint(str(ckpt), optim.Trigger.several_iteration(every))
    if resume:
        opt.resume_from_checkpoint()
    opt.optimize()
    return opt


def _close_to_jax(tm, jm, tol=1e-5):
    want = _flat(jax.tree.map(np.asarray, jm.parameters()[0]))
    got = _flat(to_jax_params(tm))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=tol, atol=tol, err_msg=k)


def test_optimize_scanned_with_fused_blocks_matches_jax():
    from bigdl_tpu.optim import optim_method as jom

    jm = _jax_lm(True, key=2, max_len=SEQ)
    tm = _port_lm(jm, True)
    _jax_opt(jm, _composite(jom), 5)
    opt = _port_opt(tm, _composite(tom), 5)
    assert opt.driver_state["neval"] == 6
    _close_to_jax(tm, jm)
    # the state of the stacked subtree is one flat vector over it
    state = opt.optim_method.state["blocks"]
    n = sum(p.numel() for p in tm.blocks.parameters())
    assert state["m"].shape == (n,)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_scanned_checkpoints_cross_the_packages(tmp_path, direction):
    """4 steps, a checkpoint at neval 5, 2 more steps in the other
    package: within 1e-5 of the first package's straight 6 steps."""
    from bigdl_tpu.optim import optim_method as jom

    if direction == "jax_to_port":
        straight = _jax_lm(True, key=2, max_len=SEQ)
        _jax_opt(straight, _composite(jom), 6)
        _jax_opt(_jax_lm(True, key=2, max_len=SEQ), _composite(jom), 4,
                 tmp_path, 5)
        tm = nn.TransformerLM(V, D, H, L, max_len=SEQ, device="cpu",
                              scan_layers=True, seed=5)
        opt = _port_opt(tm, _composite(tom), 6, tmp_path, 100, resume=True)
        assert opt.driver_state["neval"] == 7
        _close_to_jax(tm, straight)
    else:
        straight = _port_lm(_jax_lm(True, key=2, max_len=SEQ), True)
        _port_opt(straight, _composite(tom), 6)
        _port_opt(_port_lm(_jax_lm(True, key=2, max_len=SEQ), True),
                  _composite(tom), 4, tmp_path, 5)
        jm = _jax_lm(True, key=8, max_len=SEQ)
        jopt = _jax_opt(jm, _composite(jom), 6, tmp_path, 100, resume=True)
        assert jopt.driver_state["neval"] == 7
        _close_to_jax(straight, jm)


@pytest.mark.parametrize("model_scan", [False, True])
@pytest.mark.parametrize("tree_scan", [False, True])
def test_bridge_crosses_the_layouts(tree_scan, model_scan):
    jm = _jax_lm(tree_scan, key=6)
    tm = _port_lm(jm, model_scan)
    assert ("blocks" in to_jax_params(tm)) == model_scan
    x, _ = _batch(1)
    want, _ = jm.apply(jm.parameters()[0], (), jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scan_state", [False, True])
def test_fused_state_loads_into_the_scanned_order(scan_state):
    """A JAX ``Fused(Adam)`` state over either layout loads into a
    scanned port model in its own (stacked) order, given the tree."""
    from bigdl_tpu.optim import optim_method as jom
    from bigdl_tpu_torch.interop import load_jax_opt_state

    jm = _jax_lm(scan_state, key=3)
    jp = jm.parameters()[0]
    jmeth = jom.Fused(jom.Adam(learning_rate=0.01))
    js = jmeth.init_state(jp)
    rng = np.random.default_rng(1)
    for _ in range(2):
        g = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), jp)
        jp, js = jax.jit(jmeth.update)(g, js, jp)
    from jax.flatten_util import ravel_pytree

    tm = _port_lm(jm, True)
    tmeth = tom.Fused(tom.Adam(learning_rate=0.01))
    ts = load_jax_opt_state(tmeth, jax.tree.map(np.asarray, js),
                            device="cpu", jax_params=jp, model=tm)
    # each flat moment, laid out over the scanned tree in the port's
    # (ravel_pytree's) order, so it pairs with the port's parameters
    unravel = ravel_pytree(jp)[1]
    for slot in ("m", "v"):
        tree = jax.tree.map(np.asarray, unravel(js[slot]))
        if not scan_state:
            tree = nn.attention.stack_block_params(tree)
        flat = _flat(tree)
        want = np.concatenate([flat[k].ravel()
                               for k in tom.ravel_order(flat)])
        np.testing.assert_array_equal(ts[slot].numpy(), want, err_msg=slot)
    assert int(ts["neval"]) == 2


# --------------------------------------------------------------------------- #
# Serving a scanned model
# --------------------------------------------------------------------------- #

SV, SMAX = 128, 64
PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13], [4] * 9 + [5] * 9]


@pytest.fixture(scope="module")
def served():
    jm = _jax_lm(True, key=3, vocab=SV, max_len=SMAX)
    return jm, _port_lm(jm, True)


def _shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in _flat(jax.tree.map(np.asarray, tree)).items()}


def test_cache_layouts_equal_jax(served):
    jm, tm = served
    assert _shapes(tm.init_cache(3, 16)) == _shapes(jm.init_cache(3, 16))
    assert _shapes(tm.init_paged_cache(5, 4)) == \
        _shapes(jm.init_paged_cache(5, 4))
    got = tm.init_paged_cache(5, 4, dtype=torch.int8)
    assert got["blocks"]["k"].shape == (L, 6, 4, H, D // H)
    assert got["blocks"]["k_scale"].shape == (L, 6, 4, H, 1)
    # a layer's view of the stacked pool is contiguous (what K3 reads)
    assert got["blocks"]["k"][1].is_contiguous()


@pytest.mark.parametrize("engine", ["paged", "contiguous", "paged-int8"])
def test_scanned_greedy_streams_equal_jax(served, engine):
    from bigdl_tpu.serving import ServingEngine as JaxEngine
    from bigdl_tpu_torch.serving import ServingEngine

    jm, tm = served
    kv = "contiguous" if engine == "contiguous" else "paged"
    kw = {"kv_cache_dtype": "int8"} if engine == "paged-int8" else {}
    with JaxEngine(jm, decode_slots=3, decode_max_len=48, kv_cache=kv,
                   kv_block_size=4, **kw) as eng:
        want = [f.result(120) for f in
                [eng.generate(p, max_new_tokens=6) for p in PROMPTS]]
    # a prompt sharing another's first blocks takes the prefix path
    shared = PROMPTS + [PROMPTS[2][:12] + [6, 6]]
    with ServingEngine(tm, decode_slots=3, decode_max_len=48, kv_cache=kv,
                       kv_block_size=4, device="cpu", **kw) as eng:
        got = [f.result(120) for f in
               [eng.generate(p, max_new_tokens=6) for p in shared]]
    assert got[:3] == want
    unrolled = _port_lm(jm, False)
    with ServingEngine(unrolled, decode_slots=3, decode_max_len=48,
                       kv_cache=kv, kv_block_size=4, device="cpu",
                       **kw) as eng:
        assert [f.result(120) for f in
                [eng.generate(p, max_new_tokens=6) for p in shared]] == got


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_copy_on_write_copies_the_block_of_every_layer(served, dtype):
    from bigdl_tpu_torch.serving.generation import paged_generate_steps

    _, tm = served
    copy_block = paged_generate_steps(tm)[2]
    pool = tm.init_paged_cache(6, 4, dtype)
    gen = torch.Generator().manual_seed(0)
    for t in pool["blocks"].values():
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen))
    before = {k: t.clone() for k, t in pool["blocks"].items()}
    copy_block(pool, 2, 5)
    for k, t in pool["blocks"].items():
        want = before[k].clone()
        want[:, 5] = before[k][:, 2]
        assert torch.equal(t, want), k


def test_scanned_int8_twin_matches_jax(served):
    from bigdl_tpu.nn import quantized as jq
    from bigdl_tpu_torch.nn import quantized as tq

    jm, tm = served
    want = _flat(jax.tree.map(np.asarray, jq.quantize_params(jm)))
    got = _flat(tq.quantize_params(tm))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        if w.dtype == np.int8:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_array_max_ulp(got[k], w, maxulp=1)
    assert got["blocks.attn.qkv_scale"].shape == (L, 3 * D)
    jq_model, jq_params = jq.quantize_model(jm)
    qm, _ = tq.quantize_model(tm)
    x = np.random.default_rng(4).integers(0, SV, (3, 13)).astype(np.int32)
    jl, _ = jq_model.apply(jq_params, (), jnp.asarray(x))
    with torch.no_grad():
        tl = qm(torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    qu, _ = tq.quantize_model(_port_lm(jm, False))
    with torch.no_grad():
        assert torch.equal(qu(torch.from_numpy(x)), tl)


# --------------------------------------------------------------------------- #
# Attention dropout
# --------------------------------------------------------------------------- #

def test_dropout_keep_rate_is_binomial_and_keyed():
    key = torch.tensor(12345)
    n, keep = 200_000, 0.7
    m = tdrop.keep_mask(key, 3, (n,), keep, "cpu")
    sigma = (n * keep * (1 - keep)) ** 0.5
    assert abs(int(m.sum()) - n * keep) < 5 * sigma
    assert torch.equal(m, tdrop.keep_mask(key, 3, (n,), keep, "cpu"))
    for other in (tdrop.keep_mask(key + 1, 3, (n,), keep, "cpu"),
                  tdrop.keep_mask(key, 4, (n,), keep, "cpu")):
        agree = float((other == m).float().mean())
        # independent masks agree on keep^2 + (1-keep)^2 of the elements
        assert abs(agree - (keep ** 2 + (1 - keep) ** 2)) < 0.01


def _dropout_blocks(scan, policy):
    gen = torch.Generator().manual_seed(0)
    blocks = [nn.TransformerBlock(D, H, generator=gen, dropout=0.25)
              for _ in range(L)]
    if scan:
        return nn.ScanLayers(blocks, policy)
    for i, b in enumerate(blocks):
        b.attn.dropout_salt = i
    return nn.Sequential(*blocks)


@pytest.mark.parametrize("policy", [None, "dots_saveable"], ids=str)
def test_dropout_remat_keeps_the_gradients(policy):
    x = torch.randn(B, T, D, generator=torch.Generator().manual_seed(1))
    plain, scanned = _dropout_blocks(False, None), _dropout_blocks(True,
                                                                   policy)
    grads = []
    for m in (plain, scanned):
        m.train()
        with tdrop.step_key(torch.tensor(77)):
            y = m(x)
            y.square().sum().backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for k, g in grads[1].items():
        want = torch.stack([grads[0][f"{i}.{k}"] for i in range(L)])
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)
    # the same key through the remat'ed stack twice: bitwise
    with tdrop.step_key(torch.tensor(77)):
        y2 = scanned(x)
    assert torch.equal(y2, y)
    # eval is the identity; no key, no mask
    scanned.eval()
    with torch.no_grad(), tdrop.step_key(torch.tensor(77)):
        ye = scanned(x)
    scanned.train()
    with torch.no_grad():
        assert torch.equal(scanned(x), ye)


def test_train_step_draws_a_new_mask_each_step():
    """The step's key advances on the device after each step, and the
    compiled step's warm-up (saved and restored) leaves it alone."""
    from bigdl_tpu_torch.optim.train_step import make_train_step

    RNG.set_seed(3)
    model = _dropout_blocks(True, None)
    method = tom.SGD(learning_rate=0.0)
    state = method.init_state(dict(model.named_parameters()))
    step = make_train_step(model, nn.MSECriterion(), method)
    key = step.dropout_key
    assert key is not None and key.dtype == torch.int64
    x = torch.randn(B, T, D, generator=torch.Generator().manual_seed(2))
    losses = []
    for _ in range(3):
        k0 = int(key)
        losses.append(float(step(state, x, torch.zeros_like(x))[1]))
        assert int(key) == k0 + 1
    assert len(set(losses)) == 3          # new masks, same weights
    plain = make_train_step(nn.TransformerLM(V, D, H, 1, max_len=T,
                                             device="cpu"),
                            nn.MSECriterion(), tom.SGD())
    assert plain.dropout_key is None


# --------------------------------------------------------------------------- #
# The recipe and the auto rule
# --------------------------------------------------------------------------- #

def test_auto_rule_scans_the_deep_configs(monkeypatch):
    seen = {}

    def fake(*a, **kw):
        seen[a[3]] = kw["scan_layers"], kw["remat_policy"]

    monkeypatch.setattr(tmodels, "TransformerLM", fake)
    for size in tmodels.CONFIGS:
        tmodels.transformer_lm(size, device="cpu")
    assert seen == {4: (False, None), 12: (False, None),
                    24: (True, None), 36: (True, None)}
    tmodels.transformer_lm("large", device="cpu", scan_layers=False,
                           remat_policy="dots_saveable")
    assert seen[36] == (False, "dots_saveable")


@pytest.mark.parametrize("flag,scanned", [("auto", False), ("on", True),
                                          ("off", False)])
def test_recipe_scan_and_remat_flags(flag, scanned):
    opt = trun.main(["transformer-train", "--device", "cpu", "--size",
                     "tiny", "--vocab", "64", "--seq-len", "8", "-b", "4",
                     "--synthN", "8", "--maxIteration", "2",
                     "--scanLayers", flag, "--rematPolicy", "dots_saveable"])
    assert (opt.model.scan is not None) == scanned
    assert opt.model.remat_policy == "dots_saveable"
    assert opt.driver_state["neval"] == 3


def test_recipe_refuses_an_unknown_policy_before_building_data(monkeypatch):
    def no_data(*a, **kw):
        raise AssertionError("data built before the policy was checked")

    monkeypatch.setattr(tmodels, "synthetic_corpus", no_data)
    with pytest.raises(ValueError, match="unknown checkpoint policy"):
        trun.main(["transformer-train", "--device", "cpu",
                   "--rematPolicy", "dots_savable"])
