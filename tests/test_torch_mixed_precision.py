"""The rest of the port's train step against the JAX package's, on the
CPU: bf16 mixed precision (``compute_dtype``) in the train step, the
eval step, ``LocalOptimizer`` and ``ServingEngine.predict``; the
regularizers, freezing and ``grad_transform``; module names.

Small model: vocab 512, hidden 64, 4 heads, 2 layers, T 16 (13 for one
step).  Inputs come from numpy seeds, weights from a JAX seed through
the weight bridge; the JAX side runs jitted on the CPU.

bf16 tolerances.  The two packages round bf16 at different places:
JAX's CPU attention (``nn/attention.py:27``) rounds the scores and the
softmax weights to bf16 and its GEMMs round their outputs, while the
port's plain attention computes in fp32 and rounds only its output.  Both
agree only to bf16 precision (8 mantissa bits, about 4e-3 a rounding),
so they are held to ``BF16_LOSS_RTOL`` on a loss and
``BF16_REL_L2`` on a gradient, an update or logits (relative L2 over
the whole tensor).  fp32 checks (regularizers, freezing,
``grad_transform``) keep 1e-5 on losses and parameters and 1e-4 on
gradients through the model.
"""

import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import SampleToMiniBatch as JaxToMiniBatch
from bigdl_tpu.dataset import array_dataset as jax_array_dataset
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.nn.attention import TransformerLM as JaxLM
from bigdl_tpu.nn.module import frozen_param_mask as jax_frozen_mask
from bigdl_tpu.optim import regularizer as jreg
from bigdl_tpu.optim.train_step import _cast_params as jax_cast_params
from bigdl_tpu.optim.train_step import _cast_tree as jax_cast_tree
from bigdl_tpu.optim.train_step import make_eval_step as jax_eval_step
from bigdl_tpu.optim.train_step import make_train_step as jax_train_step
from bigdl_tpu.serving import ServingEngine as JaxEngine
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import SampleToMiniBatch, array_dataset
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.models import synthetic_corpus
from bigdl_tpu_torch.serving import ServingEngine

VOCAB, HIDDEN, HEADS, LAYERS, SEQ = 512, 64, 4, 2, 16
#: bf16 against JAX's bf16 (module docstring): a loss, relative (worst
#: measured 6.3e-5)
BF16_LOSS_RTOL = 1e-3
#: bf16 against JAX's bf16: relative L2 of a gradient, update or logits
#: (worst measured: 0.018 on a LayerNorm weight's gradient, 0.016 on the
#: int8 twin's predict logits; JAX's own bf16 gradients lie 0.019 from
#: its fp32 ones)
BF16_REL_L2 = 3e-2


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(seed=0):
    jm = JaxLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=SEQ)
    jm.build(jax.ShapeDtypeStruct((2, SEQ), jnp.int32),
             rng=jax.random.PRNGKey(seed))
    tm = nn.TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=SEQ,
                          device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.parameters()[0]))
    return jm, tm


def _crits():
    return (jcrit.TimeDistributedCriterion(
                jcrit.FusedSoftmaxCrossEntropyCriterion()),
            nn.TimeDistributedCriterion(
                nn.FusedSoftmaxCrossEntropyCriterion()))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _params_np(tm):
    return {k: p.detach().numpy().copy() for k, p in tm.named_parameters()}


def _jax_value_and_grad(jm, jc, x, y, compute_dtype=None, reg=False):
    """The JAX step's loss and gradients (``train_step.py:88-106``):
    the loss is the bare criterion, the gradient that of criterion +
    regularization."""
    def loss_fn(p):
        out, _ = jm.apply(jax_cast_params(p, compute_dtype), (),
                          jax_cast_tree(jnp.asarray(x), compute_dtype),
                          training=True, rng=jax.random.PRNGKey(0))
        data = jc.apply(jax_cast_tree(out, jnp.float32), jnp.asarray(y))
        total = data + jreg.regularization_loss(jm, p) if reg else data
        return total, data

    (_, loss), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jm.parameters()[0])
    return float(loss), _flat(grads)


# --------------------------------------------------------------------------- #
# bf16 mixed precision
# --------------------------------------------------------------------------- #

def test_bf16_train_step_matches_jax():
    """One bf16 step: the loss, every gradient (fp32 on the fp32 masters,
    nonzero) and the SGD update against JAX's bf16 step on the same
    weights and batch (ragged T 13)."""
    jm, tm = _pair()
    jc, tc = _crits()
    x, y = synthetic_corpus(3, 13, VOCAB, seed=4)
    want_loss, want_grads = _jax_value_and_grad(jm, jc, x, y, jnp.bfloat16)
    before = _params_np(tm)
    sgd = optim.SGD(learning_rate=0.5)
    step = optim.make_train_step(tm, tc, sgd, compute_dtype=torch.bfloat16)
    _, loss = step(sgd.init_state(dict(tm.named_parameters())),
                   torch.from_numpy(x), torch.from_numpy(y))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), want_loss, rtol=BF16_LOSS_RTOL)
    for k, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, k
        assert float(p.grad.abs().sum()) > 0, k
        assert _rel_l2(p.grad.numpy(), want_grads[k]) < BF16_REL_L2, k
    jstep = jax.jit(jax_train_step(jm, jc, joptim.SGD(learning_rate=0.5),
                                   compute_dtype=jnp.bfloat16))
    params = jm.parameters()[0]
    new_params, *_ = jstep(params, (), joptim.SGD().init_state(params),
                           jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(0))
    new_params = _flat(new_params)
    for k, p in tm.named_parameters():
        assert _rel_l2(p.detach().numpy() - before[k],
                       new_params[k] - before[k]) < BF16_REL_L2, k


def test_bf16_eval_step_matches_jax():
    jm, tm = _pair()
    x, _ = synthetic_corpus(2, SEQ, VOCAB, seed=9)
    want = jax.jit(jax_eval_step(jm, jnp.bfloat16))(
        jm.parameters()[0], (), jnp.asarray(x))
    got = optim.make_eval_step(tm, torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and not got.requires_grad
    assert not tm.training
    assert _rel_l2(got.numpy(), want) < BF16_REL_L2
    with torch.no_grad():                   # bf16 is not the fp32 forward
        assert not np.array_equal(got.numpy(),
                                  tm(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("quantize", [False, True])
def test_bf16_predict_matches_jax_engine(quantize):
    """``ServingEngine(compute_dtype=bf16).predict`` against the JAX
    engine's, fp32 and int8 twin (JAX runs both on the CPU)."""
    jm, tm = _pair(seed=3)
    x = np.random.default_rng(0).integers(0, VOCAB, SEQ).astype(np.int32)
    with JaxEngine(jm, decode_slots=0, compute_dtype=jnp.bfloat16,
                   quantize=quantize) as eng:
        want = np.asarray(eng.predict(x))
    with ServingEngine(tm, decode_slots=0, compute_dtype=torch.bfloat16,
                       quantize=quantize, device="cpu") as eng:
        got = eng.predict(x)
    assert got.dtype == np.float32 and got.shape == (SEQ, VOCAB)
    assert _rel_l2(got, want) < BF16_REL_L2


def test_generation_streams_unchanged_by_compute_dtype():
    """Generation takes the KV cache dtype only (JAX ``_generation``
    :649-700): the streams with and without ``compute_dtype`` are the
    same, paged and contiguous."""
    _, tm = _pair(seed=3)
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11], [4] * 6]
    streams = {}
    for kv in ("paged", "contiguous"):
        for cd in (None, torch.bfloat16):
            with ServingEngine(tm, decode_slots=3, decode_max_len=SEQ,
                               kv_cache=kv, kv_block_size=4,
                               compute_dtype=cd, device="cpu") as eng:
                streams[(kv, cd)] = [
                    f.result(60) for f in
                    [eng.generate(p, max_new_tokens=6) for p in prompts]]
    first = streams[("paged", None)]
    assert all(s == first for s in streams.values())


def test_bf16_predict_beside_generation_leaves_the_streams_alone():
    """``predict`` in bf16 on the dispatcher thread while the scheduler's
    thread generates: the streams stay the fp32 model's, because predict
    evaluates a cast copy (``compute_copy``) that shares no tensor with
    the model; swapping the model's own parameters for a call would
    leak bf16 weights into the decode steps.  The copy's logits equal
    ``make_eval_step``'s bit for bit."""
    from bigdl_tpu_torch.optim.train_step import compute_copy

    tm = nn.TransformerLM(VOCAB, HIDDEN, HEADS, LAYERS, max_len=64,
                          device="cpu", seed=1)
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11], [4] * 6]
    kw = dict(decode_slots=3, decode_max_len=64, kv_block_size=4,
              device="cpu")
    x = np.arange(SEQ, dtype=np.int32)
    with ServingEngine(tm, **kw) as eng:
        want = [f.result(60) for f in
                [eng.generate(p, max_new_tokens=32) for p in prompts]]
    with ServingEngine(tm, compute_dtype=torch.bfloat16, **kw) as eng:
        stop, errors = threading.Event(), []

        def predict():
            while not stop.is_set():
                try:
                    eng.predict(x, timeout=60)
                except Exception as e:          # noqa: BLE001 -- reported
                    errors.append(e)
                    return

        t = threading.Thread(target=predict)
        t.start()
        try:
            got = [f.result(60) for f in
                   [eng.generate(p, max_new_tokens=32) for p in prompts]]
        finally:
            stop.set()
            t.join(60)
        assert not t.is_alive() and not errors
        logits = eng.predict(x)
    assert got == want
    np.testing.assert_array_equal(
        logits, optim.make_eval_step(tm, torch.bfloat16)(
            torch.from_numpy(x[None]))[0].numpy())
    twin = compute_copy(tm, torch.bfloat16)
    ours = {id(p) for p in tm.parameters()}
    for k, p in twin.named_parameters():
        assert id(p) not in ours and not p.requires_grad, k
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2
                           else torch.float32), k


class _Recorder:
    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.losses.append(float(value))


def test_local_optimizer_bf16_losses_match_jax():
    """``set_compute_dtype(bf16)``: 3 Adam steps, losses against JAX's;
    the parameters and Adam's moments stay fp32."""
    x, y = synthetic_corpus(8, SEQ, VOCAB, seed=5)
    jm, tm = _pair(seed=3)
    jc, tc = _crits()
    losses = {}
    for side, model, crit, pkg, dset, to_batch, dtype in (
            ("jax", jm, jc, joptim, jax_array_dataset, JaxToMiniBatch,
             jnp.bfloat16),
            ("port", tm, tc, optim, array_dataset, SampleToMiniBatch,
             torch.bfloat16)):
        kw = {} if side == "jax" else {"device": "cpu"}
        method = pkg.Adam(learning_rate=3e-3)
        opt = pkg.Optimizer(model=model, dataset=dset(x, y) >> to_batch(4),
                            criterion=crit, optim_method=method, **kw)
        opt.set_end_when(pkg.Trigger.max_iteration(3))
        opt.set_compute_dtype(dtype)
        rec = _Recorder()
        opt.set_train_summary(rec)
        opt.optimize()
        losses[side] = rec.losses
    assert len(losses["port"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=BF16_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(t.dtype == torch.float32 for slot in ("m", "v")
               for t in method.state[slot].values())


def test_tokens_stay_integer_and_vectors_stay_fp32():
    """``_cast_tree`` casts floating inputs only; ``_cast_params`` casts
    rank >= 2 floating leaves only (as ``train_step.py:22-49``)."""
    from bigdl_tpu_torch.optim.train_step import _cast_params, _cast_tree

    ids = torch.arange(6, dtype=torch.int32)
    got = _cast_tree((ids, {"f": torch.ones(2)}), torch.bfloat16)
    assert got[0] is ids and got[1]["f"].dtype == torch.bfloat16
    _, tm = _pair()
    cast = _cast_params(dict(tm.named_parameters()), torch.bfloat16)
    for k, p in cast.items():
        want = torch.bfloat16 if p.dim() >= 2 else torch.float32
        assert p.dtype == want, k
    assert cast["block0.ln1.weight"] is tm.block0.ln1.weight


# --------------------------------------------------------------------------- #
# Regularizers
# --------------------------------------------------------------------------- #

REGULARIZERS = [("L1Regularizer", (0.01,)), ("L2Regularizer", (0.05,)),
                ("L1L2Regularizer", (0.01, 0.05))]


def _attach(jm, tm, name, args):
    """The same regularizers on both sides: ``block0.fc1`` (Linear) weight
    and bias, ``block1.ln2`` (LayerNorm) bias, and ``block0.attn`` weight
    and bias, whose ``qkv_weight``/``qkv_bias`` the key rule does not
    match."""
    for pkg, model in ((jreg, jm), (optim, tm)):
        cls = getattr(pkg, name)
        model.blocks[0].fc1.set_regularizer(w=cls(*args), b=cls(*args))
        model.blocks[1].ln2.set_regularizer(b=cls(*args))
        model.blocks[0].attn.set_regularizer(w=cls(*args), b=cls(*args))


@pytest.mark.parametrize("name,args", REGULARIZERS)
def test_regularization_loss_matches_jax(name, args):
    jm, tm = _pair()
    assert not optim.has_regularizers(tm)
    _attach(jm, tm, name, args)
    assert optim.has_regularizers(tm)
    want = float(jreg.regularization_loss(jm, jm.parameters()[0]))
    got = optim.regularization_loss(tm)
    assert got.dtype == torch.float32 and got.item() > 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    # only fc1's weight and bias and ln2's bias: attention's are not
    # matched by the key rule
    reg = getattr(optim, name)(*args)
    b0, b1 = tm.block0, tm.block1
    only = reg(b0.fc1.weight) + reg(b0.fc1.bias) + reg(b1.ln2.bias)
    np.testing.assert_allclose(got.item(), only.item(), rtol=1e-6)


@pytest.mark.parametrize("name,args", REGULARIZERS)
def test_regularized_step_reports_the_bare_loss(name, args):
    """The reported loss is the criterion's; the gradients carry the
    regularization term (against ``jax.grad`` of criterion + term)."""
    jm, tm = _pair()
    _attach(jm, tm, name, args)
    jc, tc = _crits()
    x, y = synthetic_corpus(2, SEQ, VOCAB, seed=7)
    want_loss, want_grads = _jax_value_and_grad(jm, jc, x, y, reg=True)
    _, plain_grads = _jax_value_and_grad(jm, jc, x, y)
    sgd = optim.SGD(learning_rate=0.0)
    step = optim.make_train_step(tm, tc, sgd)
    _, loss = step(sgd.init_state({}), torch.from_numpy(x),
                   torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k],
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    key = "block0.fc1.weight"
    assert np.abs(tm.block0.fc1.weight.grad.numpy()
                  - plain_grads[key]).max() > 1e-4


# --------------------------------------------------------------------------- #
# Freezing, grad_transform, names
# --------------------------------------------------------------------------- #

def _named(jm, tm):
    """The same names on both sides (auto-names count per process)."""
    for model in (jm, tm):
        for i, b in enumerate(model.blocks):
            b.set_name(f"blk{i}")
            b.fc2.set_name(f"blk{i}_fc2")
        model.ln_f.set_name("final_ln")


def test_frozen_param_mask_matches_jax():
    """``freeze(names)`` then ``unfreeze(names)`` on a descendant: the
    explicit unfreeze overrides the frozen ancestor; ``unfreeze()``
    clears every mark."""
    jm, tm = _pair()
    _named(jm, tm)
    assert not nn.has_frozen(tm)
    for model in (jm, tm):
        model.freeze(["blk0", "final_ln"]).unfreeze(["blk0_fc2"])
    assert nn.has_frozen(tm)
    want = _flat(jax_frozen_mask(jm, jm.parameters()[0]))
    got = nn.frozen_param_mask(tm)
    assert got == {k: bool(v) for k, v in want.items()}
    assert not got["block0.fc1.weight"] and got["block0.fc2.weight"]
    assert not got["ln_f.bias"] and got["block1.attn.qkv_weight"]
    tm.freeze()
    whole = nn.frozen_param_mask(tm)
    assert whole["block0.fc2.weight"] and not whole["wte"]   # fc2 pinned
    tm.unfreeze()
    assert not nn.has_frozen(tm) and all(nn.frozen_param_mask(tm).values())


def test_frozen_block_is_unchanged_by_an_adam_step():
    """A frozen block is bit-identical after an Adam step with weight
    decay (its gradient zeroed before clipping, its parameters restored
    after the update), and the other parameters match JAX's step."""
    jm, tm = _pair()
    _named(jm, tm)
    for model in (jm, tm):
        model.freeze(["blk1"])
    jc, tc = _crits()
    x, y = synthetic_corpus(2, SEQ, VOCAB, seed=8)
    before = _params_np(tm)
    kw = dict(learning_rate=1e-2, weight_decay=0.1, epsilon=1e-3)
    adam = optim.Adam(**kw)
    step = optim.make_train_step(tm, tc, adam, clip_norm=0.5)
    state, _ = step(adam.init_state(dict(tm.named_parameters())),
                    torch.from_numpy(x), torch.from_numpy(y))
    assert state["neval"] == 1
    jstep = jax.jit(jax_train_step(jm, jc, joptim.Adam(**kw), clip_norm=0.5))
    params = jm.parameters()[0]
    new_params, *_ = jstep(params, (), joptim.Adam().init_state(params),
                           jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(0))
    new_params = _flat(new_params)
    for k, p in tm.named_parameters():
        got = p.detach().numpy()
        if k.startswith("block1."):
            np.testing.assert_array_equal(got, before[k], err_msg=k)
        else:
            assert not np.array_equal(got, before[k]), k
        np.testing.assert_allclose(got, new_params[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_freeze_of_an_unknown_name_raises():
    _, tm = _pair()
    with pytest.raises(ValueError, match="no modules named"):
        tm.freeze(["no_such_module"])
    with pytest.raises(ValueError, match="no modules named"):
        tm.unfreeze(["no_such_module"])


def test_grad_transform_matches_jax():
    """A gradient scaling applied before clipping, against JAX's step with
    the same transform (SGD, clipped by value)."""
    jm, tm = _pair()
    jc, tc = _crits()
    x, y = synthetic_corpus(2, SEQ, VOCAB, seed=10)
    seen = []

    def scale(grads):
        seen.append(sorted(grads))
        return {k: 0.25 * g for k, g in grads.items()}

    sgd = optim.SGD(learning_rate=0.5)
    step = optim.make_train_step(tm, tc, sgd, clip_value=(-0.01, 0.01),
                                 grad_transform=scale)
    step(sgd.init_state({}), torch.from_numpy(x), torch.from_numpy(y))
    assert seen == [sorted(k for k, _ in tm.named_parameters())]
    jstep = jax.jit(jax_train_step(
        jm, jc, joptim.SGD(learning_rate=0.5), clip_value=(-0.01, 0.01),
        grad_transform=lambda g: jax.tree.map(lambda v: 0.25 * v, g)))
    params = jm.parameters()[0]
    new_params, *_ = jstep(params, (), joptim.SGD().init_state(params),
                           jnp.asarray(x), jnp.asarray(y),
                           jax.random.PRNGKey(0))
    new_params = _flat(new_params)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new_params[k],
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_optimizer_grad_transform_and_health_stats():
    """``set_grad_transform`` reaches the step; ``health_stats`` is the
    one option left unported."""
    _, tm = _pair()
    _, tc = _crits()
    x, y = synthetic_corpus(4, SEQ, VOCAB, seed=11)
    calls = []

    def count(grads):
        calls.append(len(grads))
        return grads

    opt = optim.Optimizer(tm, array_dataset(x, y) >> SampleToMiniBatch(2),
                          tc, optim.SGD(learning_rate=0.1), device="cpu")
    opt.set_end_when(optim.Trigger.max_iteration(2))
    opt.set_grad_transform(count).optimize()
    assert calls == [len(list(tm.parameters()))] * 2
    with pytest.raises(NotImplementedError, match="A8"):
        optim.make_train_step(tm, tc, optim.SGD(), health_stats=True)


def test_module_names_count_per_class_and_are_callable():
    a, b = nn.Linear(2, 3), nn.Linear(2, 3)
    assert a.name.startswith("Linear") and a.name != b.name
    assert int(b.name[len("Linear"):]) == int(a.name[len("Linear"):]) + 1
    assert a.name() == str(a.name)
    assert a.set_name("head") is a and a.name == "head" and a.name() == "head"
