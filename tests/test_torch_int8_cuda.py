"""K6, the int8 convolution kernels (``csrc/int8_conv.cu``), K6q, the
activation quantization kernels (``csrc/act_quant.cu``), and K7, the
BatchNorm + residual + ReLU kernel (``csrc/bn_act.cu``), on the card
(``cuda`` marker: each test skips without a CUDA card).

- K6q against its plain version, bit for bit in ``x_q`` and ``x_scale``:
  every convolution-input shape of ResNet-50 at batch 128 and its head's
  input, fp32 and bf16, sizes off the 16-byte loads, misaligned views, an
  all-zero tensor, a NaN (the scale NaN in both); two replays of one CUDA
  graph on changed inputs (the scratch is zeroed inside the graph).
- K6 against its plain version (``F.conv2d`` in float64 over the int8
  values, exact) on the same inputs, bit for bit, fp32 and bf16 out, with
  and without bias: ResNet-50's layer shapes (the 7 x 7 / 2 stem, 1 x 1,
  3 x 3, 3 x 3 / 2, the 1 x 1 / 2 shortcut) at batch 2, AlexNet's grouped
  5 x 5, a SAME 3 x 3 with dilation 2 (asymmetric pads), and channel
  counts off the vector paths (cin 6, cout 6 and 10).
- Which K6 kernel each shape takes: the wgmma kernel where cin / groups
  is a multiple of 16, the gather kernel (the stem) elsewhere, each
  counted under its own key; a gather shape whose k table and static
  tiles pass the 48 KB a launch takes without opting in (cin 220).
- K6 inside a captured CUDA graph: the activation scale is a device
  tensor read by the kernel, so a replay on a new input (another scale)
  gives the plain version's result for that input.
- A CUDA tensor never reaches the plain version: a call counts one
  launch in ``LAUNCHES`` with the plain version made to raise.
- An int8 ``ResNetCifar(8)`` twin (``quantize_model``, its fused eval
  plan) through the compiled eval step against the same twin with every
  plain version (convolution, quantizer, K7), bit for bit, with one K6
  launch per convolution (the stem's on the gather kernel), one K7
  launch per plan site and one K6q launch per distinct quantized input
  (the given route after K7, the small route for the image and the
  head) a forward; the same replay with every plain version made to
  raise; the compiled twin against the unfused twin with plain versions;
  statistics loaded in place after the capture read by the next replay.
- K7 against its plain version, bit for bit (the bits, so a -0.0 or a
  NaN's payload counts): every (shape, form) of ResNet-50's BatchNorm
  sites at batch 8, bf16, channel counts off the vectors (3, 6, and 100
  for bf16), misaligned views (the scalar path), NaN and -0.0 through the
  ReLU, a BatchNorm without affine parameters; the absmax it hands off is
  the plain ``max |y|``.
- K6q by route, each bitwise its plain version: the given route on K7's
  output, the small route at the int8 TransformerLM's inputs and a head's
  (views off 16 bytes too), the three-node route, all inside one CUDA
  graph over replays on changed inputs.

No JAX here, so the file runs on the card with ``--noconftest``:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_int8_cuda.py
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch.nn import fused
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.ops import act_quant as k6q
from bigdl_tpu_torch.ops import bn_act as k7
from bigdl_tpu_torch.ops import int8_conv as k6
from bigdl_tpu_torch.utils.device import require_fp32_matmul


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    require_fp32_matmul()
    return torch.device("cuda")


#: (name, batch, side, cin, cout, k, stride, pads, dilation, groups)
SHAPES = [
    ("stem 7x7/2 3->64", 2, 224, 3, 64, 7, 2, ((3, 3), (3, 3)), 1, 1),
    ("1x1 256->64", 2, 56, 256, 64, 1, 1, ((0, 0), (0, 0)), 1, 1),
    ("3x3 64->64", 2, 56, 64, 64, 3, 1, ((1, 1), (1, 1)), 1, 1),
    ("3x3/2 256->256", 2, 28, 256, 256, 3, 2, ((1, 1), (1, 1)), 1, 1),
    ("1x1/2 512->1024", 2, 28, 512, 1024, 1, 2, ((0, 0), (0, 0)), 1, 1),
    ("alexnet 5x5 96->256 g2", 2, 27, 96, 256, 5, 1, ((2, 2), (2, 2)), 1, 2),
    ("SAME 3x3 d2", 2, 15, 32, 48, 3, 2, ((1, 2), (1, 2)), 2, 1),
    ("cin 6 cout 6", 3, 11, 6, 6, 5, 1, ((0, 0), (0, 0)), 1, 1),
    ("cout 10 g2", 2, 9, 32, 10, 3, 1, ((1, 1), (1, 1)), 1, 2),
]


def _inputs(case, device, seed):
    _, n, side, cin, cout, k, _, _, _, groups = case
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal((n, side, side, cin),
                                           dtype=np.float32)).to(device)
    w_q = torch.from_numpy(g.integers(-127, 128, (k, k, cin // groups, cout),
                                      dtype=np.int8)).to(device)
    scale = torch.from_numpy(
        g.uniform(1e-3, 2e-2, cout).astype(np.float32)).to(device)
    bias = torch.from_numpy(
        g.standard_normal(cout).astype(np.float32)).to(device)
    return x, w_q, scale, bias


@pytest.mark.cuda
def test_k6_matches_its_plain_version_bitwise(cuda):
    for i, case in enumerate(SHAPES):
        name, _, _, _, _, _, stride, pads, dil, groups = case
        x, w_q, scale, bias = _inputs(case, cuda, i)
        x_q, x_scale = tq._quantize_activation(x)
        for b, out_dtype in ((bias, torch.float32), (None, torch.float32),
                             (bias, torch.bfloat16)):
            args = (x_q, w_q, scale, x_scale, b, (stride, stride), pads,
                    (dil, dil), groups, out_dtype)
            got = k6.int8_conv_nhwc(*args)
            want = k6.int8_conv_nhwc_reference(*args)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype, name
            assert torch.equal(got, want), (
                name, out_dtype, (got.float() - want.float()).abs().max())


@pytest.mark.cuda
def test_k6_in_a_cuda_graph_reads_the_activation_scale_on_the_device(cuda):
    case = SHAPES[2]
    x, w_q, scale, bias = _inputs(case, cuda, 11)
    conv = dict(stride=(1, 1), padding=((1, 1), (1, 1)), dilation=(1, 1),
                groups=1, bias=bias)
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tq.int8_conv(static_x, w_q, scale, **conv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_y = tq.int8_conv(static_x, w_q, scale, **conv)
    for seed, gain in ((12, 3.0), (13, 0.25)):
        new = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            tuple(x.shape), dtype=np.float32)).to(cuda) * gain
        static_x.copy_(new)
        graph.replay()
        x_q, x_scale = tq._quantize_activation(new)
        want = k6.int8_conv_nhwc_reference(
            x_q, w_q, scale, x_scale, bias, (1, 1), ((1, 1), (1, 1)))
        torch.cuda.synchronize()
        assert torch.equal(static_y, want), seed


@pytest.mark.cuda
def test_a_cuda_tensor_never_reaches_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(k6, "int8_conv_nhwc_reference", refuse)
    monkeypatch.setattr(k6, "int8_conv_acc_reference", refuse)
    x, w_q, scale, bias = _inputs(SHAPES[1], cuda, 3)
    before = k6.LAUNCHES["int8_conv"]
    y = tq.int8_conv(x, w_q, scale, stride=(1, 1), padding="SAME",
                     dilation=(1, 1), groups=1, bias=bias)
    torch.cuda.synchronize()
    assert k6.LAUNCHES["int8_conv"] == before + 1
    assert y.shape == (2, 56, 56, 64) and torch.isfinite(y).all()
    x_q, x_scale = tq._quantize_activation(x)
    with pytest.raises(TypeError):
        k6.int8_conv_nhwc(x_q, w_q, scale, x_scale, out_dtype=torch.float16)


def _twin(cuda):
    model = tmodels.ResNetCifar(8, device=cuda, seed=0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 32, 32, 3), dtype=np.float32)).to(cuda)
    with torch.no_grad():
        model.train()(x)                 # non-trivial running statistics
    model.eval()
    twin, _ = tq.quantize_model(model)
    return twin, x


def _launches():
    return dict(k6.LAUNCHES, **k6q.LAUNCHES, **k7.LAUNCHES)


#: a ResNetCifar(8) twin's launches a forward: 9 convolutions (the stem's
#: on the gather kernel), 7 K7 sites (the stem, a BatchNorm + ReLU and a
#: tail a block), and 8 quantizations: 6 of K7 outputs (a downsampling
#: block's two convolutions share one), the image and the head small
TWIN_LAUNCHES = {"int8_conv": 8, "int8_conv_gather": 1, "act_quant": 0,
                 "act_quant_given": 6, "act_quant_small": 2, "bn_act": 7}


def _every_plain_version(monkeypatch):
    monkeypatch.setattr(k6, "_on_cpu", lambda *ts: True)
    monkeypatch.setattr(k6q, "act_quant", k6q.act_quant_reference)
    monkeypatch.setattr(k7, "_on_cpu", lambda *ts: True)


@pytest.mark.cuda
def test_int8_resnet_twin_through_the_compiled_eval_step(cuda, monkeypatch):
    twin, x = _twin(cuda)
    n_conv = sum(type(m) is nn.SpatialConvolution for m in twin.modules())
    n_linear = sum(type(m) is nn.Linear for m in twin.modules())
    step = optim.compiled_eval_step(twin)
    step(x)                              # builds the graph
    before = _launches()
    got = step(x).clone()
    torch.cuda.synchronize()
    after = _launches()
    added = {k: after[k] - before[k] for k in after}
    assert n_conv == 9 and n_linear == 1
    assert fused.site_counts(twin) == {"fused_sites": 7, "unfused_sites": 0}
    assert added == TWIN_LAUNCHES, added
    _every_plain_version(monkeypatch)
    with torch.no_grad():
        want = twin(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.cuda
def test_int8_twin_replay_never_reaches_a_plain_version(cuda, monkeypatch):
    twin, x = _twin(cuda)
    step = optim.compiled_eval_step(twin)
    want = step(x).clone()               # builds the graph

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((k6, "int8_conv_nhwc_reference"),
                      (k6, "int8_conv_acc_reference"),
                      (k6q, "act_quant_reference"),
                      (k6q, "act_quant_given_reference"),
                      (k7, "bn_act_reference")):
        monkeypatch.setattr(mod, name, refuse)
    before = _launches()
    got = step(x * 0.5).clone()
    again = step(x).clone()
    with torch.no_grad():
        eager = twin(x)                  # eager: the kernels, no graph
    torch.cuda.synchronize()
    after = _launches()
    assert torch.equal(again, want) and torch.equal(eager, want)
    assert not torch.equal(got, want)
    assert {k: after[k] - before[k] for k in after} == {
        k: 3 * n for k, n in TWIN_LAUNCHES.items()}


@pytest.mark.cuda
def test_the_fused_twin_is_bitwise_the_plain_and_the_unfused_twin(
        cuda, monkeypatch):
    twin, x = _twin(cuda)
    got = optim.compiled_eval_step(twin)(x).clone()
    with torch.no_grad():
        with fused.unfused():
            unfused_kernels = twin(x)    # K6 and K6q, no K7
        _every_plain_version(monkeypatch)
        plain = twin(x)
        with fused.unfused():
            unfused_plain = twin(x)
    torch.cuda.synchronize()
    assert torch.equal(got, plain), (got - plain).abs().max()
    assert torch.equal(got, unfused_plain), (got - unfused_plain).abs().max()
    assert torch.equal(got, unfused_kernels)


@pytest.mark.cuda
def test_a_compiled_fused_twin_reads_statistics_loaded_after_capture(
        cuda, monkeypatch):
    twin, x = _twin(cuda)
    step = optim.compiled_eval_step(twin)
    before = step(x).clone()             # builds the graph
    g = np.random.default_rng(8)
    state = {k: v.cpu().numpy() for k, v in
             dict(twin.named_buffers()).items()}
    for k in state:
        state[k] = (state[k] * g.uniform(0.5, 1.5, state[k].shape)).astype(
            np.float32)
    twin.load_state_tree(_nest(state))
    after = step(x).clone()
    _every_plain_version(monkeypatch)
    with torch.no_grad():
        want = twin(x)
    torch.cuda.synchronize()
    assert step.executables() == 1
    assert not torch.equal(after, before)
    assert torch.equal(after, want), (after - want).abs().max()


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = v
    return tree


def _resnet50_inputs(cuda, batch=128):
    """The distinct input shapes of ResNet-50's convolutions, and its
    head's, at ``batch``."""
    model = tmodels.ResNet(50, 1000, device=cuda, seed=0).eval()
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: shapes.append(tuple(inp[0].shape[1:])))
        for m in model.modules()
        if type(m) in (nn.SpatialConvolution, nn.Linear)]
    with torch.no_grad():
        model(torch.zeros((1, 224, 224, 3), device=cuda))
    for h in hooks:
        h.remove()
    return [(batch,) + s for s in dict.fromkeys(shapes)]


def _k6q_equal(x, note):
    got_q, got_s = k6q.act_quant(x)
    want_q, want_s = k6q.act_quant_reference(x)
    torch.cuda.synchronize()
    assert got_q.shape == x.shape and got_q.dtype == torch.int8, note
    assert got_s.shape == () and got_s.dtype == torch.float32, note
    assert torch.equal(got_s, want_s), (note, got_s, want_s)
    assert torch.equal(got_q, want_q), (
        note, (got_q.int() - want_q.int()).abs().max())


@pytest.mark.cuda
def test_k6q_matches_its_plain_version_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = _resnet50_inputs(cuda)
    assert len(shapes) == 13             # 12 convolution inputs, the head
    for i, shape in enumerate(shapes):
        x = torch.randn(shape, generator=g, device=cuda) * (1 + i)
        _k6q_equal(x, shape)
        if i % 4 == 0:
            _k6q_equal(x.to(torch.bfloat16), ("bf16", shape))
        del x
    torch.cuda.empty_cache()
    for n in (1, 3, 7, 17, 1000003):     # off the 16-byte loads
        x = torch.randn(n, generator=g, device=cuda)
        _k6q_equal(x, n)
        _k6q_equal(x.to(torch.bfloat16), ("bf16", n))
    flat = torch.randn(4 * 4099 + 3, generator=g, device=cuda)
    for off in (1, 2, 3):                # views off 16-byte alignment
        _k6q_equal(flat[off:off + 4 * 4099].view(4, 4099), ("view", off))
        _k6q_equal(flat.to(torch.bfloat16)[off:off + 4096], ("bf16 view",
                                                             off))
    # exact half-way quotients: x = (k + 0.5) * scale for a power-of-two
    # scale (absmax 127 * 2^-4), so round-half-even decides
    halves = (torch.arange(-127, 127, device=cuda) + 0.5) / 16
    _k6q_equal(torch.cat([halves, halves.new_full((1,), 127 / 16)]),
               "ties")
    zeros = torch.zeros((8, 5, 5, 16), device=cuda)
    _k6q_equal(zeros, "zeros")
    assert k6q.act_quant(zeros)[1].item() == np.float32(1e-8) / np.float32(
        127)
    nan = torch.randn((2, 9, 9, 16), generator=g, device=cuda)
    nan[1, 3, 4, 5] = float("nan")
    q, s = k6q.act_quant(nan)
    want_q, want_s = k6q.act_quant_reference(nan)
    torch.cuda.synchronize()
    assert torch.isnan(s) and torch.isnan(want_s)
    assert torch.equal(q, want_q)


@pytest.mark.cuda
def test_k6q_graph_replays_zero_the_scratch(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    static_x = torch.randn((4, 28, 28, 128), generator=g, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k6q.act_quant(static_x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_q, static_s = k6q.act_quant(static_x)
    for gain in (3.0, 0.25, 1.0):        # a smaller max after a larger one
        new = torch.randn(static_x.shape, generator=g, device=cuda) * gain
        static_x.copy_(new)
        graph.replay()
        want_q, want_s = k6q.act_quant_reference(new)
        torch.cuda.synchronize()
        assert torch.equal(static_s, want_s), gain
        assert torch.equal(static_q, want_q), gain


@pytest.mark.cuda
def test_k6_shapes_take_their_kernels(cuda):
    for i, case in enumerate(SHAPES):
        name, _, _, cin, _, _, stride, pads, dil, groups = case
        x, w_q, scale, bias = _inputs(case, cuda, 20 + i)
        x_q, x_scale = tq._quantize_activation(x)
        key = "int8_conv" if (cin // groups) % 16 == 0 else \
            "int8_conv_gather"
        packed = k6.pack_weight(w_q, groups)
        before = dict(k6.LAUNCHES)
        got = k6.int8_conv_nhwc(x_q, w_q, scale, x_scale, bias,
                                (stride, stride), pads, (dil, dil), groups,
                                w_packed=packed if key == "int8_conv"
                                else None)
        want = k6.int8_conv_nhwc_reference(x_q, w_q, scale, x_scale, bias,
                                           (stride, stride), pads,
                                           (dil, dil), groups)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        assert {k: k6.LAUNCHES[k] - before[k] for k in before} == {
            "int8_conv": key == "int8_conv",
            "int8_conv_gather": key == "int8_conv_gather"}, name
    assert sum((c[3] // c[9]) % 16 == 0 for c in SHAPES) == 7


@pytest.mark.cuda
def test_k6_gather_with_a_k_table_past_the_default_shared_memory(cuda):
    """A gather shape whose k table (16 bytes a k of the padded K, 31,744
    here) and the kernel's 18 KB of static tiles pass the 48 KB a launch
    takes without the opt-in, grouped and not."""
    for i, case in enumerate([
            ("3x3 220->64", 2, 9, 220, 64, 3, 1, ((1, 1), (1, 1)), 1, 1),
            ("3x3 440->64 g2", 2, 7, 440, 64, 3, 1, ((1, 1), (1, 1)), 1,
             2)]):
        name, _, _, cin, _, k, stride, pads, dil, groups = case
        assert not k6.uses_wgmma(cin // groups)
        assert -(-k * k * cin // groups // 32) * 32 * 16 + 18432 > 48 * 1024
        x, w_q, scale, bias = _inputs(case, cuda, 40 + i)
        x_q, x_scale = tq._quantize_activation(x)
        args = (x_q, w_q, scale, x_scale, bias, (stride, stride), pads,
                (dil, dil), groups)
        before = k6.LAUNCHES["int8_conv_gather"]
        got = k6.int8_conv_nhwc(*args)
        want = k6.int8_conv_nhwc_reference(*args)
        torch.cuda.synchronize()
        assert k6.LAUNCHES["int8_conv_gather"] == before + 1, name
        assert torch.equal(got, want), name


# --------------------------------------------------------------------------- #
# K7 and K6q's routes
# --------------------------------------------------------------------------- #

def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bn(c, seed, device, affine=True, eps=1e-5):
    g = np.random.default_rng(seed)
    bn = nn.SpatialBatchNormalization(c, eps=eps, affine=affine)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(
            g.standard_normal(c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            g.uniform(0.05, 3.0, c).astype(np.float32)))
        if affine:
            bn.weight.copy_(torch.from_numpy(
                g.uniform(-2, 2, c).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(
                g.standard_normal(c).astype(np.float32)))
    return bn.to(device).eval()


def _k7_equal(x, bn, residual=None, residual_bn=None, relu=True, note=""):
    before = k7.LAUNCHES["bn_act"]
    y = k7.bn_act(x, bn, residual, residual_bn, relu, absmax=True)
    want = k7.bn_act_reference(x, bn, residual, residual_bn, relu)
    absmax = k6q.handed_off_absmax(y)
    torch.cuda.synchronize()
    assert k7.LAUNCHES["bn_act"] == before + 1, note
    assert y.shape == want.shape and y.dtype == want.dtype, note
    # the bits, a NaN's payload aside
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(y), nan), note
    assert torch.equal(_bits(y)[~nan], _bits(want)[~nan]), (
        note, (y.float() - want.float()).abs().max())
    want_max = want.float().abs().amax().reshape(1)
    if nan.any():
        assert torch.isnan(absmax.view(torch.float32)).all(), note
    else:
        assert torch.equal(absmax, want_max.view(torch.int32)), (
            note, absmax.view(torch.float32), want_max)
    return y


def _resnet50_bn_sites(cuda):
    """The distinct (activation shape without the batch, form) of the
    fused ResNet-50 twin's K7 sites, form 1 BN + ReLU, 2 BN + add + ReLU,
    3 BN + BN(shortcut) + add + ReLU."""
    twin, _ = tq.quantize_model(tmodels.ResNet(50, 1000, device=cuda,
                                               seed=0).eval())
    sites, real = [], k7.bn_act

    def spy(x, bn, residual=None, residual_bn=None, relu=True, **kw):
        form = 1 if residual is None else 2 if residual_bn is None else 3
        sites.append((tuple(x.shape[1:]), form))
        return real(x, bn, residual, residual_bn, relu, **kw)

    k7.bn_act = spy
    try:
        with torch.no_grad():
            twin(torch.zeros((1, 224, 224, 3), device=cuda))
    finally:
        k7.bn_act = real
    return list(dict.fromkeys(sites))


@pytest.mark.cuda
def test_k7_matches_its_plain_version_bitwise(cuda):
    sites = _resnet50_bn_sites(cuda)
    assert len(sites) == 16 and {f for _, f in sites} == {1, 2, 3}
    g = torch.Generator(device=cuda).manual_seed(2)
    for i, (shape, form) in enumerate(sites):
        c = shape[-1]
        x = torch.randn((8,) + shape, generator=g, device=cuda) * 3
        r = torch.randn(x.shape, generator=g, device=cuda) if form > 1 \
            else None
        rbn = _bn(c, 100 + i, cuda) if form == 3 else None
        bn = _bn(c, i, cuda)
        _k7_equal(x, bn, r, rbn, note=(shape, form))
        if i % 5 == 0:
            _k7_equal(x.to(torch.bfloat16), bn,
                      None if r is None else r.to(torch.bfloat16), rbn,
                      note=("bf16", shape, form))
        del x, r
    torch.cuda.empty_cache()
    # channel counts off the vectors; bf16 at 100 (a multiple of 4, not 8)
    for c in (3, 6, 100):
        x = torch.randn((4, 9, 9, c), generator=g, device=cuda)
        r = torch.randn(x.shape, generator=g, device=cuda)
        bn, rbn = _bn(c, c, cuda), _bn(c, c + 1, cuda)
        for dt in (torch.float32, torch.bfloat16):
            _k7_equal(x.to(dt), bn, note=("C", c, dt))
            _k7_equal(x.to(dt), bn, r.to(dt), rbn, note=("C", c, dt, 3))
            _k7_equal(x.to(dt), bn, r.to(dt), relu=False,
                      note=("C", c, dt, "no relu"))
    # views off 16-byte alignment: the scalar path
    flat = torch.randn(4 * 7 * 7 * 64 + 4, generator=g, device=cuda)
    rflat = torch.randn(flat.shape, generator=g, device=cuda)
    bn, rbn = _bn(64, 7, cuda), _bn(64, 8, cuda, affine=False, eps=1e-3)
    for off in (1, 2, 3):
        x = flat[off:off + 4 * 7 * 7 * 64].view(4, 7, 7, 64)
        r = rflat[off:off + 4 * 7 * 7 * 64].view(4, 7, 7, 64)
        _k7_equal(x, bn, r, rbn, note=("view", off))
        _k7_equal(x.to(torch.bfloat16), bn, note=("bf16 view", off))
    # NaN through the ReLU, and -0.0: mean 0 and bias -0.0 give t = -0.0,
    # so x = -0.0 reaches the ReLU as -0.0
    bn = _bn(16, 9, cuda)
    with torch.no_grad():
        bn.running_mean.zero_()
        bn.bias.fill_(-0.0)
    x = torch.randn((2, 5, 5, 16), generator=g, device=cuda)
    x[0, 1, 2, 3] = float("nan")
    x[1, 2, 3] = -0.0
    for dt in (torch.float32, torch.bfloat16):
        y = _k7_equal(x.to(dt), bn, note=("nan", dt))
        assert torch.isnan(y[0, 1, 2, 3])
        _k7_equal(x.to(dt), bn, relu=False, note=("nan no relu", dt))
    _k7_equal(x, _bn(16, 10, cuda, affine=False), note="no affine")


def _route_equal(x, route, absmax=None, note=""):
    before = k6q.LAUNCHES[route]
    got = k6q.quantize_route(x, route, absmax)
    want = k6q.act_quant_reference(x)
    torch.cuda.synchronize()
    assert k6q.LAUNCHES[route] == before + 1, note
    assert torch.equal(got[1], want[1]), (note, got[1], want[1])
    assert torch.equal(got[0], want[0]), (
        note, (got[0].int() - want[0].int()).abs().max())


#: the int8 TransformerLM twin's quantized inputs ("small": 768 wide, MLP
#: 3072): decode over 8 slots and prefill chunks of 1-8 x 64 rows, and a
#: ResNet-50 head's
SMALL_SHAPES = [(8, 1, 768), (8, 1, 3072), (1, 64, 768), (1, 64, 3072),
                (8, 64, 768), (8, 64, 3072), (128, 2048)]


@pytest.mark.cuda
def test_k6q_routes_match_the_plain_version_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    for shape in SMALL_SHAPES:
        x = torch.randn(shape, generator=g, device=cuda) * 5
        _route_equal(x, "act_quant_small", note=shape)
        _route_equal(x.to(torch.bfloat16), "act_quant_small",
                     note=("bf16", shape))
        _route_equal(x, "act_quant", note=("three", shape))
    for n in (1, 3, 4097, 65539):        # off the vectors, up to 8 blocks
        x = torch.randn(n, generator=g, device=cuda)
        _route_equal(x, "act_quant_small", note=n)
    flat = torch.randn(8 * 768 + 3, generator=g, device=cuda)
    for off in (1, 2, 3):
        _route_equal(flat[off:off + 8 * 768].view(8, 768),
                     "act_quant_small", note=("view", off))
    nan = torch.randn((8, 768), generator=g, device=cuda)
    nan[3, 5] = float("nan")
    got = k6q.quantize_route(nan, "act_quant_small")
    want = k6q.act_quant_reference(nan)
    torch.cuda.synchronize()
    assert torch.isnan(got[1]) and torch.equal(got[0], want[0])
    # the given route on K7's output: selected, one launch
    bn = _bn(256, 4, cuda)
    x = torch.randn((8, 14, 14, 256), generator=g, device=cuda)
    for dt in (torch.float32, torch.bfloat16):
        y = k7.bn_act(x.to(dt), bn, absmax=True)
        route, absmax = k6q.select_route(y)
        assert route == "act_quant_given"
        _route_equal(y, route, absmax, note=("given", dt))
    assert k6q.select_route(y[1:])[0] != "act_quant_given"


@pytest.mark.cuda
def test_k6q_routes_in_a_cuda_graph_over_replays(cuda):
    """K7 (its scratch zeroed inside the graph), the given route after it,
    the small and the three-node routes, captured once and replayed on
    inputs whose absmax falls and rises."""
    g = torch.Generator(device=cuda).manual_seed(4)
    bn = _bn(128, 5, cuda)
    static_x = torch.randn((4, 28, 28, 128), generator=g, device=cuda)
    static_s = torch.randn((8, 3072), generator=g, device=cuda)
    static_b = torch.randn((64, 56, 56, 16), generator=g, device=cuda)

    def run():
        y = k7.bn_act(static_x, bn, absmax=True)
        return (y, k6q.act_quant(y), k6q.act_quant(static_s),
                k6q.act_quant(static_b))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(k6q.LAUNCHES)
    with torch.cuda.graph(graph):
        y, given, small, three = run()
    assert {k: k6q.LAUNCHES[k] - before[k] for k in before} == {
        "act_quant": 1, "act_quant_given": 1, "act_quant_small": 1}
    for gain in (3.0, 0.25, 1.0):
        for t in (static_x, static_s, static_b):
            t.copy_(torch.randn(t.shape, generator=g, device=cuda) * gain)
        graph.replay()
        want_y = k7.bn_act_reference(static_x, bn)
        torch.cuda.synchronize()
        assert torch.equal(y, want_y), gain
        for got, src in ((given, want_y), (small, static_s),
                         (three, static_b)):
            want = k6q.act_quant_reference(src)
            assert torch.equal(got[1], want[1]), gain
            assert torch.equal(got[0], want[0]), gain
