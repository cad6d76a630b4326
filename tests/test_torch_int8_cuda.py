"""K6, the int8 convolution kernels (``csrc/int8_conv.cu``), and K6q, the
activation quantization kernel (``csrc/act_quant.cu``), on the card
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
- An int8 ``ResNetCifar(8)`` twin (``quantize_model``) through the
  compiled eval step against the same twin with the plain convolution
  and the plain quantizer, bit for bit, with one K6 launch per
  convolution (the stem's on the gather kernel) and one K6q launch per
  quantized layer a forward; and the same replay with every plain
  version made to raise.

No JAX here, so the file runs on the card with ``--noconftest``:

    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_int8_cuda.py
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch import models as tmodels
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.ops import act_quant as k6q
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
    return dict(k6.LAUNCHES, **k6q.LAUNCHES)


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
    assert added == {"int8_conv": n_conv - 1, "int8_conv_gather": 1,
                     "act_quant": n_conv + n_linear}, added
    monkeypatch.setattr(k6, "_on_cpu", lambda *ts: True)
    monkeypatch.setattr(k6q, "act_quant", k6q.act_quant_reference)
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
                      (k6q, "act_quant_reference")):
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
        "int8_conv": 3 * 8, "int8_conv_gather": 3, "act_quant": 3 * 10}


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
