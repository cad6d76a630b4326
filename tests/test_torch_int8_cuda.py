"""K6, the int8 convolution kernel (``csrc/int8_conv.cu``), on the card
(``cuda`` marker: each test skips without a CUDA card).

- K6 against its plain version (``F.conv2d`` in float64 over the int8
  values, exact) on the same inputs, bit for bit, fp32 and bf16 out, with
  and without bias: ResNet-50's layer shapes (the 7 x 7 / 2 stem, 1 x 1,
  3 x 3, 3 x 3 / 2, the 1 x 1 / 2 shortcut) at batch 2, AlexNet's grouped
  5 x 5, a SAME 3 x 3 with dilation 2 (asymmetric pads), and channel
  counts off the vector paths (cin 6, cout 6 and 10).
- K6 inside a captured CUDA graph: the activation scale is a device
  tensor read by the kernel, so a replay on a new input (another scale)
  gives the plain version's result for that input.
- A CUDA tensor never reaches the plain version: a call counts one
  launch in ``LAUNCHES`` with the plain version made to raise.
- An int8 ``ResNetCifar(8)`` twin (``quantize_model``) through the
  compiled eval step against the same twin with the plain convolution,
  bit for bit, with one K6 launch per convolution a forward.

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


@pytest.mark.cuda
def test_int8_resnet_twin_through_the_compiled_eval_step(cuda, monkeypatch):
    model = tmodels.ResNetCifar(8, device=cuda, seed=0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8, 32, 32, 3), dtype=np.float32)).to(cuda)
    with torch.no_grad():
        model.train()(x)                 # non-trivial running statistics
    model.eval()
    twin, _ = tq.quantize_model(model)
    n_conv = sum(type(m) is nn.SpatialConvolution for m in twin.modules())
    step = optim.compiled_eval_step(twin)
    step(x)                              # builds the graph
    before = k6.LAUNCHES["int8_conv"]
    got = step(x).clone()
    torch.cuda.synchronize()
    assert k6.LAUNCHES["int8_conv"] - before == n_conv == 9
    monkeypatch.setattr(k6, "_on_cpu", lambda *ts: True)
    with torch.no_grad():
        want = twin(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max()
