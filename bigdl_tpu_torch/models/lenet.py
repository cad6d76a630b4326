"""LeNet-5 (counterpart of ``bigdl_tpu/models/lenet.py``), NHWC; input
``(N, 28, 28)`` or ``(N, 28, 28, 1)``.  ``LeNet5Graph`` waits for the
graph API (``nn/graph.py``, ROADMAP A9)."""

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def LeNet5(class_num: int = 10, *, device=None, seed: int = 0):
    """Weights drawn from ``seed`` on the CPU, then moved to ``device``
    (None: the CUDA card)."""
    g = torch.Generator().manual_seed(int(seed))
    model = (
        nn.Sequential()
        .add(nn.Reshape((28, 28, 1)))
        .add(nn.SpatialConvolution(1, 6, 5, 5, name="conv1_5x5",
                                   generator=g))
        .add(nn.Tanh())
        .add(nn.SpatialMaxPooling(2, 2, 2, 2))
        .add(nn.SpatialConvolution(6, 12, 5, 5, name="conv2_5x5",
                                   generator=g))
        .add(nn.Tanh())
        .add(nn.SpatialMaxPooling(2, 2, 2, 2))
        .add(nn.Reshape((12 * 4 * 4,)))
        .add(nn.Linear(12 * 4 * 4, 100, name="fc1", generator=g))
        .add(nn.Tanh())
        .add(nn.Linear(100, class_num, name="fc2", generator=g))
        .add(nn.LogSoftMax())
    )
    return model.to(resolve_device(device))
