"""AlexNet (counterpart of ``bigdl_tpu/models/alexnet.py``), NHWC:
``AlexNet`` (LRN, grouped conv2/4/5) and ``AlexNetOWT`` (neither)."""

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def _flatten_classifier(model, class_num, has_dropout, g):
    model.add(nn.Flatten())
    model.add(nn.Linear(256 * 6 * 6, 4096, name="fc6", generator=g))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, 4096, name="fc7", generator=g))
    model.add(nn.ReLU())
    if has_dropout:
        model.add(nn.Dropout(0.5))
    model.add(nn.Linear(4096, class_num, name="fc8", generator=g))
    model.add(nn.LogSoftMax())
    return model


def AlexNet(class_num=1000, has_dropout=True, *, device=None, seed=0):
    """The original AlexNet, input ``(N, 227, 227, 3)``."""
    g = torch.Generator().manual_seed(int(seed))
    conv = nn.SpatialConvolution
    model = (
        nn.Sequential()
        .add(conv(3, 96, 11, 11, 4, 4, 0, 0, name="conv1", generator=g))
        .add(nn.ReLU())
        .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
        .add(nn.SpatialMaxPooling(3, 3, 2, 2))
        .add(conv(96, 256, 5, 5, 1, 1, 2, 2, n_group=2, name="conv2",
                  generator=g))
        .add(nn.ReLU())
        .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
        .add(nn.SpatialMaxPooling(3, 3, 2, 2))
        .add(conv(256, 384, 3, 3, 1, 1, 1, 1, name="conv3", generator=g))
        .add(nn.ReLU())
        .add(conv(384, 384, 3, 3, 1, 1, 1, 1, n_group=2, name="conv4",
                  generator=g))
        .add(nn.ReLU())
        .add(conv(384, 256, 3, 3, 1, 1, 1, 1, n_group=2, name="conv5",
                  generator=g))
        .add(nn.ReLU())
        .add(nn.SpatialMaxPooling(3, 3, 2, 2))
    )
    return _flatten_classifier(model, class_num, has_dropout, g).to(
        resolve_device(device))


def AlexNetOWT(class_num=1000, has_dropout=True, *, device=None, seed=0):
    """"One weird trick" AlexNet, input ``(N, 224, 224, 3)``."""
    g = torch.Generator().manual_seed(int(seed))
    conv = nn.SpatialConvolution
    model = (
        nn.Sequential()
        .add(conv(3, 64, 11, 11, 4, 4, 2, 2, name="conv1", generator=g))
        .add(nn.ReLU())
        .add(nn.SpatialMaxPooling(3, 3, 2, 2))
        .add(conv(64, 192, 5, 5, 1, 1, 2, 2, name="conv2", generator=g))
        .add(nn.ReLU())
        .add(nn.SpatialMaxPooling(3, 3, 2, 2))
        .add(conv(192, 384, 3, 3, 1, 1, 1, 1, name="conv3", generator=g))
        .add(nn.ReLU())
        .add(conv(384, 256, 3, 3, 1, 1, 1, 1, name="conv4", generator=g))
        .add(nn.ReLU())
        .add(conv(256, 256, 3, 3, 1, 1, 1, 1, name="conv5", generator=g))
        .add(nn.ReLU())
        .add(nn.SpatialMaxPooling(3, 3, 2, 2))
    )
    return _flatten_classifier(model, class_num, has_dropout, g).to(
        resolve_device(device))
