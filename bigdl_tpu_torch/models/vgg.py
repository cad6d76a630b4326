"""VGG-16/19 and the CIFAR-10 variant (counterpart of
``bigdl_tpu/models/vgg.py``), NHWC."""

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device

_CFG = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _features(cfg, batch_norm, g):
    seq = nn.Sequential()
    n_in = 3
    for v in cfg:
        if v == "M":
            seq.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            seq.add(nn.SpatialConvolution(n_in, v, 3, 3, 1, 1, 1, 1,
                                          data_format="NHWC", generator=g))
            if batch_norm:
                seq.add(nn.SpatialBatchNormalization(v))
            seq.add(nn.ReLU())
            n_in = v
    return seq


def _vgg(depth, class_num, batch_norm, device, seed):
    g = torch.Generator().manual_seed(int(seed))
    model = (
        _features(_CFG[depth], batch_norm, g)
        .add(nn.Reshape((512 * 7 * 7,)))
        .add(nn.Linear(512 * 7 * 7, 4096, generator=g)).add(nn.ReLU())
        .add(nn.Dropout(0.5))
        .add(nn.Linear(4096, 4096, generator=g)).add(nn.ReLU())
        .add(nn.Dropout(0.5))
        .add(nn.Linear(4096, class_num, generator=g))
    )
    return model.to(resolve_device(device))


def Vgg16(class_num=1000, batch_norm=False, *, device=None, seed=0):
    """Input ``(N, 224, 224, 3)``."""
    return _vgg(16, class_num, batch_norm, device, seed)


def Vgg19(class_num=1000, batch_norm=False, *, device=None, seed=0):
    return _vgg(19, class_num, batch_norm, device, seed)


def VggForCifar10(class_num=10, *, device=None, seed=0):
    """Input ``(N, 32, 32, 3)``: conv + BN stacks, then a 512-unit
    classifier."""
    g = torch.Generator().manual_seed(int(seed))
    seq = nn.Sequential()
    n_in = 3
    for v in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"]:
        if v == "M":
            seq.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            seq.add(nn.SpatialConvolution(n_in, v, 3, 3, 1, 1, 1, 1,
                                          data_format="NHWC", generator=g))
            seq.add(nn.SpatialBatchNormalization(v))
            seq.add(nn.ReLU())
            n_in = v
    model = (seq.add(nn.Reshape((512,)))
             .add(nn.Linear(512, 512, generator=g))
             .add(nn.BatchNormalization(512))
             .add(nn.ReLU()).add(nn.Dropout(0.5))
             .add(nn.Linear(512, class_num, generator=g))
             .add(nn.LogSoftMax()))
    return model.to(resolve_device(device))
