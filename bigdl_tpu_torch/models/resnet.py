"""ResNet (counterpart of ``bigdl_tpu/models/resnet.py``): the ImageNet
depths 18-152 and the CIFAR variant, NHWC end to end; each residual
block is ``CAddTable`` over a ``ConcatTable`` of the main path and the
shortcut, as in the JAX package, so the parameter and state keys are
JAX's."""

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.nn.containers import resolve_checkpoint_policy
from bigdl_tpu_torch.nn.initialization import MsraFiller


def _conv(n_in, n_out, k, g, stride=1, pad=0):
    return nn.SpatialConvolution(
        n_in, n_out, k, k, stride, stride, pad, pad, with_bias=False,
        data_format="NHWC", weight_init=MsraFiller(False), generator=g)


def _bn(n):
    return nn.SpatialBatchNormalization(n)


def _shortcut(n_in, n_out, stride, g):
    if n_in != n_out or stride != 1:
        return nn.Sequential().add(_conv(n_in, n_out, 1, g, stride)) \
            .add(_bn(n_out))
    return nn.Identity()


def basic_block(n_in, n_out, stride=1, generator=None):
    """3x3 + 3x3 residual block."""
    g = generator
    main = (nn.Sequential()
            .add(_conv(n_in, n_out, 3, g, stride, 1)).add(_bn(n_out))
            .add(nn.ReLU())
            .add(_conv(n_out, n_out, 3, g, 1, 1)).add(_bn(n_out)))
    return (nn.Sequential()
            .add(nn.ConcatTable().add(main)
                 .add(_shortcut(n_in, n_out, stride, g)))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


def bottleneck(n_in, planes, stride=1, expansion=4, generator=None):
    """1x1 -> 3x3 -> 1x1 block."""
    g = generator
    n_out = planes * expansion
    main = (nn.Sequential()
            .add(_conv(n_in, planes, 1, g)).add(_bn(planes)).add(nn.ReLU())
            .add(_conv(planes, planes, 3, g, stride, 1)).add(_bn(planes))
            .add(nn.ReLU())
            .add(_conv(planes, n_out, 1, g)).add(_bn(n_out)))
    return (nn.Sequential()
            .add(nn.ConcatTable().add(main)
                 .add(_shortcut(n_in, n_out, stride, g)))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


_IMAGENET_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def ResNet(depth=50, class_num=1000, remat=False, stem_s2d=False,
           remat_policy=None, *, device=None, seed=0):
    """ImageNet ResNet; input ``(N, 224, 224, 3)``.

    ``remat=True`` wraps every residual block in ``nn.Remat`` (its
    activations recomputed in backward; BatchNorm's statistics still
    update once a step); ``remat_policy`` names a policy for those
    wrappers and implies ``remat``; an unknown name fails here.
    ``stem_s2d=True`` computes the 7x7/s2 stem as ``nn.SpaceToDepthStem``
    (the same weights).  Weights drawn from ``seed`` on the CPU, then
    moved to ``device`` (None: the CUDA card)."""
    kind, layout = _IMAGENET_CFG[depth]
    resolve_checkpoint_policy(remat_policy)
    remat = remat or remat_policy is not None
    g = torch.Generator().manual_seed(int(seed))

    def wrap(m):
        return nn.Remat(m, policy=remat_policy) if remat else m

    if stem_s2d:
        stem = nn.SpaceToDepthStem(3, 64, 7, data_format="NHWC",
                                   weight_init=MsraFiller(False),
                                   generator=g)
    else:
        stem = nn.SpatialConvolution(
            3, 64, 7, 7, 2, 2, 3, 3, with_bias=False, data_format="NHWC",
            weight_init=MsraFiller(False), generator=g)
    model = (nn.Sequential()
             .add(stem)
             .add(_bn(64)).add(nn.ReLU())
             .add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1)))
    n_in = 64
    for stage, (p, count) in enumerate(zip([64, 128, 256, 512], layout)):
        for i in range(count):
            stride = 2 if (stage > 0 and i == 0) else 1
            if kind == "basic":
                model.add(wrap(basic_block(n_in, p, stride, generator=g)))
                n_in = p
            else:
                model.add(wrap(bottleneck(n_in, p, stride, generator=g)))
                n_in = p * 4
    model.add(nn.GlobalAveragePooling2D())
    model.add(nn.Linear(n_in, class_num, generator=g))
    return model.to(resolve_device(device))


def ResNetCifar(depth=20, class_num=10, *, device=None, seed=0):
    """CIFAR ResNet of 6n+2 layers; input ``(N, 32, 32, 3)``."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    g = torch.Generator().manual_seed(int(seed))
    model = (nn.Sequential()
             .add(_conv(3, 16, 3, g, 1, 1)).add(_bn(16)).add(nn.ReLU()))
    n_in = 16
    for stage, p in enumerate([16, 32, 64]):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            model.add(basic_block(n_in, p, stride, generator=g))
            n_in = p
    model.add(nn.GlobalAveragePooling2D())
    model.add(nn.Linear(64, class_num, generator=g))
    return model.to(resolve_device(device))
