"""Inception v1 (GoogLeNet) and v2 (BN-Inception) (counterpart of
``bigdl_tpu/models/inception.py``), NHWC: the towers join on the channel
axis (``Concat(3)``)."""

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device


def _conv(n_in, n_out, k, g, stride=1, pad=0, name=None):
    return (nn.Sequential(name=name)
            .add(nn.SpatialConvolution(n_in, n_out, k, k, stride, stride,
                                       pad, pad, data_format="NHWC",
                                       generator=g))
            .add(nn.ReLU()))


def inception_module(n_in, c1, c3r, c3, c5r, c5, pool_proj, generator=None):
    """One v1 block: 1x1, 3x3, 5x5 and pool towers."""
    g = generator
    concat = nn.Concat(3)
    concat.add(_conv(n_in, c1, 1, g))
    concat.add(nn.Sequential().add(_conv(n_in, c3r, 1, g))
               .add(_conv(c3r, c3, 3, g, 1, 1)))
    concat.add(nn.Sequential().add(_conv(n_in, c5r, 1, g))
               .add(_conv(c5r, c5, 5, g, 1, 2)))
    concat.add(nn.Sequential()
               .add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1))
               .add(_conv(n_in, pool_proj, 1, g)))
    return concat


def _conv_bn(n_in, n_out, k, g, stride=1, pad=0):
    """conv + BN (eps 1e-3) + ReLU."""
    return (nn.Sequential()
            .add(nn.SpatialConvolution(n_in, n_out, k, k, stride, stride,
                                       pad, pad, data_format="NHWC",
                                       generator=g))
            .add(nn.SpatialBatchNormalization(n_out, 1e-3))
            .add(nn.ReLU()))


def inception_layer_v2(n_in, c1, c3, c3xx, pool_spec, generator=None):
    """One BN-Inception block: an optional 1x1 tower (``c1=0`` drops it),
    3x3, double 3x3 and a pool tower (``("avg"|"max", proj)``; a max pool
    with ``proj=0`` is the stride-2 pass-through)."""
    g = generator
    pool_kind, pool_proj = pool_spec
    downsample = pool_kind == "max" and pool_proj == 0
    concat = nn.Concat(3)
    if c1 != 0:
        concat.add(_conv_bn(n_in, c1, 1, g))
    c3r, c3o = c3
    tower3 = nn.Sequential().add(_conv_bn(n_in, c3r, 1, g))
    tower3.add(_conv_bn(c3r, c3o, 3, g, 2 if downsample else 1, 1))
    concat.add(tower3)
    cxr, cxo = c3xx
    towerx = (nn.Sequential()
              .add(_conv_bn(n_in, cxr, 1, g))
              .add(_conv_bn(cxr, cxo, 3, g, 1, 1))
              .add(_conv_bn(cxo, cxo, 3, g, 2 if downsample else 1, 1)))
    concat.add(towerx)
    pool = nn.Sequential()
    if pool_kind == "max":
        if pool_proj != 0:
            pool.add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
        else:
            pool.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    else:
        pool.add(nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1).ceil())
    if pool_proj != 0:
        pool.add(_conv_bn(n_in, pool_proj, 1, g))
    concat.add(pool)
    return concat


def InceptionV2(class_num=1000, *, device=None, seed=0):
    """BN-Inception, input ``(N, 224, 224, 3)``."""
    g = torch.Generator().manual_seed(int(seed))
    v2 = inception_layer_v2
    model = (
        nn.Sequential()
        .add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3,
                                   data_format="NHWC", name="conv1/7x7_s2",
                                   generator=g))
        .add(nn.SpatialBatchNormalization(64, 1e-3))
        .add(nn.ReLU())
        .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        .add(_conv_bn(64, 64, 1, g))
        .add(_conv_bn(64, 192, 3, g, 1, 1))
        .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        .add(v2(192, 64, (64, 64), (64, 96), ("avg", 32), g))
        .add(v2(256, 64, (64, 96), (64, 96), ("avg", 64), g))
        .add(v2(320, 0, (128, 160), (64, 96), ("max", 0), g))
        .add(v2(576, 224, (64, 96), (96, 128), ("avg", 128), g))
        .add(v2(576, 192, (96, 128), (96, 128), ("avg", 128), g))
        .add(v2(576, 160, (128, 160), (128, 160), ("avg", 96), g))
        .add(v2(576, 96, (128, 192), (160, 192), ("avg", 96), g))
        .add(v2(576, 0, (128, 192), (192, 256), ("max", 0), g))
        .add(v2(1024, 352, (192, 320), (160, 224), ("avg", 128), g))
        .add(v2(1024, 352, (192, 320), (192, 224), ("max", 128), g))
        .add(nn.GlobalAveragePooling2D())
        .add(nn.Linear(1024, class_num, name="loss3/classifier",
                       generator=g))
        .add(nn.LogSoftMax())
    )
    return model.to(resolve_device(device))


def _v1_feature1(g):
    """The stem through inception_4a."""
    return (
        nn.Sequential()
        .add(nn.SpatialConvolution(3, 64, 7, 7, 2, 2, 3, 3,
                                   data_format="NHWC", generator=g))
        .add(nn.ReLU())
        .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
        .add(_conv(64, 64, 1, g))
        .add(_conv(64, 192, 3, g, 1, 1))
        .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
        .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        .add(inception_module(192, 64, 96, 128, 16, 32, 32, g))
        .add(inception_module(256, 128, 128, 192, 32, 96, 64, g))
        .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        .add(inception_module(480, 192, 96, 208, 16, 48, 64, g)))


def _v1_feature2(g):
    """inception_4b..4d."""
    return (
        nn.Sequential()
        .add(inception_module(512, 160, 112, 224, 24, 64, 64, g))
        .add(inception_module(512, 128, 128, 256, 24, 64, 64, g))
        .add(inception_module(512, 112, 144, 288, 32, 64, 64, g)))


def _v1_tail(g):
    """inception_4e..5b and the global pool."""
    return (
        nn.Sequential()
        .add(inception_module(528, 256, 160, 320, 32, 128, 128, g))
        .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
        .add(inception_module(832, 256, 160, 320, 32, 128, 128, g))
        .add(inception_module(832, 384, 192, 384, 48, 128, 128, g))
        .add(nn.GlobalAveragePooling2D()))


def InceptionV1NoAuxClassifier(class_num=1000, has_dropout=True, *,
                               device=None, seed=0):
    """Input ``(N, 224, 224, 3)``."""
    g = torch.Generator().manual_seed(int(seed))
    model = nn.Sequential().add(_v1_feature1(g)).add(_v1_feature2(g)) \
        .add(_v1_tail(g))
    if has_dropout:
        model.add(nn.Dropout(0.4))
    model.add(nn.Linear(1024, class_num, generator=g)).add(nn.LogSoftMax())
    return model.to(resolve_device(device))


def InceptionV1(class_num=1000, has_dropout=True, *, device=None, seed=0):
    """GoogLeNet with the two auxiliary heads: the three log-softmax
    outputs joined on the class axis, ``(N, 3 * class_num)``, ordered
    [main, aux2, aux1] as in the JAX package."""
    g = torch.Generator().manual_seed(int(seed))

    def aux_head(n_in, name):
        head = (nn.Sequential(name=name)
                .add(nn.SpatialAveragePooling(5, 5, 3, 3).ceil())
                .add(_conv(n_in, 128, 1, g))
                .add(nn.Flatten())
                .add(nn.Linear(128 * 4 * 4, 1024, generator=g))
                .add(nn.ReLU()))
        if has_dropout:
            head.add(nn.Dropout(0.7))
        return head.add(nn.Linear(1024, class_num, generator=g)) \
            .add(nn.LogSoftMax())

    feature1 = _v1_feature1(g)
    feature2 = _v1_feature2(g)
    output3 = _v1_tail(g)
    if has_dropout:
        output3.add(nn.Dropout(0.4))
    output3.add(nn.Linear(1024, class_num, generator=g)).add(nn.LogSoftMax())
    split2 = nn.Concat(1).add(output3).add(aux_head(528, "loss2"))
    main_branch = nn.Sequential().add(feature2).add(split2)
    split1 = nn.Concat(1).add(main_branch).add(aux_head(512, "loss1"))
    return nn.Sequential().add(feature1).add(split1).to(
        resolve_device(device))
