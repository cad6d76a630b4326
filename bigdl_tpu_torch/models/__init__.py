"""Model families of the PyTorch port."""

from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNetOWT
from bigdl_tpu_torch.models.inception import (InceptionV1,
                                              InceptionV1NoAuxClassifier,
                                              InceptionV2)
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import ResNet, ResNetCifar
from bigdl_tpu_torch.models.transformer import (CONFIGS, synthetic_corpus,
                                                transformer_lm)
from bigdl_tpu_torch.models.vgg import Vgg16, Vgg19, VggForCifar10

__all__ = ["AlexNet", "AlexNetOWT", "CONFIGS", "InceptionV1",
           "InceptionV1NoAuxClassifier", "InceptionV2", "LeNet5", "ResNet",
           "ResNetCifar", "Vgg16", "Vgg19", "VggForCifar10",
           "synthetic_corpus", "transformer_lm"]
