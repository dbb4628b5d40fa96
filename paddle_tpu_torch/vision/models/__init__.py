"""Vision models. reference: paddle_tpu/vision/models/__init__.py: every
constructor and model class it exports (ResNet and its variants,
MobileNet V1-V3, VGG, DenseNet, AlexNet, SqueezeNet, ShuffleNetV2,
GoogLeNet, InceptionV3, LeNet)."""

from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .inception import GoogLeNet, InceptionV3, googlenet, inception_v3
from .lenet import LeNet
from .mobilenet import (MobileNetV1, MobileNetV2, MobileNetV3Large,
                        MobileNetV3Small, mobilenet_v1, mobilenet_v2,
                        mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     wide_resnet50_2, wide_resnet101_2)
from .small_nets import (AlexNet, ShuffleNetV2, SqueezeNet, alexnet,
                         shufflenet_v2_swish, shufflenet_v2_x0_5,
                         shufflenet_v2_x0_25, shufflenet_v2_x0_33,
                         shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                         shufflenet_v2_x2_0, squeezenet1_0, squeezenet1_1)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d", "resnext101_32x4d", "resnext50_64x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
           "wide_resnet50_2", "wide_resnet101_2", "VGG", "vgg11", "vgg13",
           "vgg16", "vgg19", "MobileNetV1", "MobileNetV2",
           "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v1",
           "mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large",
           "DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264", "AlexNet", "alexnet", "SqueezeNet",
           "squeezenet1_0", "squeezenet1_1", "ShuffleNetV2",
           "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish", "GoogLeNet",
           "googlenet", "InceptionV3", "inception_v3"]
