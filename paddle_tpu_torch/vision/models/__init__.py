"""Vision models: port of ``paddle_tpu/vision/models/`` (the same file
names and exports).  Each model is a composition of the port's ``nn``
layers, built on ``meta`` and materialized once on ``device=`` (the
card unless ``"cpu"``) from ``seed=`` (``nn.common.built_on_meta``);
its parameter and buffer names are the reference's, so the weight
bridge (``models.convert.vision_state_from_jax``) pairs them by name.
"""

from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152, wide_resnet50_2,
                     wide_resnet101_2)
from .lenet import LeNet  # noqa: F401
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
from .mobilenetv1 import MobileNetV1, mobilenet_v1  # noqa: F401
from .mobilenetv2 import MobileNetV2, mobilenet_v2  # noqa: F401
from .mobilenetv3 import (MobileNetV3Small, MobileNetV3Large,  # noqa: F401
                          mobilenet_v3_small, mobilenet_v3_large)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa
from .densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                       densenet169, densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_x0_25,  # noqa: F401
                           shufflenet_v2_x0_33, shufflenet_v2_x0_5,
                           shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                           shufflenet_v2_x2_0, shufflenet_v2_swish)

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "wide_resnet50_2", "wide_resnet101_2", "LeNet",
    "AlexNet", "alexnet",
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
    "mobilenet_v3_large",
    "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264",
    "GoogLeNet", "googlenet",
    "InceptionV3", "inception_v3",
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]
