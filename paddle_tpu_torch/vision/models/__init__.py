"""The vision model zoo (counterpart of paddle_tpu/vision/models): ResNet
first (BASELINE config 1's model), then LeNet, AlexNet, VGG, SqueezeNet,
MobileNet V1-V3, ShuffleNet V2, GoogLeNet, Inception v3 and DenseNet, with
the reference's module names. Every model takes ``device`` and
``generator`` (``_build.py``)."""
from .alexnet import AlexNet, alexnet  # noqa: F401
from .densenet import (DenseNet, densenet121, densenet161,  # noqa: F401
                       densenet169, densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet  # noqa: F401
from .inceptionv3 import InceptionV3, inception_v3  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mobilenet import (MobileNetV1, MobileNetV2,  # noqa: F401
                        MobileNetV3Large, MobileNetV3Small, mobilenet_v1,
                        mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small)
from .resnet import *  # noqa: F401,F403
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,  # noqa: F401
                           shufflenet_v2_x0_5, shufflenet_v2_x0_25,
                           shufflenet_v2_x0_33, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19  # noqa: F401
