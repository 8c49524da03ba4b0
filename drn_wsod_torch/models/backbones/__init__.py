from .fpn import FPN, build_resnet_fpn_backbone
from .resnet_ws import (ResNetPlain, ResNetWS, build_resnet_backbone,
                        build_ws_resnet_backbone)
from .vgg import VGG16, build_vgg_backbone

__all__ = ["FPN", "ResNetPlain", "ResNetWS", "VGG16",
           "build_resnet_backbone", "build_resnet_fpn_backbone",
           "build_vgg_backbone", "build_ws_resnet_backbone"]
