from .resnet_ws import ResNetWS, build_ws_resnet_backbone

__all__ = ["ResNetWS", "build_ws_resnet_backbone"]
