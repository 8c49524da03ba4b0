from .defaults import get_cfg
from .node import CfgNode

__all__ = ["CfgNode", "get_cfg"]
