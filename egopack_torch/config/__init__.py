from .instantiate import instantiate, locate
from .loader import ConfigNode, compose, default_config_dir, to_container

__all__ = ["ConfigNode", "compose", "default_config_dir", "instantiate",
           "locate", "to_container"]
