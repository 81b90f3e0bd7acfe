from .lbfgsb import LbfgsbConfig

__all__ = ["LbfgsbConfig"]
