from .config import get_args, parse_config

__all__ = ["get_args", "parse_config"]
