"""Cross-cutting utilities: config, logging, registries, device choice."""

from .config import deep_merge, load_config, parse_env_value, save_config
from .device import resolve_device
from .logging import Timer, get_logger, log_array_info, setup_logging
from .registry import Registry

__all__ = [
    "Registry",
    "Timer",
    "deep_merge",
    "get_logger",
    "load_config",
    "log_array_info",
    "parse_env_value",
    "resolve_device",
    "save_config",
    "setup_logging",
]
